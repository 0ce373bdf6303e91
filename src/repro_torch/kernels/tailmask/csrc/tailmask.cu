// y = silu(x) * 2 with a ragged tail, two idioms in one template, for
// Hopper (sm_90a), CUDA C++ with a plain C interface (loaded with ctypes by
// kernels/tailmask/kernel.py).
//
// Replaces the TPU kernels `_plain_kernel` (src/repro/kernels/tailmask/
// kernel.py:33, launched twice by `exact_tail`, pallas_call at :55 and
// :65) and `_masked_kernel` (:37, `masked_full`, pallas_call at :80): the
// paper's Fig 3 idioms.
//  - exact_tail (the vsetvl analogue): one launch over the whole tiles of
//    block_rows rows, unmasked, and a second launch of one block sized
//    exactly to the remainder rows.
//  - masked_full (the predication analogue): the input is padded to whole
//    tiles; every tile computes full width and a select writes 0 at every
//    flat index >= n_valid.
// One block per tile; each thread moves 16-byte vectors when the tile is
// a whole number of them (cols % 4 == 0), else single floats.
//
// What bounds it: device memory.  8 bytes and ~6 operations per element
// (exp, add, divide, multiply), below the card's ~20 FLOP/byte fp32
// balance.  The masked idiom moves every padded element, so its cost
// over the exact idiom should be the padded share, 1 - active fraction, in
// bytes (PERF.md, PR 13).
// silu is x / (1 + expf(-x)) with IEEE division, as PyTorch's CUDA silu
// computes it in float, then times 2 (exact): within 1e-6 of F.silu(x) * 2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float f(float x) {
  return __fmul_rn(__fdiv_rn(x, __fadd_rn(1.0f, expf(-x))), 2.0f);
}

template <bool MASKED>
__device__ __forceinline__ float g(float x, long long idx,
                                   long long n_valid) {
  const float y = f(x);
  return MASKED ? (idx < n_valid ? y : 0.0f) : y;
}

// T is float4 (vectors of 4) or float; tile: elements a block owns
template <bool MASKED, typename T>
__global__ void __launch_bounds__(kThreads)
    tail_kernel(const T* __restrict__ x, T* __restrict__ out, long long tile,
                long long n_valid) {
  constexpr int W = sizeof(T) / sizeof(float);
  const long long base = static_cast<long long>(blockIdx.x) * (tile / W);
  for (long long v = threadIdx.x; v < tile / W; v += kThreads) {
    const long long e = (base + v) * W;       // flat index of the first float
    const T a = __ldg(x + base + v);
    T y;
    if constexpr (W == 4) {
      y = make_float4(g<MASKED>(a.x, e, n_valid), g<MASKED>(a.y, e + 1, n_valid),
                      g<MASKED>(a.z, e + 2, n_valid),
                      g<MASKED>(a.w, e + 3, n_valid));
    } else {
      y = g<MASKED>(a, e, n_valid);
    }
    out[base + v] = y;
  }
}

template <bool MASKED>
void launch(const float* x, float* out, long long tiles, long long tile,
            long long n_valid, bool vec, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(tiles);
  if (vec)
    tail_kernel<MASKED, float4><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
        tile, n_valid);
  else
    tail_kernel<MASKED, float><<<grid, kThreads, 0, s>>>(x, out, tile,
                                                         n_valid);
}

}  // namespace

extern "C" {

// One launch of `tiles` blocks of `tile` contiguous elements each, from x
// to out.  masked: 0 computes every element, 1 writes 0 at flat indices
// (counted from x) >= n_valid.  vec: 1 if tile % 4 == 0 and both pointers
// are 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError().
int tailmask_launch(const void* x, void* out, long long tiles, long long tile,
                    long long n_valid, int masked, int vec, void* stream) {
  if (tiles < 0 || tile <= 0 || (vec && tile % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (masked)
    launch<true>(xf, of, tiles, tile, n_valid, vec != 0, s);
  else
    launch<false>(xf, of, tiles, tile, n_valid, vec != 0, s);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// STREAM copy / scale / add / triad for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by kernels/stream/kernel.py).
//
// Replaces the TPU kernels `_copy_kernel`, `_scale_kernel`, `_add_kernel`
// and `_triad_kernel` (src/repro/kernels/stream/kernel.py:18-30), which
// share the launch site `_call` (:34, pallas_call at :48): one template
// here, the kind a template argument.  Same function over a contiguous
// fp32 array of n elements (the JAX package views it as (rows, 128)):
//   copy o = x;  scale o = a*x;  add o = x + y;  triad o = x + a*y.
//
// What bounds it: device memory.  Triad moves 12 bytes per element and
// does 2 operations, far below the card's ~20 FLOP/byte fp32 balance; at
// n = 2^26 (three 256 MiB arrays, over 15x the 50 MB L2) the bound is
// 805 MB / 3.35 TB/s = 0.240 ms on an H100 SXM.  Design:
//  - each thread moves VPT 16-byte vectors per array (block_multiplier,
//    the TPU's LMUL axis, sets VPT in {1, 2, 4, 8}); all its loads are
//    issued before any store, so VPT vectors are in flight per thread;
//  - neighbouring threads touch neighbouring vectors (coalesced 512 B per
//    warp per vector), loads go through the read-only path;
//  - the n % 4 elements past the last whole vector are a masked scalar
//    tail, done by the thread that owns the first partial vector;
//  - arithmetic uses __fmul_rn / __fadd_rn so nothing is contracted into
//    an FMA: the result is bitwise the plain two-op PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int KIND>
__device__ __forceinline__ float apply(float x, float y, float alpha) {
  if (KIND == 0) return x;
  if (KIND == 1) return __fmul_rn(alpha, x);
  if (KIND == 2) return __fadd_rn(x, y);
  return __fadd_rn(x, __fmul_rn(alpha, y));
}

template <int KIND>
__device__ __forceinline__ float4 apply4(float4 x, float4 y, float alpha) {
  return make_float4(apply<KIND>(x.x, y.x, alpha), apply<KIND>(x.y, y.y, alpha),
                     apply<KIND>(x.z, y.z, alpha), apply<KIND>(x.w, y.w, alpha));
}

template <int KIND, int VPT>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ o, long long n, float alpha) {
  constexpr bool kUsesY = KIND >= 2;
  const long long nvec = n / 4;
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * VPT + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(o);
  float4 xv[VPT], yv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long long v = base + static_cast<long long>(j) * kThreads;
    xv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    yv[j] = xv[j];
    if (v < nvec) {
      xv[j] = __ldg(x4 + v);
      if (kUsesY) yv[j] = __ldg(y4 + v);
    }
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long long v = base + static_cast<long long>(j) * kThreads;
    if (v < nvec) {
      o4[v] = apply4<KIND>(xv[j], yv[j], alpha);
    } else if (v == nvec) {
      for (long long e = nvec * 4; e < n; ++e) {
        o[e] = apply<KIND>(x[e], kUsesY ? y[e] : 0.f, alpha);
      }
    }
  }
}

template <int KIND>
void launch_kind(const float* x, const float* y, float* o, long long n,
                 float alpha, int vpt, cudaStream_t s) {
  const long long slots = (n + 3) / 4;   // whole vectors + the partial one
  const long long per_block = static_cast<long long>(kThreads) * vpt;
  const unsigned grid = static_cast<unsigned>((slots + per_block - 1) /
                                              per_block);
  switch (vpt) {
    case 1: stream_kernel<KIND, 1><<<grid, kThreads, 0, s>>>(x, y, o, n, alpha); break;
    case 2: stream_kernel<KIND, 2><<<grid, kThreads, 0, s>>>(x, y, o, n, alpha); break;
    case 4: stream_kernel<KIND, 4><<<grid, kThreads, 0, s>>>(x, y, o, n, alpha); break;
    case 8: stream_kernel<KIND, 8><<<grid, kThreads, 0, s>>>(x, y, o, n, alpha); break;
  }
}

}  // namespace

extern "C" {

// kind: 0 copy, 1 scale, 2 add, 3 triad; vpt in {1, 2, 4, 8}; x, y and
// out 16-byte aligned (y unused by copy and scale).  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int stream_launch(const void* x, const void* y, void* out, long long n,
                  int kind, int vpt, float alpha, void* stream) {
  if (n <= 0) return 0;
  if (kind < 0 || kind > 3 || (vpt != 1 && vpt != 2 && vpt != 4 && vpt != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  switch (kind) {
    case 0: launch_kind<0>(xf, yf, of, n, alpha, vpt, s); break;
    case 1: launch_kind<1>(xf, yf, of, n, alpha, vpt, s); break;
    case 2: launch_kind<2>(xf, yf, of, n, alpha, vpt, s); break;
    case 3: launch_kind<3>(xf, yf, of, n, alpha, vpt, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Single-qubit 2x2 complex gate on a planar state vector, for Hopper
// (sm_90a), CUDA C++ with a plain C interface (loaded with ctypes by
// kernels/qsim_gate/kernel.py).
//
// Replaces the TPU kernel `_gate_kernel` (src/repro/kernels/qsim_gate/
// kernel.py:26, pallas_call at :62).  Same function: the state is two fp32
// planes re, im of 2^n amplitudes; for a gate [[a, b], [c, d]] on qubit q,
// view each plane as (outer, 2, 2^q) and, for every pair (amp0, amp1) =
// ([o, 0, j], [o, 1, j]):
//   new0 = a*amp0 + b*amp1,  new1 = c*amp0 + d*amp1   (complex).
// Out of place, as the TPU kernel is: the inputs stay valid.
//
// What bounds it: device memory.  Each amplitude is read once from each
// plane and written once to each (16 bytes) for 14 operations, far below
// the card's ~20 FLOP/byte fp32 balance; at n = 28 one gate moves 4 GiB,
// 1.28 ms at 3.35 TB/s on an H100 SXM.  Design:
//  - one thread per amplitude pair k in [0, 2^(n-1)):
//      i0 = ((k >> q) << (q+1)) | (k & (2^q - 1)),  i1 = i0 + 2^q,
//    so neighbouring threads touch neighbouring amplitudes of each half
//    once 2^q >= 32 (a warp reads 128 contiguous bytes at i0 and at i1).
//    For q < 5 both halves of a pair share 128-byte lines; the kernel stays
//    the same (measuring it per qubit is later work);
//  - the gate's 8 floats arrive by value as kernel arguments: no copy to
//    the device per gate (the TPU wrapper builds a (2, 4) array there);
//  - the arithmetic is __fmul_rn / __fadd_rn / __fsub_rn in the order of
//    the plain version, so nothing is contracted into an FMA and the
//    result is bitwise the plain PyTorch version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Gate {
  float ar, ai, br, bi, cr, ci, dr, di;
};

// x_re * y_re - x_im * y_im + z_re * w_re - z_im * w_im, left to right
__device__ __forceinline__ float re4(float p, float q, float r, float s,
                                     float a0r, float a0i, float a1r,
                                     float a1i) {
  return __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(p, a0r), __fmul_rn(q, a0i)),
                             __fmul_rn(r, a1r)),
                   __fmul_rn(s, a1i));
}

__device__ __forceinline__ float im4(float p, float q, float r, float s,
                                     float a0r, float a0i, float a1r,
                                     float a1i) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p, a0i), __fmul_rn(q, a0r)),
                             __fmul_rn(r, a1i)),
                   __fmul_rn(s, a1r));
}

__global__ void __launch_bounds__(kThreads)
    gate_kernel(const float* __restrict__ re, const float* __restrict__ im,
                float* __restrict__ ore, float* __restrict__ oim,
                long long pairs, int q, Gate g) {
  const long long k =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= pairs) return;
  const long long lo = k & ((1LL << q) - 1);
  const long long i0 = ((k >> q) << (q + 1)) | lo;
  const long long i1 = i0 + (1LL << q);
  const float a0r = __ldg(re + i0), a1r = __ldg(re + i1);
  const float a0i = __ldg(im + i0), a1i = __ldg(im + i1);
  ore[i0] = re4(g.ar, g.ai, g.br, g.bi, a0r, a0i, a1r, a1i);
  oim[i0] = im4(g.ar, g.ai, g.br, g.bi, a0r, a0i, a1r, a1i);
  ore[i1] = re4(g.cr, g.ci, g.dr, g.di, a0r, a0i, a1r, a1i);
  oim[i1] = im4(g.cr, g.ci, g.dr, g.di, a0r, a0i, a1r, a1i);
}

}  // namespace

extern "C" {

// re, im, out_re, out_im: n_amps fp32 each (n_amps a power of two >= 2);
// qubit in [0, log2(n_amps)); gate row-major [[a, b], [c, d]] as
// (re, im) pairs.  Launches on `stream` and returns cudaGetLastError().
int qsim_gate_launch(const void* re, const void* im, void* out_re,
                     void* out_im, long long n_amps, int qubit, float ar,
                     float ai, float br, float bi, float cr, float ci,
                     float dr, float di, void* stream) {
  if (n_amps < 2 || (n_amps & (n_amps - 1)) || qubit < 0 ||
      (2LL << qubit) > n_amps)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = n_amps / 2;
  const unsigned grid =
      static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  const Gate g{ar, ai, br, bi, cr, ci, dr, di};
  gate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im), pairs, qubit,
      g);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

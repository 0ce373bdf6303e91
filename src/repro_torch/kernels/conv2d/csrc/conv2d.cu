// Direct NHWC stride-1 SAME convolution for Hopper (sm_90a), fp32, CUDA C++
// with a plain C interface (loaded with ctypes by kernels/conv2d/kernel.py).
//
// Replaces the TPU kernel `_conv_kernel` (src/repro/kernels/conv2d/
// kernel.py:21, pallas_call at :46).  Same function: x (N, H, W, Cin),
// w (kh, kw, Cin, Cout) -> out (N, H, W, Cout), zero padding of
// (kh // 2, kh - 1 - kh // 2) rows and (kw // 2, kw - 1 - kw // 2) columns
// (the JAX kernel's: for even k it pads one more before than after), fp32
// accumulation, block_h output rows per block.  The TPU kernel keeps a
// haloed row block in VMEM and runs kh*kw shifted matmuls on the MXU; this
// one keeps a haloed tile in shared memory and runs the same sum of
// shifted products on the CUDA cores.  No im2col buffer.
//
// What bounds it: operations.  The veceval AlexNet stack at 224 x 224
// (16 -> 32 -> 64 -> 64 channels, 3 x 3) is 6.0 GFLOP against ~55 MB of
// activations: 0.090 ms at the 67 TFLOP/s fp32 rate of an H100 SXM, well
// above its 0.016 ms of memory time.  Design:
//  - a block owns block_h rows x 32 columns x 32 output channels of one
//    image and walks its rows 8 at a time; per 8-row chunk it walks Cin
//    in slices of 16;
//  - per slice it stages the input halo (8 + kh - 1) x (32 + kw - 1) x 16
//    (pixel stride padded to 17 floats: no bank conflicts) and the weights
//    kh x kw x 16 x 32 in shared memory; out-of-image pixels and channels
//    past Cin or Cout are staged as zeros, so the ragged edges need no
//    branch in the inner loop;
//  - 256 threads = 32 columns x 8 groups of 4 output channels; a thread
//    holds 8 rows x 4 channels of fp32 sums in registers, and per tap and
//    input channel reads 4 weights as one 16-byte load and 8 inputs (each
//    a broadcast across the 8 channel groups) for 32 FMAs.
// Known limits, later work: CUDA cores, not tensor cores (TF32 would give
// up exact fp32); Cout below 32 (YOLO's 8-channel 1 x 1) idles lanes; the
// halo rows are reloaded by each 8-row chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 32;    // output columns per block
constexpr int kCO = 32;    // output channels per block
constexpr int kRB = 8;     // output rows per chunk
constexpr int kCI = 16;    // input channels per staged slice
constexpr int kCIP = kCI + 1;

__host__ __device__ inline size_t smem_floats(int kh, int kw) {
  return static_cast<size_t>(kh) * kw * kCI * kCO +
         static_cast<size_t>(kRB + kh - 1) * (kTW + kw - 1) * kCIP;
}

__global__ void __launch_bounds__(kThreads)
    conv2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int H, int W, int Cin, int Cout,
                  int kh, int kw, int bh) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);          // [kh*kw][kCI][kCO]
  float* In = Ws + static_cast<size_t>(kh) * kw * kCI * kCO;
  const int twp = kTW + kw - 1;                          // halo tile width
  const int ph = kh / 2, pw = kw / 2;

  const int n_wt = (W + kTW - 1) / kTW;
  const int col0 = (blockIdx.x % n_wt) * kTW;
  const int co0 = (blockIdx.x / n_wt) * kCO;
  const int img = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % 8;                                // channel group
  const int pl = tid / 8;                                // tile column
  const float* xi = x + static_cast<size_t>(img) * H * W * Cin;

  for (int r0 = blockIdx.y * bh; r0 < (blockIdx.y + 1) * bh; r0 += kRB) {
    float acc[kRB][4];
#pragma unroll
    for (int r = 0; r < kRB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int ci0 = 0; ci0 < Cin; ci0 += kCI) {
      const int n_in = (kRB + kh - 1) * twp * kCI;
      for (int e = tid; e < n_in; e += kThreads) {
        const int ci = e % kCI, p = e / kCI;
        const int c = p % twp, r = p / twp;
        const int gr = r0 + r - ph, gc = col0 + c - pw, gci = ci0 + ci;
        float v = 0.f;
        if (gr >= 0 && gr < H && gc >= 0 && gc < W && gci < Cin)
          v = __ldg(xi + (static_cast<size_t>(gr) * W + gc) * Cin + gci);
        In[p * kCIP + ci] = v;
      }
      const int n_w = kh * kw * kCI * kCO;
      for (int e = tid; e < n_w; e += kThreads) {
        const int co = e % kCO, t = e / kCO;
        const int ci = t % kCI, tap = t / kCI;
        const int gci = ci0 + ci, gco = co0 + co;
        float v = 0.f;
        if (gci < Cin && gco < Cout)
          v = __ldg(w + (static_cast<size_t>(tap) * Cin + gci) * Cout + gco);
        Ws[e] = v;
      }
      __syncthreads();
      for (int dy = 0; dy < kh; ++dy) {
        for (int dx = 0; dx < kw; ++dx) {
          const float* in_tap = In + ((dy * twp) + pl + dx) * kCIP;
          const float4* w_tap = reinterpret_cast<const float4*>(
              Ws + (dy * kw + dx) * kCI * kCO) + cg;
#pragma unroll 4
          for (int ci = 0; ci < kCI; ++ci) {
            const float4 wv = w_tap[ci * (kCO / 4)];
#pragma unroll
            for (int r = 0; r < kRB; ++r) {
              const float xv = in_tap[r * twp * kCIP + ci];
              acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
              acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
              acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
              acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
            }
          }
        }
      }
      __syncthreads();
    }

    const int col = col0 + pl;
    if (col < W) {
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int row = r0 + r;
        if (row >= (blockIdx.y + 1) * bh || row >= H) break;
        float* o = out + ((static_cast<size_t>(img) * H + row) * W + col) * Cout;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int co = co0 + cg * 4 + c;
          if (co < Cout) o[co] = acc[r][c];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a kh x kw filter, in bytes.
long long conv2d_smem_bytes(int kh, int kw) {
  return static_cast<long long>(smem_floats(kh, kw) * sizeof(float));
}

// x (N, H, W, Cin), w (kh, kw, Cin, Cout), out (N, H, W, Cout): contiguous
// fp32; bh output rows per block with H % bh == 0.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int conv2d_launch(const void* x, const void* w, void* out, int N, int H,
                  int W, int Cin, int Cout, int kh, int kw, int bh,
                  void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (bh <= 0 || H % bh || kh <= 0 || kw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(kh, kw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_wt = (W + kTW - 1) / kTW, n_ct = (Cout + kCO - 1) / kCO;
  const dim3 grid(n_wt * n_ct, H / bh, N);
  conv2d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), H, W, Cin, Cout, kh, kw, bh);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

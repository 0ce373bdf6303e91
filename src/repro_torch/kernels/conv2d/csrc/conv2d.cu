// Direct NHWC stride-1 SAME convolution for Hopper (sm_90a), fp32, CUDA C++
// with a plain C interface (loaded with ctypes by kernels/conv2d/kernel.py).
//
// Replaces the TPU kernel `_conv_kernel` (src/repro/kernels/conv2d/
// kernel.py:21, pallas_call at :46).  Same function: x (N, H, W, Cin),
// w (kh, kw, Cin, Cout) -> out (N, H, W, Cout), zero padding of
// (kh // 2, kh - 1 - kh // 2) rows and (kw // 2, kw - 1 - kw // 2) columns
// (the JAX kernel's: for even k it pads one more before than after), fp32
// accumulation.  The TPU kernel keeps a haloed row block in VMEM and runs
// kh*kw shifted matmuls on the MXU; this one is the same sum as an
// implicit GEMM on the CUDA cores: M = a block's output pixels, N = Cout,
// K = kh * kw * Cin, with no im2col buffer.
//
// What bounds it: operations.  224 x 224, 64 -> 64, 3 x 3 is 3.7 GFLOP
// against 25.7 MB of activations: 0.055 ms at the 67 TFLOP/s fp32 rate of
// an H100 SXM, well above its 0.008 ms of memory time.  Design:
//  - a block owns 4 rows x 32 columns of output pixels of one image and
//    BN (64, 32, 16 or 8) output channels; a thread owns an 8 x
//    TC register tile: 8 consecutive pixels of one row x TC (8, 4 or 2)
//    channels (channels 4 cg + 4 CG j + c for TC >= 4, 2 cg + c for TC 2,
//    cg the thread's channel group of CG: 8, or 4 at BN 8).  Narrow Cout
//    takes narrow thread tiles, so that a 4-row block keeps 4 warps (2 at
//    BN 8): the grid has few blocks an SM, and the warps hide the loads'
//    latency.
//    kernel.py's `plan` picks BN from Cout and the template's filter width
//    KWMAX (1, 3 or 5) from kw; square 1 x 1, 3 x 3 and 5 x 5 filters have
//    templates of their own, with every tap a compile-time constant.
//    (8-row blocks measured slower at every layer of the CNN apps on an
//    H100: half the blocks, under 1.5 waves at 224 x 224.)  Wider filters
//    take KWMAX = 0: any width, each tap's 8 inputs read as scalars;
//  - K runs in stages of 8 input channels.  A stage holds the haloed input
//    tile, (4 + kh - 1) x (32 + KWMAX - 1) pixels channel-major (row pitch
//    36 floats, channel pitch = 4 mod 32: no bank conflicts), staged once
//    for all kh x kw taps, and the weights [ci][tap][BN]; it comes in by
//    cp.async (the input transposed on the way by 4-byte copies, the
//    weights in 16-byte chunks where Cout is a multiple of 4), two stages
//    deep, the next one in flight while one is multiplied.  Out-of-image
//    pixels and channels past Cin or Cout are zero-filled, so the ragged
//    edges need no branch in the inner loop;
//  - per input channel and filter row a thread reads the 8 + kw - 1 input
//    values its pixels need as 2 or 3 float4 (one window, shifted in
//    registers for every tap dx: the shift is a compile-time index), and
//    per tap its TC weights as float4 (float2 at TC 2): kw = 3, TC = 8 is
//    9 shared loads for 192 FMAs;
//  - fp32 FMAs throughout: TF32 on the tensor cores would give up the 1e-4
//    parity with the plain version.
// Any filter that fits in shared memory (up to 7 x 7 at BN 64).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;         // output columns a block
constexpr int kTH = 4;          // output rows a block
constexpr int kCI = 8;          // input channels a stage
constexpr int kTWP = 36;        // row pitch of the staged halo, in floats
constexpr int kStages = 2;      // cp.async ring depth
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

// floats a staged halo row: kTWP under the width templates, the halo
// itself past them
__host__ __device__ constexpr int row_pitch(int kw) {
  return kw <= 5 ? kTWP : kTW + kw - 1;
}
// floats between two input channels of a stage: >= the halo, = 4 mod 32
__host__ __device__ constexpr int chan_stride(int kh, int kw) {
  return (kTH + kh - 1) * row_pitch(kw) +
         ((4 - (kTH + kh - 1) * row_pitch(kw)) % 32 + 32) % 32;
}
__host__ __device__ constexpr int stage_floats(int kh, int kw, int bn) {
  return kCI * chan_stride(kh, kw) + kCI * kh * kw * bn;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `kBytes` (4 or 16) global -> shared; src_bytes 0 zero-fills, reads nothing
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the thread's channel j within the block's BN
template <int TC, int CG>
__device__ __forceinline__ int chan(int cg, int j) {
  if constexpr (TC >= 4)
    return (j / 4) * 4 * CG + 4 * cg + j % 4;
  else
    return TC * cg + j;
}

// the thread's TC weights of one tap (w_t: the tap's BN)
template <int TC, int CG>
__device__ __forceinline__ void load_weights(const float* w_t, int cg,
                                             float (&b)[TC]) {
  if constexpr (TC >= 4) {
#pragma unroll
    for (int g = 0; g < TC / 4; ++g)
      *reinterpret_cast<float4*>(b + 4 * g) =
          *reinterpret_cast<const float4*>(w_t + chan<TC, CG>(cg, 4 * g));
  } else {
    *reinterpret_cast<float2*>(b) =
        *reinterpret_cast<const float2*>(w_t + chan<TC, CG>(cg, 0));
  }
}

// KS > 0: a KS x KS filter (KWMAX = KS), its taps compile-time constants;
// KS = 0: kh x kw given at run time, kw <= KWMAX (any kw at KWMAX = 0)
template <int TC, int CG, int KWMAX, int KS>
__global__ void __launch_bounds__(kMaxThreads, 2)
    conv2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int H, int W, int Cin, int Cout,
                  int kh_in, int kw_in, int vec) {
  static_assert(KS == 0 || KS == KWMAX, "a square template is its width");
  const int kh = KS > 0 ? KS : kh_in;
  const int kw = KS > 0 ? KS : kw_in;
  constexpr int BN = TC * CG;
  const int pitch = KWMAX > 0 ? kTWP : row_pitch(kw);
  const int twh = kTW + (KWMAX > 0 ? KWMAX : kw) - 1;  // staged halo columns
  constexpr int WIN = KWMAX == 1 ? 8 : 12;      // a thread's input window
  static_assert(WIN >= 8 + KWMAX - 1 && 24 + WIN <= kTWP, "input window");
  extern __shared__ __align__(16) float smem[];
  const int taps = kh * kw;
  const int cs = chan_stride(kh, kw);
  const int stage = stage_floats(kh, kw, BN);
  const int trh = kTH + kh - 1;
  const int n_wt = (W + kTW - 1) / kTW;
  const int col0 = (blockIdx.x % n_wt) * kTW;
  const int co0 = (blockIdx.x / n_wt) * BN;
  const int row0 = blockIdx.y * kTH;
  const int img = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid % CG, pg = tid / CG;
  const int prow = pg / 4, pcol = (pg % 4) * 8;
  const int ph = kh / 2, pw = kw / 2;
  const float* xi = x + static_cast<size_t>(img) * H * W * Cin;

  auto load = [&](int buf, int ci0) {
    float* In = smem + buf * stage;              // [ci][row][col]
    float* Ws = In + kCI * cs;                   // [ci][tap][BN]
    const int n_in = kCI * trh * twh;
    for (int e = tid; e < n_in; e += nthr) {
      const int ci = e % kCI, p = e / kCI;
      const int r = p / twh, c = p % twh;
      const int gr = row0 + r - ph, gc = col0 + c - pw, gci = ci0 + ci;
      const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W && gci < Cin;
      cp_async<4>(smem_u32(In + ci * cs + r * pitch + c),
                  in ? xi + (static_cast<size_t>(gr) * W + gc) * Cin + gci
                     : x,
                  in ? 4 : 0);
    }
    constexpr int kCh = BN / 4;                  // 4-channel chunks a row
    const int n_w = kCI * taps * kCh;
    for (int e = tid; e < n_w; e += nthr) {
      const int q = e % kCh, row = e / kCh;      // row = ci * taps + tap
      const int ci = row / taps, tap = row % taps;
      const int gci = ci0 + ci, gco = co0 + 4 * q;
      float* dst = Ws + row * BN + 4 * q;
      const float* src = w + (static_cast<size_t>(tap) * Cin + gci) * Cout +
                         gco;
      if (vec) {
        const bool in = gci < Cin && gco < Cout;
        cp_async<16>(smem_u32(dst), in ? src : w, in ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = gci < Cin && gco + u < Cout;
          cp_async<4>(smem_u32(dst + u), in ? src + u : w, in ? 4 : 0);
        }
      }
    }
  };

  float acc[8][TC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  const int n_s = (Cin + kCI - 1) / kCI;
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < n_s; ++s) {
    if (s + 1 < n_s) load((s + 1) % kStages, (s + 1) * kCI);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                 // stage s has landed
    const float* In = smem + (s % kStages) * stage;
    const float* Ws = In + kCI * cs;
#pragma unroll 2
    for (int ci = 0; ci < kCI; ++ci) {
      const float* in_c = In + ci * cs + prow * pitch + pcol;
      const float* w_c = Ws + ci * taps * BN;
      if constexpr (KWMAX == 0) {
        // any width: a tap's 8 inputs as scalars
        for (int dy = 0; dy < kh; ++dy)
          for (int dx = 0; dx < kw; ++dx) {
            float a[8], b[TC];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = in_c[dy * pitch + dx + i];
            load_weights<TC, CG>(w_c + (dy * kw + dx) * BN, cg, b);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < TC; ++j)
                acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
      } else {
        // filter rows KWMAX at a time, unrolled with the taps: the loads of
        // the next row's window and weights go out under this row's FMAs
        for (int dy0 = 0; dy0 < kh; dy0 += KWMAX) {
#pragma unroll
          for (int dd = 0; dd < KWMAX; ++dd) {
            const int dy = dy0 + dd;
            if (dy < kh) {
              float a[WIN];
#pragma unroll
              for (int v = 0; v < WIN / 4; ++v)
                *reinterpret_cast<float4*>(a + 4 * v) =
                    *reinterpret_cast<const float4*>(in_c + dy * kTWP + 4 * v);
              const float* w_r = w_c + dy * kw * BN;
#pragma unroll
              for (int dx = 0; dx < KWMAX; ++dx) {
                if (KWMAX == 1 || dx < kw) {
                  float b[TC];
                  load_weights<TC, CG>(w_r + dx * BN, cg, b);
#pragma unroll
                  for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < TC; ++j)
                      acc[i][j] = fmaf(a[dx + i], b[j], acc[i][j]);
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();                 // stage s consumed: its buffer is free
  }

  const int row = row0 + prow;
  if (row >= H) return;
  float* o = out + (static_cast<size_t>(img) * H + row) * W * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + pcol + i;
    if (col >= W) break;
    float* oc = o + static_cast<size_t>(col) * Cout + co0;
    if constexpr (TC >= 4) {
#pragma unroll
      for (int g = 0; g < TC / 4; ++g) {
        const int c0 = chan<TC, CG>(cg, 4 * g);
        if (vec && co0 + c0 < Cout) {
          *reinterpret_cast<float4*>(oc + c0) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                          acc[i][4 * g + 2], acc[i][4 * g + 3]);
        } else if (!vec) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (co0 + c0 + u < Cout) oc[c0 + u] = acc[i][4 * g + u];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = chan<TC, CG>(cg, j);
        if (co0 + c < Cout) oc[c] = acc[i][j];
      }
    }
  }
}

// the dynamic shared memory limit, raised once a kernel and device (each
// launch asks for what its tile needs)
template <auto kernel>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done[dev] = err == cudaSuccess;
  return err;
}

template <int TC, int CG, int KWMAX, int KS>
cudaError_t launch(const float* x, const float* w, float* out, int N, int H,
                   int W, int Cin, int Cout, int kh, int kw, int vec,
                   cudaStream_t s) {
  constexpr auto kernel = conv2d_kernel<TC, CG, KWMAX, KS>;
  constexpr int BN = TC * CG;
  const cudaError_t set = allow_smem<kernel>();
  if (set != cudaSuccess) return set;
  const int smem = kStages * stage_floats(kh, kw, BN) * 4;
  const int n_wt = (W + kTW - 1) / kTW, n_ct = (Cout + BN - 1) / BN;
  const dim3 grid(n_wt * n_ct, (H + kTH - 1) / kTH, N);
  kernel<<<grid, 4 * kTH * CG, smem, s>>>(x, w, out, H, W, Cin, Cout, kh, kw,
                                          vec);
  return cudaGetLastError();
}

// the square filters 1, 3 and 5 with their taps compile-time constants
// (a run-time filter's guards keep the compiler from scheduling the taps'
// loads early), any other under its width template (0: any width)
template <int TC, int CG>
cudaError_t launch_kw(int kwmax, const float* x, const float* w, float* out,
                      int N, int H, int W, int Cin, int Cout, int kh, int kw,
                      int vec, cudaStream_t s) {
  const bool square = kh == kw && kw == kwmax;
  switch (kwmax) {
    case 0:
      return launch<TC, CG, 0, 0>(x, w, out, N, H, W, Cin, Cout, kh, kw, vec,
                                  s);
    case 1:
      return square ? launch<TC, CG, 1, 1>(x, w, out, N, H, W, Cin, Cout, kh,
                                           kw, vec, s)
                    : launch<TC, CG, 1, 0>(x, w, out, N, H, W, Cin, Cout, kh,
                                           kw, vec, s);
    case 3:
      return square ? launch<TC, CG, 3, 3>(x, w, out, N, H, W, Cin, Cout, kh,
                                           kw, vec, s)
                    : launch<TC, CG, 3, 0>(x, w, out, N, H, W, Cin, Cout, kh,
                                           kw, vec, s);
    case 5:
      return square ? launch<TC, CG, 5, 5>(x, w, out, N, H, W, Cin, Cout, kh,
                                           kw, vec, s)
                    : launch<TC, CG, 5, 0>(x, w, out, N, H, W, Cin, Cout, kh,
                                           kw, vec, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block (kernel.py's `plan` keeps a copy).
long long conv2d_smem_bytes(int kh, int kw, int bn) {
  return static_cast<long long>(kStages) * stage_floats(kh, kw, bn) * 4;
}

// x (N, H, W, Cin), w (kh, kw, Cin, Cout), out (N, H, W, Cout): contiguous
// fp32.  The tile is kernel.py's plan: tc channels a thread, cg channel
// groups (BN = tc * cg: (8, 8), (4, 8), (2, 8) or (2, 4)), kwmax in
// {1, 3, 5} >= kw, or 0 (any kw); vec: Cout % 4 == 0 and w and out on
// 16-byte boundaries.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int conv2d_launch(const void* x, const void* w, void* out, int N, int H,
                  int W, int Cin, int Cout, int kh, int kw, int tc, int cg,
                  int kwmax, int vec, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (kh <= 0 || kw <= 0 || (kwmax > 0 && kw > kwmax) ||
      4 * kTH * cg > kMaxThreads || N > 65535 ||
      (H + kTH - 1) / kTH > 65535 ||
      conv2d_smem_bytes(kh, kw, tc * cg) > kMaxSmem || (vec && Cout % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tc == 8 && cg == 8)
    err = launch_kw<8, 8>(kwmax, xf, wf, of, N, H, W, Cin, Cout, kh, kw, vec,
                          s);
  else if (tc == 4 && cg == 8)
    err = launch_kw<4, 8>(kwmax, xf, wf, of, N, H, W, Cin, Cout, kh, kw, vec,
                          s);
  else if (tc == 2 && cg == 8)
    err = launch_kw<2, 8>(kwmax, xf, wf, of, N, H, W, Cin, Cout, kh, kw, vec,
                          s);
  else if (tc == 2 && cg == 4)
    err = launch_kw<2, 4>(kwmax, xf, wf, of, N, H, W, Cin, Cout, kh, kw, vec,
                          s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

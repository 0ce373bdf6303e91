// ELL sparse matrix-vector product for Hopper (sm_90a), in two idioms, CUDA
// C++ with a plain C interface (loaded with ctypes by kernels/spmv/kernel.py).
//
// Replaces the TPU kernel `_spmv_take_kernel` (src/repro/kernels/spmv/
// kernel.py:24, pallas_call at :56), the gather idiom.  Same function:
//   y[r] = sum_k vals[r, k] * x[cols[r, k]]
// over vals (R, K) fp32, cols (R, K) int32 and a dense x (C,) fp32, into
// y (R, 1).  On the TPU, x sits whole in VMEM and each row block gathers
// from it; here x is read through the read-only (texture) path, so hot
// columns stay in L1/L2 and the gather costs one cached load per nonzero.
//
// What bounds it: device memory.  Each nonzero moves 8 bytes (value and
// column) for 2 operations; at R = C = 2^22 and K = 16 the function moves
// 570 MB (vals, cols, x once, y), 0.170 ms at 3.35 TB/s on an H100 SXM.
// The random gather from x (16 MiB at that size, inside the 50 MB L2)
// adds sectors the bound does not count.  Design:
//  - a group of G lanes per row, G the power of two at or above K (at most
//    32): lane l takes nonzeros l, l+G, ...; for K = 16 a warp reads two
//    rows' values and columns as one 128-byte line each;
//  - each group walks RPG rows (block_multiplier), RPG * (256 / G)
//    consecutive rows per block, so each step of the walk is coalesced and
//    a thread has RPG independent gathers in flight;
//  - the group's partial sums meet in a shuffle-xor reduction, and lane 0
//    of the group writes y[r];
//  - a column outside [0, C) adds nothing (memory stays safe without a
//    host check; the plain version raises on such a column instead).
//
// Also replaces `_spmv_onehot_kernel` (src/repro/kernels/spmv/kernel.py:32,
// pallas_call at :56), the one-hot idiom of the same product:
//   y[r] = sum_k vals[r, k] * sum_c [cols[r, k] == c] * x[c]
// where a column outside [0, C) contributes 0.  The idiom is the paper's
// subject (the cost of predication set against an indexed load), so the
// kernel keeps its character: there is no load of x whose address depends
// on a column index, and every nonzero is compared with every column of x,
// R * K * C compare-selects (2^32 at the JAX veceval size, 2^14 x 16
// nonzeros against C = 2^14).  Their issue bounds it, far above the
// function's bytes (vals, cols, x once and y: 2.1 MB there, 0.0006 ms at
// 3.35 TB/s): at one issue slot a compare-select, 128 slots a clock an SM,
// 132 SMs and 1.98 GHz, 2^32 take 0.128 ms.  Design:
//  - a compare-select is 1.5 issue slots, none on the half-rate integer
//    pipe: one `setp.eq.f16x2` compares a nonzero with two columns (its
//    column and the columns as fp16, exact below 2048: each is taken
//    relative to a 2048-column window and clamped to [-1, 2048]), and a
//    predicated fp32 add (`@p add.f32 hit, hit, x[c]`) selects: exactly one
//    column matches, so `hit` is 0 plus that x[c], exact.  An integer compare
//    and a select, as before, are two issue slots on the half-rate pipe;
//  - a lane holds NS = 4 nonzeros of its row (G = 4 lanes a row at K = 16,
//    nonzero l + i * G in lane l), so each 16-byte broadcast of x from
//    shared memory feeds 16 compare-selects.  Eight a lane (G = 2) would
//    feed 32, but leave two warps a scheduler at the JAX size, too few to
//    cover the compare's latency: four a lane measured faster;
//  - x is staged into shared memory once a block, up to 16384 floats (64
//    KB of dynamic shared memory; larger C goes through in chunks of that,
//    two barriers each), zero past C;
//  - the lanes of a row meet in a shuffle-xor reduction and lane 0 writes
//    y[r].
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int G, int RPG>
__global__ void __launch_bounds__(kThreads)
    spmv_ell_kernel(const float* __restrict__ vals,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ y,
                    int R, int K, int C) {
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const long long row0 = static_cast<long long>(blockIdx.x) * RPG * kGroups;
  float acc[RPG];
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
    acc[j] = 0.f;
    const long long r = row0 + static_cast<long long>(j) * kGroups + group;
    if (r < R) {
      const float* vr = vals + r * K;
      const int32_t* cr = cols + r * K;
      for (int k = lane; k < K; k += G) {
        const int c = __ldg(cr + k);
        const float v = __ldg(vr + k);
        if (c >= 0 && c < C) acc[j] += v * __ldg(x + c);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
      acc[j] += __shfl_xor_sync(kFull, acc[j], off, G);
    }
    const long long r = row0 + static_cast<long long>(j) * kGroups + group;
    if (lane == 0 && r < R) y[r] = acc[j];
  }
}

template <int G>
void launch_g(const float* vals, const int32_t* cols, const float* x,
              float* y, int R, int K, int C, int rpg, cudaStream_t s) {
  const int rows_per_block = rpg * (kThreads / G);
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(R) + rows_per_block - 1) / rows_per_block);
  switch (rpg) {
    case 1: spmv_ell_kernel<G, 1><<<grid, kThreads, 0, s>>>(vals, cols, x, y, R, K, C); break;
    case 2: spmv_ell_kernel<G, 2><<<grid, kThreads, 0, s>>>(vals, cols, x, y, R, K, C); break;
    case 4: spmv_ell_kernel<G, 4><<<grid, kThreads, 0, s>>>(vals, cols, x, y, R, K, C); break;
    case 8: spmv_ell_kernel<G, 8><<<grid, kThreads, 0, s>>>(vals, cols, x, y, R, K, C); break;
  }
}

// one-hot idiom: lanes of G a row, NS nonzeros a lane a pass, x staged in
// chunks of `chunk` floats (a multiple of 4)
constexpr int kWindow = 2048;       // columns compared in fp16 at a time
constexpr int kMaxChunk = 16384;    // x floats staged at most (64 KB)

// hit0 += x[c] or x[c + 2], hit1 += x[c + 1] or x[c + 3], where that fp16
// column equals the nonzero's fp16 column d (both halves of dd); two sums,
// so a nonzero's predicated adds form two chains, not one
__device__ __forceinline__ void onehot4(float& hit0, float& hit1, uint32_t dd,
                                        uint32_t c01, uint32_t c23,
                                        float4 xv) {
  asm("{\n\t"
      ".reg .pred p0, p1, p2, p3;\n\t"
      "setp.eq.f16x2 p0|p1, %2, %3;\n\t"
      "setp.eq.f16x2 p2|p3, %2, %4;\n\t"
      "@p0 add.f32 %0, %0, %5;\n\t"
      "@p1 add.f32 %1, %1, %6;\n\t"
      "@p2 add.f32 %0, %0, %7;\n\t"
      "@p3 add.f32 %1, %1, %8;\n\t"
      "}"
      : "+f"(hit0), "+f"(hit1)
      : "r"(dd), "r"(c01), "r"(c23), "f"(xv.x), "f"(xv.y), "f"(xv.z),
        "f"(xv.w));
}

template <int G, int NS>
__global__ void __launch_bounds__(kThreads)
    spmv_onehot_kernel(const float* __restrict__ vals,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ x, float* __restrict__ y,
                       int R, int K, int C, int passes, int chunk) {
  extern __shared__ float4 x_s4[];
  float* x_s = reinterpret_cast<float*>(x_s4);
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const long long r = static_cast<long long>(blockIdx.x) * kGroups + group;
  const bool live = r < R;
  // x[c0, c0 + chunk) into shared memory, zero past C
  auto stage = [&](int c0) {
    for (int i = threadIdx.x; i < chunk; i += kThreads)
      x_s[i] = c0 + i < C ? x[c0 + i] : 0.f;
  };
  const bool one_chunk = C <= chunk;
  if (one_chunk) {
    stage(0);
    __syncthreads();
  }
  float acc = 0.f;
  for (int p = 0; p < passes; ++p) {           // block-uniform
    int col[NS];
    float val[NS], hit[NS], hit1[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int k = lane + (p * NS + i) * G;
      const bool ok = live && k < K;
      col[i] = ok ? __ldg(cols + r * K + k) : -1;   // -1 matches no column
      val[i] = ok ? __ldg(vals + r * K + k) : 0.f;
      hit[i] = hit1[i] = 0.f;
    }
    for (int c0 = 0; c0 < C; c0 += chunk) {
      if (!one_chunk) {
        __syncthreads();                       // the last chunk is consumed
        stage(c0);
        __syncthreads();
      }
      const int n = min(chunk, (C - c0 + 3) & ~3);   // staged, zero past C
      for (int w0 = 0; w0 < n; w0 += kWindow) {
        const int base = c0 + w0;
        uint32_t dd[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int d = col[i] < base ? -1 : min(col[i] - base, kWindow);
          const uint32_t h = __half_as_ushort(__int2half_rn(d));
          dd[i] = h | (h << 16);
        }
        uint32_t c01 = 0x3c000000u;            // fp16 (0, 1)
        uint32_t c23 = 0x42004000u;            // fp16 (2, 3)
        const float4* xw = x_s4 + (w0 >> 2);
        const int quads = min(kWindow, n - w0) >> 2;
#pragma unroll 4
        for (int c = 0; c < quads; ++c) {
          const float4 xv = xw[c];
#pragma unroll
          for (int i = 0; i < NS; ++i)
            onehot4(hit[i], hit1[i], dd[i], c01, c23, xv);
          asm("add.rn.f16x2 %0, %0, %2;\n\t"
              "add.rn.f16x2 %1, %1, %2;"
              : "+r"(c01), "+r"(c23)
              : "r"(0x44004400u));             // + (4, 4)
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) acc += val[i] * (hit[i] + hit1[i]);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(kFull, acc, off, G);
  }
  if (lane == 0 && live) y[r] = acc;
}

// cudaFuncSetAttribute once a kernel and device, to the most any launch
// asks for
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};        // one flag a device, for this kernel
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  done[dev] = err == cudaSuccess;
  return err;
}

template <int G, int NS>
cudaError_t launch_onehot(const float* vals, const int32_t* cols,
                          const float* x, float* y, int R, int K, int C,
                          int passes, int chunk, cudaStream_t s) {
  constexpr int kGroups = kThreads / G;
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(R) + kGroups - 1) / kGroups);
  const cudaError_t set = allow_smem<spmv_onehot_kernel<G, NS>>(
      kMaxChunk * static_cast<int>(sizeof(float)));
  if (set != cudaSuccess) return set;
  const int smem = chunk * static_cast<int>(sizeof(float));
  spmv_onehot_kernel<G, NS><<<grid, kThreads, smem, s>>>(
      vals, cols, x, y, R, K, C, passes, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// vals (R, K) fp32, cols (R, K) int32, x (C,) fp32, y (R,) fp32, all
// contiguous; rpg (rows each lane group walks) in {1, 2, 4, 8}.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int spmv_ell_launch(const void* vals, const void* cols, const void* x,
                    void* y, int R, int K, int C, int rpg, void* stream) {
  if (R <= 0) return 0;
  if (K < 0 || (rpg != 1 && rpg != 2 && rpg != 4 && rpg != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (K <= 1) {
    launch_g<1>(v, c, xf, yf, R, K, C, rpg, s);
  } else if (K <= 2) {
    launch_g<2>(v, c, xf, yf, R, K, C, rpg, s);
  } else if (K <= 4) {
    launch_g<4>(v, c, xf, yf, R, K, C, rpg, s);
  } else if (K <= 8) {
    launch_g<8>(v, c, xf, yf, R, K, C, rpg, s);
  } else if (K <= 16) {
    launch_g<16>(v, c, xf, yf, R, K, C, rpg, s);
  } else {
    launch_g<32>(v, c, xf, yf, R, K, C, rpg, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The one-hot idiom: vals (R, K) fp32, cols (R, K) int32, x (C,) fp32,
// y (R,) fp32, all contiguous.  `lanes` (G: 1, 2, 4, 8, 16 or 32 a row) and
// `per_lane` (NS: 1, 2 or 4 nonzeros a lane a pass; 4 unless G is 1) with
// `passes` * G * NS >= K; x staged `chunk` floats at a time (a multiple of
// 4, at most 16384).  Launches on `stream` and returns a CUDA
// error code (0 on success).
int spmv_onehot_launch(const void* vals, const void* cols, const void* x,
                       void* y, int R, int K, int C, int lanes, int per_lane,
                       int passes, int chunk, void* stream) {
  if (R <= 0) return 0;
  if (K < 0 || C < 0 || passes < 0 || chunk <= 0 || chunk % 4 ||
      chunk > kMaxChunk ||
      static_cast<long long>(passes) * lanes * per_lane < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaError_t err = cudaErrorInvalidValue;
#define ONEHOT(G_, NS_)                                                   \
  if (lanes == G_ && per_lane == NS_)                                     \
    err = launch_onehot<G_, NS_>(v, c, xf, yf, R, K, C, passes, chunk, s);
  ONEHOT(1, 1) ONEHOT(1, 2) ONEHOT(1, 4) ONEHOT(2, 4) ONEHOT(4, 4)
  ONEHOT(8, 4) ONEHOT(16, 4) ONEHOT(32, 4)
#undef ONEHOT
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

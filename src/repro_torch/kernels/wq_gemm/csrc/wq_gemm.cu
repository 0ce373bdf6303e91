// Weight-only int8 GEMM for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/wq_gemm/kernel.py).
//
// Replaces the TPU kernel `_wq_kernel` (src/repro/kernels/wq_gemm/
// kernel.py:22, pallas_call at :48): y (M, N) = x (M, K) @ (q (K, N) *
// scale[N]), q int8 with one fp32 scale per output channel.  As there, each
// int8 weight is widened to fp32 inside the kernel, the products accumulate
// in fp32, the per-column scale is applied once at the store and the result
// is rounded once to the output type.  x is fp32 or bf16; y is x's type or
// fp32.  With `transposed` q is stored (N, K) row-major: the tied unembed's
// (V, d) embedding table, whose per-row scale is the per-output-channel
// scale, read in place (no transposed copy).
//
// What bounds it.  Serving decode runs it at M = the batch rows (8): there
// it is bytes-bound, the int8 weights read once (granite-3-2b's 2048 -> 8192
// projection: 16.8 MB, ~5 us at 3.35 TB/s).  A prefill runs it at M in the
// thousands, where the operations bound it.  Design (simple and right
// first):
//  - M <= 8, (K, N) layout (`wq_gemv_kn`): a block owns 64 columns and a
//    range of K; each thread streams 8 columns of 8 rows a tile with 8-byte
//    loads (8 independent loads in flight, issued before the tile's x is
//    staged), x staged in shared memory k-major so the M values of a row
//    are one broadcast read.  Enough blocks to fill the card in one wave
//    (two a SM) come from splitting K: each split writes fp32
//    partials, and the last block of a column strip to finish (a ticket
//    counter, reset by that block) sums them in split order, so the result
//    does not depend on the order the blocks ran;
//  - M <= 8, (N, K) layout (`wq_gemv_nk`): a warp owns 4 output columns
//    (4 rows of q) and its lanes stride along K with 4-byte loads, 128
//    contiguous bytes a warp; x staged in shared memory; one warp reduction
//    at the end;
//  - M > 8 (`wq_gemm_tiled`): gemm.cu's register-tiled loop (256 threads,
//    a 4 x 4 or 8 x 8 tile each), x converted to fp32 and the int8 tile to
//    fp32 as they are staged in shared memory.  It runs on the CUDA cores in
//    fp32, so a bf16 prefill is far from the tensor-core bound: later work;
//  - ragged edges: M, N and K need not be multiples of a tile.  Vector loads
//    are used only where the row length and the base address allow them
//    (checked by the wrapper); otherwise the same kernel loads bytes, masked
//    at the edge.  Nothing falls back to another implementation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallM = 8;         // rows up to which the GEMV kernels run

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// byte j (0..3) of w as a signed int8, widened to fp32
__device__ __forceinline__ float byte_f(uint32_t w, int j) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * j)) >> 24);
}

// up to 4 bytes from p, those at or past `n` zero
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p, int n) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < n) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[b])) << (8 * b);
  return w;
}

// ---------------------------------------------------------------------------
// M <= 8, q (K, N)
// ---------------------------------------------------------------------------
constexpr int kKnCols = 8;                    // columns a thread owns
constexpr int kKnTpr = 8;                     // threads along a row
constexpr int kKnBN = kKnCols * kKnTpr;       // 64 columns a block
constexpr int kKnRows = kThreads / kKnTpr;    // 32 rows a pass
constexpr int kKnKT = 256;                    // rows of x staged a tile
constexpr int kKnUnroll = kKnKT / kKnRows;    // 8 rows a thread a tile

template <typename Tx, typename To, int MT>
__global__ void __launch_bounds__(kThreads)
    wq_gemv_kn(const Tx* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, To* __restrict__ y,
               float* __restrict__ ws, int* __restrict__ counters, int M,
               int N, int K, int rows_per_split, int vec) {
  __shared__ float xs[kKnKT][MT];
  __shared__ float red[kWarps][MT][kKnBN];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cg = tid % kKnTpr;
  const int r0 = tid / kKnTpr;
  const int nb = blockIdx.x * kKnBN;
  const int n0 = nb + cg * kKnCols;
  const int k_begin = blockIdx.y * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);
  const bool col_vec = vec && n0 + kKnCols <= N;

  float acc[MT][kKnCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kKnCols; ++j) acc[m][j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kKnKT) {
    // the tile's weights first: their loads are in flight while x is staged
    uint2 w[kKnUnroll];
#pragma unroll
    for (int u = 0; u < kKnUnroll; ++u) {
      const int k = kt + r0 + u * kKnRows;
      w[u] = make_uint2(0u, 0u);
      if (k < k_end && n0 < N) {
        const int8_t* row = q + static_cast<size_t>(k) * N + n0;
        if (col_vec) {
          w[u] = __ldg(reinterpret_cast<const uint2*>(row));
        } else {
          w[u].x = load_bytes(row, N - n0);
          w[u].y = load_bytes(row + 4, N - n0 - 4);
        }
      }
    }
    __syncthreads();                    // the previous tile's x is consumed
    for (int e = tid; e < kKnKT * MT; e += kThreads) {
      const int m = e / kKnKT, r = e % kKnKT, k = kt + r;
      xs[r][m] = (m < M && k < k_end)
                     ? to_float(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kKnUnroll; ++u) {
      const int r = r0 + u * kKnRows;
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) xv[m] = xs[r][m];
#pragma unroll
      for (int j = 0; j < kKnCols; ++j) {
        const float wf = byte_f(j < 4 ? w[u].x : w[u].y, j % 4);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xv[m], wf, acc[m][j]);
      }
    }
  }

  // lanes cg, cg + 8, cg + 16, cg + 24 of a warp hold the same columns
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kKnCols; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < kKnTpr) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kKnCols; ++j)
        red[warp][m][lane * kKnCols + j] = acc[m][j];
  }
  __syncthreads();
  const bool split = gridDim.y > 1;
  for (int o = tid; o < MT * kKnBN; o += kThreads) {
    const int m = o / kKnBN, c = o % kKnBN, n = nb + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][m][c];
    if (split)
      ws[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = s;
    else
      y[static_cast<size_t>(m) * N + n] = from_float<To>(s * scale[n]);
  }
  if (!split) return;
  // the last split of this column strip to finish sums the partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&counters[blockIdx.x], 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int o = tid; o < MT * kKnBN; o += kThreads) {
    const int m = o / kKnBN, c = o % kKnBN, n = nb + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int sp = 0; sp < static_cast<int>(gridDim.y); ++sp)
      s += __ldcg(&ws[(static_cast<size_t>(sp) * M + m) * N + n]);
    y[static_cast<size_t>(m) * N + n] = from_float<To>(s * scale[n]);
  }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next launch
}

// ---------------------------------------------------------------------------
// M <= 8, q (N, K): the tied unembed
// ---------------------------------------------------------------------------
constexpr int kNkCols = 4;                    // output columns a warp owns
constexpr int kNkBN = kNkCols * kWarps;       // 32 columns a block
constexpr int kNkChunks = 4;                  // 4-byte chunks a lane a tile
constexpr int kNkKT = kNkChunks * 128;        // 512 k staged a tile

template <typename Tx, typename To, int MT>
__global__ void __launch_bounds__(kThreads)
    wq_gemv_nk(const Tx* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, To* __restrict__ y, int M,
               int N, int K, int vec) {
  static_assert(kNkCols * MT <= 32, "one lane stores each output");
  __shared__ __align__(16) float xs[MT][kNkKT];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int nb = blockIdx.x * kNkBN + warp * kNkCols;

  float acc[kNkCols][MT];
#pragma unroll
  for (int c = 0; c < kNkCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[c][m] = 0.f;

  for (int kt = 0; kt < K; kt += kNkKT) {
    // the tile's weights first: their loads are in flight while x is staged
    uint32_t w[kNkCols][kNkChunks];
#pragma unroll
    for (int c = 0; c < kNkCols; ++c) {
      const int n = nb + c;
#pragma unroll
      for (int j = 0; j < kNkChunks; ++j) {
        const int k = kt + j * 128 + lane * 4;
        w[c][j] = 0u;
        if (n < N && k < K) {
          const int8_t* p = q + static_cast<size_t>(n) * K + k;
          w[c][j] = vec ? __ldg(reinterpret_cast<const uint32_t*>(p))
                        : load_bytes(p, K - k);
        }
      }
    }
    __syncthreads();                    // the previous tile's x is consumed
    for (int e = tid; e < MT * kNkKT; e += kThreads) {
      const int m = e / kNkKT, r = e % kNkKT, k = kt + r;
      xs[m][r] = (m < M && k < K) ? to_float(x[static_cast<size_t>(m) * K + k])
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kNkChunks; ++j) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&xs[m][j * 128 + lane * 4]);
#pragma unroll
        for (int c = 0; c < kNkCols; ++c) {
          float a = acc[c][m];
          a = fmaf(xv.x, byte_f(w[c][j], 0), a);
          a = fmaf(xv.y, byte_f(w[c][j], 1), a);
          a = fmaf(xv.z, byte_f(w[c][j], 2), a);
          a = fmaf(xv.w, byte_f(w[c][j], 3), a);
          acc[c][m] = a;
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kNkCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[c][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[c][m] = v;
    }
#pragma unroll
  for (int c = 0; c < kNkCols; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int n = nb + c;
      if (lane == c * MT + m && m < M && n < N)
        y[static_cast<size_t>(m) * N + n] = from_float<To>(acc[c][m] * scale[n]);
    }
}

// ---------------------------------------------------------------------------
// M > 8: register-tiled GEMM (either layout)
// ---------------------------------------------------------------------------
template <typename Tx, typename To, int TM, int TN, bool kTrans>
__global__ void __launch_bounds__(kThreads)
    wq_gemm_tiled(const Tx* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, To* __restrict__ y, int M,
                  int N, int K) {
  constexpr int BK = 16;
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  constexpr int kA = BM * BK / kThreads;   // x elements a thread stages
  constexpr int kB = BN * BK / kThreads;   // q elements a thread stages
  static_assert(kA * kThreads == BM * BK && kB * kThreads == BN * BK,
                "tile does not divide among the threads");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float a_next[kA], b_next[kB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      const int m = row0 + e / BK, k = k0 + e % BK;
      a_next[i] = (m < M && k < K)
                      ? to_float(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      // consecutive threads on consecutive bytes of q in either layout
      const int k = k0 + (kTrans ? e % BK : e / BN);
      const int n = col0 + (kTrans ? e / BK : e % BN);
      const size_t at = kTrans ? static_cast<size_t>(n) * K + k
                               : static_cast<size_t>(k) * N + n;
      b_next[i] = (k < K && n < N) ? static_cast<float>(q[at]) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      As[e % BK][e / BK] = a_next[i];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      if (kTrans)
        Bs[e % BK][e / BK] = b_next[i];
      else
        Bs[e / BN][e % BN] = b_next[i];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);      // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = row0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < N)
        y[static_cast<size_t>(m) * N + n] = from_float<To>(acc[i][j] * scale[n]);
    }
  }
}

template <typename Tx, typename To, int TM, int TN>
void launch_tiled(const Tx* x, const int8_t* q, const float* scale, To* y,
                  int M, int N, int K, int transposed, cudaStream_t s) {
  const dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
  if (transposed)
    wq_gemm_tiled<Tx, To, TM, TN, true><<<grid, kThreads, 0, s>>>(x, q, scale,
                                                                  y, M, N, K);
  else
    wq_gemm_tiled<Tx, To, TM, TN, false><<<grid, kThreads, 0, s>>>(x, q, scale,
                                                                   y, M, N, K);
}

template <typename Tx, typename To, int MT>
void launch_gemv(const Tx* x, const int8_t* q, const float* scale, To* y,
                 float* ws, int* counters, int M, int N, int K, int transposed,
                 int ksplit, int rows_per_split, int vec, cudaStream_t s) {
  if (transposed) {
    wq_gemv_nk<Tx, To, MT><<<(N + kNkBN - 1) / kNkBN, kThreads, 0, s>>>(
        x, q, scale, y, M, N, K, vec);
  } else {
    const dim3 grid((N + kKnBN - 1) / kKnBN, ksplit);
    wq_gemv_kn<Tx, To, MT><<<grid, kThreads, 0, s>>>(
        x, q, scale, y, ws, counters, M, N, K, rows_per_split, vec);
  }
}

template <typename Tx, typename To>
void launch(const void* xv, const void* qv, const void* sv, void* yv,
            void* wsv, void* cv, int M, int N, int K, int transposed,
            int ksplit, int rows_per_split, int vec, cudaStream_t s) {
  const Tx* x = static_cast<const Tx*>(xv);
  const int8_t* q = static_cast<const int8_t*>(qv);
  const float* scale = static_cast<const float*>(sv);
  To* y = static_cast<To*>(yv);
  float* ws = static_cast<float*>(wsv);
  int* counters = static_cast<int*>(cv);
  if (M <= 1)
    launch_gemv<Tx, To, 1>(x, q, scale, y, ws, counters, M, N, K, transposed,
                           ksplit, rows_per_split, vec, s);
  else if (M <= 2)
    launch_gemv<Tx, To, 2>(x, q, scale, y, ws, counters, M, N, K, transposed,
                           ksplit, rows_per_split, vec, s);
  else if (M <= 4)
    launch_gemv<Tx, To, 4>(x, q, scale, y, ws, counters, M, N, K, transposed,
                           ksplit, rows_per_split, vec, s);
  else if (M <= kSmallM)
    launch_gemv<Tx, To, kSmallM>(x, q, scale, y, ws, counters, M, N, K,
                                 transposed, ksplit, rows_per_split, vec, s);
  else if (M <= 64)
    launch_tiled<Tx, To, 4, 4>(x, q, scale, y, M, N, K, transposed, s);
  else
    launch_tiled<Tx, To, 8, 8>(x, q, scale, y, M, N, K, transposed, s);
}

}  // namespace

extern "C" {

// x (M, K) contiguous, fp32 (x_dtype 0) or bf16 (1); q int8, (K, N) or
// with `transposed` (N, K), contiguous; scale (N,) fp32; y (M, N) of
// out_dtype (0 fp32, 1 bf16; bf16 only with bf16 x).  For M <= 8 and q
// (K, N), `ksplit` blocks split K into ranges of `rows_per_split` rows; with
// ksplit > 1, `ws` holds (ksplit, M, N) fp32 partials and `counters` one int
// a 64-column strip, all zero on entry (the kernel leaves them zero; no
// launch in flight on another stream may share them).  `vec`:
// q's row length and base allow 8-byte (q (K, N)) or 4-byte (q (N, K))
// loads.  Launches on `stream`; returns cudaGetLastError() (0 on success).
int wq_gemm_launch(const void* x, const void* q, const void* scale, void* y,
                   void* ws, void* counters, int M, int N, int K, int x_dtype,
                   int out_dtype, int transposed, int ksplit,
                   int rows_per_split, int vec, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (ksplit < 1 || (ksplit > 1 && (M > kSmallM || transposed)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0)
    launch<float, float>(x, q, scale, y, ws, counters, M, N, K, transposed,
                         ksplit, rows_per_split, vec, s);
  else if (x_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, q, scale, y, ws, counters, M, N,
                                         K, transposed, ksplit,
                                         rows_per_split, vec, s);
  else if (x_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(x, q, scale, y, ws, counters, M, N, K,
                                 transposed, ksplit, rows_per_split, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

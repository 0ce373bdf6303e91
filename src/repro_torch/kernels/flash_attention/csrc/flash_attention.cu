// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/flash_attention/kernel.py).
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention/
// kernel.py, launched by `flash_attention_fwd`).  Same function: grouped
// queries q (BN, R, H), row r being query column r % sq_real (GQA by query
// grouping: the G query heads that share a KV head are stacked along R);
// k/v (BN, Skv, H); scores scaled by H^-1/2, soft-capped as
// softcap * tanh(s / softcap), then masked by `kv_pos < Skv` and, when
// causal, `kv_pos <= r % sq_real`; masked scores are -1e30 (not -inf), so no
// row turns NaN.  Out: `out` (BN, R, H) in q's dtype and the per-row
// log-sum-exp `lse = m + log(max(l, 1e-30))` (BN, R) fp32, which the TPU
// kernel drops and the backward needs.
//
// What bounds it: operations (2 * R * Skv * H multiply-adds per head for
// full attention, about half that causal); the bytes are each input read
// once per query tile.  Design, simple first:
//  - one block per (64-row query tile, bn); a loop over 64-row KV tiles
//    inside the block replaces the TPU's sequential kv grid axis.  The
//    online-softmax state (m, l, acc) stays in fp32 registers.
//  - the Q tile and each K/V tile are staged in shared memory, widened to
//    fp32 (Q and K at row stride H + 1: no bank conflicts).  256 threads;
//    thread (ty, tx) owns query rows ty + 16 i (i < 4), scores KV columns
//    tx + 16 j (j < 4) of the tile (a 4 x 4 register tile: 8 shared loads
//    per 16 multiply-adds) and output columns tx + 16 c (c < H / 16).
//    A row's max and sum are reductions over its 16 lanes (xor shuffles).
//    The probabilities go through shared memory to the P.V product.
//  - causal block skip: the loop stops at the last KV tile that the tile's
//    largest query position reaches.  With grouped rows a tile can wrap
//    from the end of one query head to the start of the next, so that
//    position is (last row) % sq_real when the tile does not wrap and
//    sq_real - 1 when it does; the in-tile mask stays exact either way.
//  - fp32 and bf16 inputs; H is a template parameter (32, 64, 128).
// Known limits, later work: CUDA cores, not tensor cores (mma.sync /
// wgmma); no TMA or cp.async staging, no double buffering; no split-KV; at
// H 128 the block's 115 KB of shared memory leaves one block per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBKV = 64;            // KV rows per tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBQ / 16;
constexpr int kColsPerThread = kBKV / 16;
constexpr int kPLd = kBKV + 1;      // row stride of the probability tile
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 16 lanes of a row (lanes tx = 0..15 of one half-warp);
// a butterfly gives every lane the same bits
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int H>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ) * (H + 1) + size_t(kBKV) * (H + 1) + size_t(kBKV) * H +
          size_t(kBQ) * kPLd);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int rows, int skv, int sq,
                 int causal, float scale, float softcap) {
  constexpr int kLd = H + 1;
  constexpr int kOut = H / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // kBQ x kLd
  float* ks = qs + kBQ * kLd;                // kBKV x kLd
  float* vs = ks + kBKV * kLd;               // kBKV x H
  float* ps = vs + kBKV * H;                 // kBQ x kPLd

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t bn = blockIdx.y;
  const int r0 = blockIdx.x * kBQ;
  const T* qb = q + bn * rows * H;
  const T* kb = k + bn * skv * H;
  const T* vb = v + bn * skv * H;

  for (int e = tid; e < kBQ * H; e += kThreads) {
    const int r = e / H, c = e % H;
    qs[r * kLd + c] =
        r0 + r < rows ? to_f32(qb[size_t(r0 + r) * H + c]) : 0.0f;
  }

  int qpos[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kOut];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    qpos[i] = (r0 + ty + 16 * i) % sq;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;
  }

  int n_tiles = (skv + kBKV - 1) / kBKV;
  if (causal) {
    const int r_last = min(r0 + kBQ, rows) - 1;
    const int reach = r0 / sq == r_last / sq ? r_last % sq : sq - 1;
    n_tiles = min(n_tiles, reach / kBKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();    // the last tile's readers are done (and Q is staged)
    for (int e = tid; e < kBKV * H; e += kThreads) {
      const int r = e / H, c = e % H;
      const bool in = kv0 + r < skv;
      const size_t g = size_t(kv0 + r) * H + c;
      ks[r * kLd + c] = in ? to_f32(kb[g]) : 0.0f;
      vs[r * H + c] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int h = 0; h < H; ++h) {
      float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = qs[(ty + 16 * i) * kLd + h];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = ks[(tx + 16 * j) * kLd + h];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const int kv = kv0 + tx + 16 * j;
        const bool keep = kv < skv && (!causal || kv <= qpos[i]);
        s[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) p[i] = ps[(ty + 16 * i) * kPLd + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float x = vs[j * H + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][c] = fmaf(p[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const size_t o = bn * rows + row;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      store(out + o * H + tx + 16 * c, acc[i][c] / denom);
    if (tx == 0) lse[o] = m[i] + logf(denom);
  }
}

template <typename T, int H>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int bn, int rows, int skv, int sq, int causal, float scale,
           float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<H>();
  // above 48 KB a block's shared memory must be asked for (once is enough)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((rows + kBQ - 1) / kBQ, bn);
  flash_fwd_kernel<T, H><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), rows, skv, sq, causal, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_h(int head_dim, const void* q, const void* k, const void* v,
             void* out, void* lse, int bn, int rows, int skv, int sq,
             int causal, float scale, float softcap, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, bn, rows, skv, sq, causal,
                           scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, bn, rows, skv, sq, causal,
                           scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, bn, rows, skv, sq, causal,
                            scale, softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  dtype:
// 0 = fp32, 1 = bf16 (q, k, v and out alike).  head_dim must be 32, 64 or
// 128; bn at most 65535; causal 0 or 1.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int bn, int rows, int skv, int sq,
                     int head_dim, int dtype, int causal, float scale,
                     float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_h<float>(head_dim, q, k, v, out, lse, bn, rows, skv, sq,
                           causal, scale, softcap, s);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(head_dim, q, k, v, out, lse, bn, rows, skv,
                                   sq, causal, scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

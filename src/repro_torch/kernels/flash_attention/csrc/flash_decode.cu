// Dense-cache flash-decode for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/flash_attention/kernel.py).
//
// Replaces the TPU kernel `_decode_kernel` (src/repro/kernels/flash_attention/
// kernel.py:132, launched by `flash_decode`, pallas_call at :187).  Same
// function: queries q (B, Sq, NQ, H) against a whole, unpaged K/V cache
// (B, S_cache, NKV, H); query head n*G + g reads KV head n (GQA by query
// grouping, G = NQ / NKV); scores scaled by H^-1/2, soft-capped as
// softcap * tanh(s / softcap); query c of row b attends to the keys
// t < lens[b, c]; fp32 online softmax and P.V; out (B, Sq, NQ, H) in q's
// dtype, normalized as acc / max(l, 1e-30), so a query with no valid key
// comes out all zero.  The TPU kernel takes one length a row (Sq = 1); the
// per-(row, query) length serves a prefill row too, where the reference's
// mask `t <= positions[b, c] && t < kv_valid[b]` is
// `t < min(positions[b, c] + 1, kv_valid[b])`.
//
// What bounds it: device memory.  Each valid K/V byte is read once per
// query slice (once in all for decode, where G <= 8); the operations are
// 4 * H per (query, key), far below the card's ratio of operations to
// bytes.  Design, simple first:
//  - one block per (row b, KV head n, slice of NR queries), NR = 1, 2, 4 or
//    8, the least power of two that holds the G * Sq queries of (b, n) (G
//    for decode) and at most 8.  NR is a template parameter, so the hot loop
//    has no branch on the query: behind a branch a query's shared loads and
//    FMA chain cannot overlap another's.  The
//    TPU's sequential kv grid axis becomes a loop inside the block, and the
//    block's 4 warps (2 for fp32 at H 128, to fit shared memory) split the
//    KV tiles among them: warp w takes tiles w, w + 4, ...  Each warp keeps
//    an fp32 online softmax (m, l, acc) of every query of the slice in
//    registers, and the warps' states are combined at the end in warp
//    order, so the bits do not depend on which warp finished first.
//  - the cache is read in place, by its batch and token strides; no copy
//    into a (B*NKV, S, H) layout.  A warp stages its 32-token K and V tiles
//    with 16-byte cp.async into a three-stage ring of its own, two tiles in
//    flight while one is computed; rows are padded by 16 bytes so a lane
//    reading its token's row as 16-byte vectors meets no bank conflict.
//    Tokens at or past the slice's longest length are never read
//    (zero-filled), so neither is the rest of the cache.
//  - lane t scores token t against every query of the slice (the query
//    rows sit in shared memory in fp32, two partial sums a query); the
//    tile's max and sum are warp reductions; in P.V lane l owns head dims
//    [l*H/32, (l+1)*H/32).
//  - fp32 and bf16 inputs; H is a template parameter (32, 64, 128).
// Known limits, later work: B*NKV blocks (64 at qwen3-1.7b's 8 slots) fill
// under half of the 132 SMs; a split of the KV range across blocks (with
// an ordered combine) would fill the card.  A prefill chunk's query slices
// each read the K/V again.  The math runs on CUDA cores, not tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;           // KV tokens per warp tile (one a lane)
constexpr int kMaxRows = 8;         // queries per block, at most
constexpr int kStages = 3;          // a warp's cp.async ring
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

template <int H, typename T, int NR>
struct Cfg {
  static constexpr int kRowBytes = H * static_cast<int>(sizeof(T));
  static constexpr int kLd = kRowBytes + 16;       // shared row stride, bytes
  static constexpr int kVec = kRowBytes / 16;      // 16-byte vectors a row
  static constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kWarps = kRowBytes > 256 ? 2 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kTileBytes = kTile * kLd;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kDpl = H / 32;              // head dims a lane owns
  static constexpr int kQBytes = NR * H * 4;
  static constexpr int kSmem = kQBytes + kWarps * kWarpBytes;
  static_assert(kWarps * NR * (H + 2) * 4 <= kWarps * kWarpBytes,
                "the combine buffers reuse the rings");
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// bf16 is the top half of an fp32: element 2i is the low half of word i
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 16 bytes of a K row -> fp32
__device__ __forceinline__ void unpack16(const unsigned char* p, float* o,
                                         float) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void unpack16(const unsigned char* p, float* o,
                                         __nv_bfloat16) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = bf16_lo(w[i]);
    o[2 * i + 1] = bf16_hi(w[i]);
  }
}

// N consecutive elements of a V row -> fp32 (N = H / 32: 1, 2 or 4)
template <int N>
__device__ __forceinline__ void load_dims(const unsigned char* p, float* o,
                                          float) {
  if constexpr (N == 4) {
    unpack16(p, o, 0.f);
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
    o[0] = *reinterpret_cast<const float*>(p);
  }
}
template <int N>
__device__ __forceinline__ void load_dims(const unsigned char* p, float* o,
                                          __nv_bfloat16) {
  if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    o[0] = bf16_lo(x.x);
    o[1] = bf16_hi(x.x);
    o[2] = bf16_lo(x.y);
    o[3] = bf16_hi(x.y);
  } else if constexpr (N == 2) {
    const unsigned x = *reinterpret_cast<const unsigned*>(p);
    o[0] = bf16_lo(x);
    o[1] = bf16_hi(x);
  } else {
    const unsigned x = *reinterpret_cast<const unsigned short*>(p);
    o[0] = bf16_lo(x);
  }
}

// 16 bytes global -> shared, asynchronous; `valid` false zero-fills
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int H, typename T, int NR>
__global__ void __launch_bounds__(Cfg<H, T, NR>::kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ lens,
                    T* __restrict__ out, int sq, int nkv, int group,
                    int s_cache, long long k_sb, long long k_st,
                    long long v_sb, long long v_st, float scale,
                    float softcap) {
  using C = Cfg<H, T, NR>;
  constexpr int D = C::kDpl;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);           // [NR][H]
  unsigned char* rings = smem + C::kQBytes;

  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int row0 = blockIdx.z * NR;
  const int rows = sq * group;                   // queries of this (b, n)
  const int nq = nkv * group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // each query's valid length, clamped to the cache (0 for a slot past the
  // last query: it attends to nothing and is not written); the longest
  int len[NR];
  int limit = 0;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int row = row0 + j;
    len[j] = row < rows
                 ? min(max(lens[(size_t)b * sq + row / group], 0), s_cache)
                 : 0;
    limit = max(limit, len[j]);
  }
  for (int i = threadIdx.x; i < NR * H; i += blockDim.x) {
    const int j = i / H, d = i % H;
    const int row = row0 + j;
    float x = 0.f;
    if (row < rows) {
      const int c = row / group, g = row % group;
      x = to_f32(q[(((size_t)b * sq + c) * nq + n * group + g) * H + d]);
    }
    q_s[i] = x;
  }
  __syncthreads();

  float m[NR], l[NR], acc[NR][D];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[j][i] = 0.f;
  }

  unsigned char* ring = rings + warp * C::kWarpBytes;
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + b * k_sb + (size_t)n * H);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + b * v_sb + (size_t)n * H);
  const long long k_tb = k_st * (long long)sizeof(T);   // token strides, bytes
  const long long v_tb = v_st * (long long)sizeof(T);
  auto fetch = [&](int tile, int stage) {
    unsigned char* ks = ring + stage * C::kStageBytes;
    unsigned char* vs = ks + C::kTileBytes;
    const int t0 = tile * kTile;
#pragma unroll
    for (int i = lane; i < kTile * C::kVec; i += 32) {
      const int t = i / C::kVec, c = i % C::kVec;
      const bool ok = t0 + t < limit;
      const long long tok = ok ? t0 + t : 0;
      cp_async16(ks + t * C::kLd + c * 16, kb + tok * k_tb + c * 16, ok);
      cp_async16(vs + t * C::kLd + c * 16, vb + tok * v_tb + c * 16, ok);
    }
  };

  // a ring of kStages tiles: kStages - 1 in flight while one is computed
  const int n_tiles = (limit + kTile - 1) / kTile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (warp + st * C::kWarps < n_tiles) fetch(warp + st * C::kWarps, st);
    cp_async_commit();
  }
  int it = 0;
  for (int tile = warp; tile < n_tiles; tile += C::kWarps, ++it) {
    const int ahead = tile + (kStages - 1) * C::kWarps;
    if (ahead < n_tiles) fetch(ahead, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this lane's copies of `tile` landed
    __syncwarp();                   // and every lane's
    const unsigned char* ks = ring + (it % kStages) * C::kStageBytes;
    const unsigned char* vs = ks + C::kTileBytes;
    const int tok = tile * kTile + lane;

    // scores: lane = token, every query of the slice against its K row
    float s[NR][2];
#pragma unroll
    for (int j = 0; j < NR; ++j) s[j][0] = s[j][1] = 0.f;
    const unsigned char* krow = ks + lane * C::kLd;
#pragma unroll
    for (int c = 0; c < C::kVec; ++c) {
      float kf[C::kPerVec];
      unpack16(krow + c * 16, kf, T());
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const float* qr = q_s + j * H + c * C::kPerVec;
#pragma unroll
        for (int e = 0; e < C::kPerVec; ++e) s[j][c & 1] += qr[e] * kf[e];
      }
    }
    // online softmax; p[j] is query j's probability of this lane's token
    float p[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const bool ok = tok < len[j];
      float x = (s[j][0] + s[j][1]) * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[j], warp_max(x));
      p[j] = ok ? expf(x - m_new) : 0.f;
      const float corr = expf(m[j] - m_new);
      l[j] = l[j] * corr + warp_sum(p[j]);
#pragma unroll
      for (int i = 0; i < D; ++i) acc[j][i] *= corr;
      m[j] = m_new;
    }
    // P.V: lane owns D consecutive head dims
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      float vf[D];
      load_dims<D>(vs + t * C::kLd + lane * D * (int)sizeof(T), vf, T());
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const float pt = __shfl_sync(kFull, p[j], t);
#pragma unroll
        for (int i = 0; i < D; ++i) acc[j][i] += pt * vf[i];
      }
    }
    __syncwarp();                   // the stage is consumed before reuse
  }
  cp_async_wait<0>();
  __syncthreads();                  // every warp is done with its ring

  // combine the warps' states in warp order (the rings' bytes reused)
  float* cm = reinterpret_cast<float*>(rings);           // [kWarps][NR]
  float* cl = cm + C::kWarps * NR;                        // [kWarps][NR]
  float* ca = cl + C::kWarps * NR;                        // [kWarps][NR][H]
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int w = warp * NR + j;
    if (lane == 0) {
      cm[w] = m[j];
      cl[w] = l[j];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) ca[w * H + lane * D + i] = acc[j][i];
  }
  __syncthreads();
  for (int j = warp; j < NR; j += C::kWarps) {
    const int row = row0 + j;
    if (row >= rows) continue;
    float mx = kNegInf;
    for (int w = 0; w < C::kWarps; ++w) mx = fmaxf(mx, cm[w * NR + j]);
    float lsum = 0.f, o[D];
#pragma unroll
    for (int i = 0; i < D; ++i) o[i] = 0.f;
    for (int w = 0; w < C::kWarps; ++w) {
      const int wj = w * NR + j;
      const float f = expf(cm[wj] - mx);
      lsum += cl[wj] * f;
#pragma unroll
      for (int i = 0; i < D; ++i) o[i] += ca[wj * H + lane * D + i] * f;
    }
    const float den = fmaxf(lsum, 1e-30f);
    const int c = row / group, g = row % group;
    T* dst = out + (((size_t)b * sq + c) * nq + n * group + g) * H + lane * D;
#pragma unroll
    for (int i = 0; i < D; ++i) store(dst + i, o[i] / den);
  }
}

template <int H, typename T, int NR>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, int B, int sq, int nkv, int group, int s_cache,
           long long k_sb, long long k_st, long long v_sb, long long v_st,
           float scale, float softcap, cudaStream_t stream) {
  using C = Cfg<H, T, NR>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<H, T, NR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = sq * group;
  const dim3 grid(B, nkv, (rows + NR - 1) / NR);
  flash_decode_kernel<H, T, NR><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lens),
      static_cast<T*>(out), sq, nkv, group, s_cache, k_sb, k_st, v_sb, v_st,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// the slice: the least power of two holding the queries of (b, n), <= 8
template <int H, typename T>
int launch_nr(const void* q, const void* k, const void* v, const void* lens,
              void* out, int B, int sq, int nkv, int group, int s_cache,
              long long k_sb, long long k_st, long long v_sb, long long v_st,
              float scale, float softcap, cudaStream_t s) {
  const int rows = sq * group;
  if (rows <= 1)
    return launch<H, T, 1>(q, k, v, lens, out, B, sq, nkv, group, s_cache,
                           k_sb, k_st, v_sb, v_st, scale, softcap, s);
  if (rows <= 2)
    return launch<H, T, 2>(q, k, v, lens, out, B, sq, nkv, group, s_cache,
                           k_sb, k_st, v_sb, v_st, scale, softcap, s);
  if (rows <= 4)
    return launch<H, T, 4>(q, k, v, lens, out, B, sq, nkv, group, s_cache,
                           k_sb, k_st, v_sb, v_st, scale, softcap, s);
  return launch<H, T, kMaxRows>(q, k, v, lens, out, B, sq, nkv, group,
                                s_cache, k_sb, k_st, v_sb, v_st, scale,
                                softcap, s);
}

template <typename T>
int launch_h(int head_dim, const void* q, const void* k, const void* v,
             const void* lens, void* out, int B, int sq, int nkv, int group,
             int s_cache, long long k_sb, long long k_st, long long v_sb,
             long long v_st, float scale, float softcap, cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return launch_nr<32, T>(q, k, v, lens, out, B, sq, nkv, group,
                              s_cache, k_sb, k_st, v_sb, v_st, scale, softcap,
                              s);
    case 64:
      return launch_nr<64, T>(q, k, v, lens, out, B, sq, nkv, group,
                              s_cache, k_sb, k_st, v_sb, v_st, scale, softcap,
                              s);
    case 128:
      return launch_nr<128, T>(q, k, v, lens, out, B, sq, nkv, group,
                               s_cache, k_sb, k_st, v_sb, v_st, scale,
                               softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  dtype:
// 0 = fp32, 1 = bf16 (q, k, v and out alike).  q (B, sq, nkv*group, H) and
// out contiguous; lens (B, sq) int32; k and v (B, s_cache, nkv, H) with the
// last two dimensions contiguous, batch and token strides k_sb, k_st, v_sb,
// v_st in elements (multiples of 16 bytes, 16-byte aligned base).
// head_dim must be 32, 64 or 128; nkv and ceil(sq*group/8) at most 65535
// (blocks hold fewer queries when sq*group < 8).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lens, void* out, int B, int sq, int nkv,
                        int group, int head_dim, int dtype, int s_cache,
                        long long k_sb, long long k_st, long long v_sb,
                        long long v_st, float scale, float softcap,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_h<float>(head_dim, q, k, v, lens, out, B, sq, nkv, group,
                           s_cache, k_sb, k_st, v_sb, v_st, scale, softcap, s);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(head_dim, q, k, v, lens, out, B, sq, nkv,
                                   group, s_cache, k_sb, k_st, v_sb, v_st,
                                   scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

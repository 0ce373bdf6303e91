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
// bytes.  Design:
//  - split-KV in a thread-block cluster.  Each (row b, KV head n, slice of
//    NR queries) has `splits` blocks (<= 8, a portable cluster, along grid
//    x), each over `tokens_per_split` consecutive tokens (whole 32-token
//    tiles) of the cache's capacity S_cache; the host plans the split from
//    shapes alone (kernel.decode_plan: as many splits as keep the grid
//    within one wave of one block an SM, its four warps one a scheduler:
//    the warps are issue-bound, so a second block on an SM adds no pull),
//    never from the lengths: no host sync.  A block whose range starts at or past
//    the slice's longest length reads nothing and holds the neutral partial
//    m = -1e30, l = 0, acc = 0.  After `cluster.sync()` the blocks fold
//    each other's (m, l, acc) out of distributed shared memory, each block
//    a share of the output elements, every element in rank (= token)
//    order, and write it normalized; a second sync keeps every block
//    resident while it is read.  The neutral partial adds exactly, so a
//    query with no valid key still comes out exactly 0, and a split count
//    that leaves every valid token in split 0 gives split 0's bits.
//  - NR = 1, 2, 4 or 8, the least power of two that holds the G * Sq
//    queries of (b, n) (G for decode) and at most 8, is a template
//    parameter, so the hot loop has no branch on the query: behind a branch
//    a query's shared loads and FMA chain cannot overlap another's.  The
//    TPU's sequential kv grid axis becomes a loop inside the block, and the
//    block's 4 warps (2 for fp32 at H 128, to fit shared memory) split the
//    split's KV tiles among them: warp w takes tiles w, w + 4, ...  Each
//    warp keeps an fp32 online softmax (m, l, acc) of every query of the
//    slice in registers, and the warps' states are combined at the end in
//    warp order, so the bits do not depend on which warp finished first.
//  - the cache is read in place, by its batch and token strides; no copy
//    into a (B*NKV, S, H) layout.  A warp stages its 32-token K and V tiles
//    with 16-byte cp.async into a three-stage ring of its own, two tiles in
//    flight while one is computed; rows are padded by 16 bytes so a lane
//    reading its token's row as 16-byte vectors meets no bank conflict.
//    Tokens at or past the slice's longest length are never read
//    (zero-filled), so neither is the rest of the cache.  The ring is kept
//    whole (208 KB at bf16 H 128: one block an SM, two by shared memory at
//    H 64): two blocks an SM would only share the same four schedulers.
//  - lane t scores token t against every query of the slice (the query
//    rows sit in shared memory in fp32, two partial sums a query); the
//    tile's max and sum are warp reductions; in P.V lane l owns head dims
//    [l*H/32, (l+1)*H/32).
//  - fp32 and bf16 inputs; H is a template parameter (32, 64, 128).
// Known limits, later work: a prefill chunk's query slices each read the
// K/V again (its grid is large, so it is not split); the math runs on CUDA
// cores, not tensor cores.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;           // KV tokens per warp tile (one a lane)
constexpr int kMaxRows = 8;         // queries per block, at most
constexpr int kStages = 3;          // a warp's cp.async ring
constexpr int kMaxSplits = 8;       // a portable cluster
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
  static constexpr int kPLd = H + 2;               // a partial: acc, m, l
  static_assert((kWarps + 1) * NR * kPLd * 4 <= kWarps * kWarpBytes,
                "the combine buffers and the partials reuse the rings");
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
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int H, typename T, int NR>
__global__ void __launch_bounds__(Cfg<H, T, NR>::kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ lens,
                    T* __restrict__ out, int sq, int nkv, int group,
                    int s_cache, long long k_sb, long long k_st,
                    long long v_sb, long long v_st, int splits,
                    int tokens_per_split, float scale, float softcap) {
  using C = Cfg<H, T, NR>;
  constexpr int D = C::kDpl;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);           // [NR][H]
  unsigned char* rings = smem + C::kQBytes;

  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / splits;
  const int split = splits > 1 ? static_cast<int>(cluster.block_rank()) : 0;
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
  // this split's tokens [start, end): whole tiles of the capacity, cut at
  // the slice's longest length
  const int start = split * tokens_per_split;
  const int end = min(start + tokens_per_split, limit);
  auto fetch = [&](int tile, int stage) {
    unsigned char* ks = ring + stage * C::kStageBytes;
    unsigned char* vs = ks + C::kTileBytes;
    const int t0 = start + tile * kTile;
#pragma unroll
    for (int i = lane; i < kTile * C::kVec; i += 32) {
      const int t = i / C::kVec, c = i % C::kVec;
      const bool ok = t0 + t < end;
      const long long tok = ok ? t0 + t : 0;
      cp_async16(ks + t * C::kLd + c * 16, kb + tok * k_tb + c * 16, ok);
      cp_async16(vs + t * C::kLd + c * 16, vb + tok * v_tb + c * 16, ok);
    }
  };

  // a ring of kStages tiles: kStages - 1 in flight while one is computed
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (warp + st * C::kWarps < n_tiles) fetch(warp + st * C::kWarps, st);
    cp_async_commit();
  }
  // the queries, while the first tiles are in flight
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
  int it = 0;
  for (int tile = warp; tile < n_tiles; tile += C::kWarps, ++it) {
    const int ahead = tile + (kStages - 1) * C::kWarps;
    if (ahead < n_tiles) fetch(ahead, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this lane's copies of `tile` landed
    __syncwarp();                   // and every lane's
    const unsigned char* ks = ring + (it % kStages) * C::kStageBytes;
    const unsigned char* vs = ks + C::kTileBytes;
    const int tok = start + tile * kTile + lane;

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
  // the block's partial of each query: unnormalized acc, m, l
  float* part = ca + C::kWarps * NR * H;                  // [NR][kPLd]
  for (int j = warp; j < NR; j += C::kWarps) {
    if (row0 + j >= rows) continue;
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
    float* pj = part + j * C::kPLd;
#pragma unroll
    for (int i = 0; i < D; ++i) pj[lane * D + i] = o[i];
    if (lane == 0) {
      pj[H] = mx;
      pj[H + 1] = lsum;
    }
  }

  // the cluster: its blocks fold the splits' partials, each a share of
  // the output elements, every element in rank (= token) order
  if (splits > 1)
    cluster.sync();
  else
    __syncthreads();
  for (int i = split * C::kThreads + threadIdx.x; i < NR * H;
       i += splits * C::kThreads) {
    const int j = i / H, d = i % H;
    const int row = row0 + j;
    if (row >= rows) continue;
    const int at = j * C::kPLd;
    float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {               // every load sent before any use
        const float* ps = splits > 1 ? cluster.map_shared_rank(part, s)
                                     : part;
        ms[s] = ps[at + H];
        ls[s] = ps[at + H + 1];
        as[s] = ps[at + d];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) mx = fmaxf(mx, ms[s]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        const float f = expf(ms[s] - mx);
        lsum += ls[s] * f;
        o += as[s] * f;
      }
    }
    const int c = row / group, g = row % group;
    store(out + (((size_t)b * sq + c) * nq + n * group + g) * H + d,
          o / fmaxf(lsum, 1e-30f));
  }
  if (splits > 1) cluster.sync();    // no block leaves while it is read
}

struct Args {
  const void *q, *k, *v, *lens;
  void* out;
  int B, sq, nkv, group, s_cache;
  long long k_sb, k_st, v_sb, v_st;
  int splits, tokens_per_split;
  float scale, softcap;
};

// cudaFuncSetAttribute once a kernel and device: the decode calls the
// kernel once a layer
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  // the SM's whole 228 KB as shared memory, so that the blocks the plan
  // counts on an SM fit there
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  done[dev] = err == cudaSuccess;
  return err;
}

template <int H, typename T, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<H, T, NR>;
  constexpr auto kernel = flash_decode_kernel<H, T, NR>;
  const cudaError_t set = allow_smem<kernel>(C::kSmem);
  if (set != cudaSuccess) return set;
  const int rows = a.sq * a.group;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B) * a.splits, a.nkv,
                     (rows + NR - 1) / NR);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.lens),
      static_cast<T*>(a.out), a.sq, a.nkv, a.group, a.s_cache, a.k_sb,
      a.k_st, a.v_sb, a.v_st, a.splits, a.tokens_per_split, a.scale,
      a.softcap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the slice: the least power of two holding the queries of (b, n), <= 8
constexpr int slice_rows(int rows) {
  return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : kMaxRows;
}

template <int H, typename T>
cudaError_t launch_nr(const Args& a, cudaStream_t s) {
  switch (slice_rows(a.sq * a.group)) {
    case 1: return launch<H, T, 1>(a, s);
    case 2: return launch<H, T, 2>(a, s);
    case 4: return launch<H, T, 4>(a, s);
    default: return launch<H, T, kMaxRows>(a, s);
  }
}

template <typename T>
cudaError_t launch_h(int head_dim, const Args& a, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_nr<32, T>(a, s);
    case 64: return launch_nr<64, T>(a, s);
    case 128: return launch_nr<128, T>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int H, typename T>
int smem_h(int nr) {
  return nr <= 1   ? Cfg<H, T, 1>::kSmem
         : nr <= 2 ? Cfg<H, T, 2>::kSmem
         : nr <= 4 ? Cfg<H, T, 4>::kSmem
                   : Cfg<H, T, kMaxRows>::kSmem;
}

template <typename T>
int smem_of(int head_dim, int nr) {
  switch (head_dim) {
    case 32: return smem_h<32, T>(nr);
    case 64: return smem_h<64, T>(nr);
    case 128: return smem_h<128, T>(nr);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block (dtype 0 fp32, 1 bf16; nr the slice's
// queries, a power of two <= 8): kernel.py's copy must agree.
int flash_decode_smem_bytes(int head_dim, int dtype, int nr) {
  if (dtype == 0) return smem_of<float>(head_dim, nr);
  if (dtype == 1) return smem_of<__nv_bfloat16>(head_dim, nr);
  return -1;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  dtype:
// 0 = fp32, 1 = bf16 (q, k, v and out alike).  q (B, sq, nkv*group, H) and
// out contiguous; lens (B, sq) int32; k and v (B, s_cache, nkv, H) with the
// last two dimensions contiguous, batch and token strides k_sb, k_st, v_sb,
// v_st in elements (multiples of 16 bytes, 16-byte aligned base).
// head_dim must be 32, 64 or 128; nkv and ceil(sq*group/8) at most 65535
// (blocks hold fewer queries when sq*group < 8).  `splits` (1..8) blocks a
// slice, a thread-block cluster, each over `tokens_per_split` tokens (a
// multiple of 32) of the cache.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lens, void* out, int B, int sq, int nkv,
                        int group, int head_dim, int dtype, int s_cache,
                        long long k_sb, long long k_st, long long v_sb,
                        long long v_st, int splits, int tokens_per_split,
                        float scale, float softcap, void* stream) {
  if (splits < 1 || splits > kMaxSplits || tokens_per_split <= 0 ||
      tokens_per_split % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q,    k,    v,    lens, out,  B,      sq,
               nkv,  group, s_cache, k_sb, k_st, v_sb, v_st,
               splits, tokens_per_split, scale, softcap};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_h<float>(head_dim, a, s);
  if (dtype == 1) err = launch_h<__nv_bfloat16>(head_dim, a, s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

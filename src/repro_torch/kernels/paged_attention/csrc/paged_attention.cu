// Paged flash-decode partials for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/paged_attention/kernel.py).
//
// Replaces the TPU kernel `_paged_kernel` (src/repro/kernels/paged_attention/
// kernel.py:40, launched by `paged_flash_decode`).  Same function: grouped
// queries qg (B, NKV, R = G*Sq, H), row r being query column r % Sq at
// position pos0[b] + r % Sq; a K/V page pool (P, page, NKV, H) in bf16 or
// fp32; page_idx (B, pps) int32 in any page map; and the ragged mask
// `t <= pos0 + c && t < kv_valid`.  Out: fp32 partials acc (B, NKV, R, H),
// m and l (B, NKV, R), to be normalized as acc / max(l, 1e-30).
//
// What bounds it: the K/V bytes of the valid tokens, read once per row
// block (granite's 8-slot decode: 2.9 MB, 0.9 us at 3.35 TB/s).  At decode
// sizes nothing near that is reachable: a launch is a few microseconds, and
// what is left of the time is the chain of dependent steps in the longest
// block (a page id, then its K/V, then the scores).  Design:
//  - split-KV in a thread-block cluster.  Each (b, kv_head, row slice) has
//    `splits` blocks (<= 8, a portable cluster, along grid x), each owning
//    `tokens_per_split` consecutive tokens of the table's capacity (the host
//    plans it from pps * page, never from kv_valid: no host sync).  A block
//    whose range starts at or past its row's kv_valid reads nothing and
//    holds the neutral partial m = -1e30, l = 0, acc = 0.  After
//    `cluster.sync()` the blocks read each other's (m, l, acc) out of
//    shared memory, each block a share of the elements, and combine every
//    element in rank (= token) order; a second sync keeps every block
//    resident while it is read.  One launch, no workspace, no atomics;
//    the order is fixed, so the bits repeat.
//  - inside a block, 4 warps of 32 lanes; lane t scores token t of its
//    warp's 32-token tile for the warp's RW (2 or 4) query rows.  KW warps
//    share a row group and take different tiles of a stage (KW = 4: the
//    decode, where a (b, kv_head) has R <= 4 rows; KW = 1: a prefill
//    chunk's 16-row slices, every warp on the same tile); the KW warps'
//    partials are merged in warp order before the cluster merge.
//  - a stage (32 * KW tokens of K and V, in the pool's dtype) comes into
//    shared memory by 16-byte cp.async, double-buffered; a thread copies
//    one token's chunks, so it needs one page id a stage: the first two
//    are read with kv_valid (within the table's capacity, not waiting for
//    it), later ones a stage ahead, while the current one is computed.  Tokens
//    past the block's range are zero-filled and never read from the pool.
//  - scores: a lane reads its K row as 16-byte vectors (row pitch padded
//    by 16 bytes: no bank conflicts) and the queries as broadcast float4s.
//    The tile's max is a warp reduction a row; the sum l stays a per-lane
//    partial until the end.  P goes through shared memory and P.V runs
//    with lane d owning head dims H/32 * d ... H/32 * d + H/32 - 1.
//  - masked scores contribute exactly 0 to l and acc; a kv_valid == 0 row
//    returns acc = 0, l = 0, m = -1e30, with no NaN.
// Known limits, later work: the math runs on the CUDA cores, not the tensor
// cores; a prefill chunk's row slices each read the K/V again (from L2).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;           // KV tokens a warp scores at once
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;          // cp.async ring depth
constexpr int kMaxSplits = 8;       // a portable cluster
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxSmem = 227 * 1024;  // what one block may use

// Dynamic shared memory of a block: the ring of stages or, after the loop,
// the partials it then holds; the queries; P.  kernel.py keeps a copy.
constexpr int smem_bytes(int H, int elem, int kw, int rw) {
  const int ring = kStages * kTile * kw * (2 * H + 16 / elem) * elem;
  const int part = (kWarps * rw + kWarps / kw * rw) * (H + 2) * 4;
  return (ring > part ? ring : part) + kWarps / kw * rw * H * 4 +
         kWarps * rw * kTile * 4;
}

// H head dims, KV the pool's dtype, KW warps sharing a row group (taking
// different tiles of a stage), RW query rows a warp
template <int H, typename KV, int KW, int RW>
struct Cfg {
  static constexpr int kElem = sizeof(KV);
  static constexpr int kVE = 16 / kElem;             // elements a 16-byte chunk
  static constexpr int kChunks = H / kVE;            // chunks a token row
  static constexpr int kKLd = H + kVE;               // K row pitch: +16 bytes
  static constexpr int kStageTok = kTile * KW;       // tokens a stage
  static constexpr int kTPT = kThreads / kStageTok;  // threads a token
  static constexpr int kCPT = kChunks / kTPT;        // chunks a thread copies
  static constexpr int kRows = kWarps / KW * RW;     // query rows a block
  static constexpr int kE = H / 32;                  // head dims a lane in P.V
  static constexpr int kPLd = H + 2;                 // a partial: acc, m, l
  static constexpr int kStageBytes = kStageTok * (kKLd + H) * kElem;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kPartBytes = (kWarps * RW + kRows) * kPLd * 4;
  static constexpr int kQOffset =
      kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
  static constexpr int kSmem = smem_bytes(H, kElem, KW, RW);
  static_assert(kTPT * kStageTok == kThreads && kCPT * kTPT == kChunks,
                "a stage's chunks must split evenly among the threads");
  static_assert(kSmem <= kMaxSmem, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of K -> fp32: 4 floats, or 8 bf16 (the top half of an fp32)
__device__ __forceinline__ void unpack(const uint4& u, float* o, float) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* o,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// E consecutive elements of a V row (4 to 16 bytes) -> fp32
template <int E>
__device__ __forceinline__ void load_v(const float* p, float* o) {
  if constexpr (E == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}
template <int E>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* o) {
  if constexpr (E == 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    o[0] = __uint_as_float(w.x << 16);
    o[1] = __uint_as_float(w.x & 0xffff0000u);
    o[2] = __uint_as_float(w.y << 16);
    o[3] = __uint_as_float(w.y & 0xffff0000u);
  }
}

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

template <int H, typename KV, int KW, int RW>
__global__ void __launch_bounds__(kThreads)
paged_partials_kernel(const float* __restrict__ qg,
                      const KV* __restrict__ k_pages,
                      const KV* __restrict__ v_pages,
                      const int32_t* __restrict__ page_idx,
                      const int32_t* __restrict__ pos0,
                      const int32_t* __restrict__ kv_valid,
                      float* __restrict__ acc_out,
                      float* __restrict__ m_out,
                      float* __restrict__ l_out,
                      int nkv, int rows, int sq, int page_size, int pps,
                      int tokens_per_split, float scale, float softcap) {
  using C = Cfg<H, KV, KW, RW>;
  constexpr int E = C::kE;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + C::kQOffset);
  float* p_s = q_s + C::kRows * H;                  // [warp][RW][kTile]

  const int split = blockIdx.x;                     // = the cluster rank
  const int bn = blockIdx.y;                        // b * nkv + kv head
  const int b = bn / nkv, n = bn % nkv;
  const int row0 = blockIdx.z * C::kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp / KW, kw = warp % KW;        // row group, tile of a stage
  const int p0 = pos0[b];
  const int cap = pps * page_size;
  const int start = split * tokens_per_split;
  const int cap_end = min(start + tokens_per_split, cap);
  const int end = min(cap_end, max(kv_valid[b], 0));
  const int32_t* pages = page_idx + static_cast<size_t>(b) * pps;

  for (int i = tid; i < C::kRows * H; i += kThreads) {
    const int row = row0 + i / H;
    q_s[i] = row < rows ? qg[(static_cast<size_t>(bn) * rows + row) * H +
                             i % H]
                        : 0.f;
  }

  float m[RW], l[RW], acc[RW][E];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;                       // this lane's tokens' share
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  }

  // the copy: thread tid owns chunks [cb, cb + kCPT) of stage token tt
  const int tt = tid / C::kTPT, cb = (tid % C::kTPT) * C::kCPT;
  // a stage's page id: read within the table's capacity without waiting
  // for kv_valid (an id past kv_valid is read but never followed)
  auto page_of = [&](int st) {
    const int tok = start + st * C::kStageTok + tt;
    return tok < cap_end ? pages[tok / page_size] : 0;
  };
  auto copy_stage = [&](int st, int page) {
    const int tok = start + st * C::kStageTok + tt;
    KV* ks = reinterpret_cast<KV*>(smem + (st % kStages) * C::kStageBytes);
    KV* vs = ks + C::kStageTok * C::kKLd;
    const bool in = tok < end;
    const size_t off =
        in ? ((static_cast<size_t>(page) * page_size + tok % page_size) *
                  nkv + n) * H
           : 0;
#pragma unroll
    for (int c = 0; c < C::kCPT; ++c) {
      const int e0 = (cb + c) * C::kVE;
      cp_async16(smem_u32(ks + tt * C::kKLd + e0), k_pages + off + e0,
                 in ? 16 : 0);
      cp_async16(smem_u32(vs + tt * H + e0), v_pages + off + e0,
                 in ? 16 : 0);
    }
  };

  const int n_st = end > start ? (end - start + C::kStageTok - 1) /
                                     C::kStageTok
                               : 0;
  const int page0 = page_of(0);
  int page_next = page_of(1);
  if (n_st > 0) copy_stage(0, page0);
  cp_async_commit();
  float* pw = p_s + warp * RW * kTile;
  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) copy_stage(st + 1, page_next);
    cp_async_commit();
    if (st + 2 < n_st) page_next = page_of(st + 2);  // used next iteration
    cp_async_wait<1>();
    __syncthreads();                 // stage st has landed (and q_s is in)

    const KV* ks = reinterpret_cast<const KV*>(
        smem + (st % kStages) * C::kStageBytes) + kw * kTile * C::kKLd;
    const KV* vs = reinterpret_cast<const KV*>(
        smem + (st % kStages) * C::kStageBytes) +
        C::kStageTok * C::kKLd + kw * kTile * H;
    const int tok = start + st * C::kStageTok + kw * kTile + lane;

    float dot[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) dot[j] = 0.f;
    const KV* krow = ks + lane * C::kKLd;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      float kf[C::kVE];
      unpack(*reinterpret_cast<const uint4*>(krow + c * C::kVE), kf, KV());
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const float* q = q_s + (rg * RW + j) * H + c * C::kVE;
#pragma unroll
        for (int e4 = 0; e4 < C::kVE; e4 += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(q + e4);
          dot[j] = fmaf(qv.x, kf[e4], dot[j]);
          dot[j] = fmaf(qv.y, kf[e4 + 1], dot[j]);
          dot[j] = fmaf(qv.z, kf[e4 + 2], dot[j]);
          dot[j] = fmaf(qv.w, kf[e4 + 3], dot[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int row = row0 + rg * RW + j;
      const bool ok = row < rows && tok < end && tok <= p0 + row % sq;
      float s = kNegInf;
      if (ok) {
        s = dot[j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      const float m_new = fmaxf(m[j], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[j] - m_new);
      l[j] = l[j] * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= corr;
      m[j] = m_new;
      pw[j * kTile + lane] = p;
    }
    __syncwarp();
#pragma unroll 2
    for (int t = 0; t < kTile; t += 4) {
      float4 pt[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j)
        pt[j] = *reinterpret_cast<const float4*>(pw + j * kTile + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[E];
        load_v<E>(vs + (t + u) * H + lane * E, v);
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const float pj = u == 0 ? pt[j].x : u == 1 ? pt[j].y
                         : u == 2 ? pt[j].z : pt[j].w;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] = fmaf(pj, v[e], acc[j][e]);
        }
      }
    }
    __syncthreads();                 // stage st consumed: its buffer is free
  }
  cp_async_wait<0>();

  // the warps' partials, then (KW > 1) the row group's, in warp order
  float* wpart = reinterpret_cast<float*>(smem);    // [warp * RW + j][kPLd]
  float* part = KW == 1 ? wpart : wpart + kWarps * RW * C::kPLd;
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    float* o = wpart + (warp * RW + j) * C::kPLd;
    const float lj = warp_sum(l[j]);
#pragma unroll
    for (int e = 0; e < E; ++e) o[lane * E + e] = acc[j][e];
    if (lane == 0) {
      o[H] = m[j];
      o[H + 1] = lj;
    }
  }
  __syncthreads();
  if constexpr (KW > 1) {
    for (int i = tid; i < C::kRows * C::kPLd; i += kThreads) {
      const int r = i / C::kPLd, d = i % C::kPLd;
      const int g = r / RW, j = r % RW;
      const float* w0 = wpart + ((g * KW) * RW + j) * C::kPLd;
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < KW; ++k) mx = fmaxf(mx, w0[k * RW * C::kPLd + H]);
      float v = mx;
      if (d != H) {
        v = 0.f;
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const float* wk = w0 + k * RW * C::kPLd;
          v += wk[d] * expf(wk[H] - mx);
        }
      }
      part[i] = v;
    }
    __syncthreads();
  }

  // the cluster: its blocks fold the splits' partials, each a share of
  // the elements, every element in rank (= token) order
  const bool clustered = gridDim.x > 1;
  cg::cluster_group cluster = cg::this_cluster();
  if (clustered) cluster.sync();
  const int n_split = gridDim.x;
  for (int i = split * kThreads + tid; i < C::kRows * C::kPLd;
       i += n_split * kThreads) {
    const int r = i / C::kPLd, d = i % C::kPLd;
    const int row = row0 + r;
    if (row >= rows) continue;
    float v = part[i];
    if (clustered) {
      const int m_at = r * C::kPLd + H;
      float ms[kMaxSplits], vs[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < n_split) {              // every load sent before any use
          const float* ps = cluster.map_shared_rank(part, s);
          ms[s] = ps[m_at];
          vs[s] = ps[i];
        }
      }
      float mx = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < n_split) mx = fmaxf(mx, ms[s]);
      v = mx;
      if (d != H) {
        v = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s)
          if (s < n_split) v += vs[s] * expf(ms[s] - mx);
      }
    }
    const size_t o = static_cast<size_t>(bn) * rows + row;
    if (d < H)
      acc_out[o * H + d] = v;
    else if (d == H)
      m_out[o] = v;
    else
      l_out[o] = v;
  }
  if (clustered) cluster.sync();     // no block leaves while it is read
}

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
  done[dev] = err == cudaSuccess;
  return err;
}

struct Args {
  const void *qg, *k, *v, *idx, *pos0, *valid;
  void *acc, *m, *l;
  int B, nkv, rows, sq, page_size, pps, splits, tokens_per_split;
  float scale, softcap;
};

template <int H, typename KV, int KW, int RW>
cudaError_t launch(const Args& a, cudaStream_t s) {
  using C = Cfg<H, KV, KW, RW>;
  constexpr auto kernel = paged_partials_kernel<H, KV, KW, RW>;
  const cudaError_t set = allow_smem<kernel>(C::kSmem);
  if (set != cudaSuccess) return set;
  const long long bn = static_cast<long long>(a.B) * a.nkv;
  const int slices = (a.rows + C::kRows - 1) / C::kRows;
  if (bn > 65535 || slices > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, static_cast<unsigned>(bn), slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(a.qg),
      static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const int32_t*>(a.idx), static_cast<const int32_t*>(a.pos0),
      static_cast<const int32_t*>(a.valid), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.nkv, a.rows, a.sq,
      a.page_size, a.pps, a.tokens_per_split, a.scale, a.softcap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// a mode whose stages fit in a block's shared memory (4 KV warps do not
// at fp32 H 128)
template <int H, typename KV, int KW, int RW>
cudaError_t launch_if_fits(const Args& a, cudaStream_t s) {
  if constexpr (smem_bytes(H, sizeof(KV), KW, RW) <= kMaxSmem)
    return launch<H, KV, KW, RW>(a, s);
  else
    return cudaErrorInvalidValue;
}

// the block modes (KV warps, rows a warp) of kernel.py's MODES
template <int H, typename KV>
cudaError_t launch_mode(int kw, int rw, const Args& a, cudaStream_t s) {
  if (kw == 4 && rw == 2) return launch_if_fits<H, KV, 4, 2>(a, s);
  if (kw == 4 && rw == 4) return launch_if_fits<H, KV, 4, 4>(a, s);
  if (kw == 2 && rw == 4) return launch_if_fits<H, KV, 2, 4>(a, s);
  if (kw == 1 && rw == 4) return launch_if_fits<H, KV, 1, 4>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block in a mode, kv_bytes 2 (bf16) or 4
// (fp32): kernel.py's copy must agree.
long long paged_partials_smem_bytes(int head_dim, int kv_bytes, int kw,
                                    int rw) {
  return smem_bytes(head_dim, kv_bytes, kw, rw);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  kv_dtype:
// 0 = fp32 pool, 1 = bf16 pool.  head_dim must be 64 or 128, and the pools
// 16-byte aligned.  `splits` (1..8) blocks a row slice, each over
// `tokens_per_split` tokens (a multiple of 32); (kw, rw) the block mode.
int paged_partials_launch(const void* qg, const void* k_pages,
                          const void* v_pages, const void* page_idx,
                          const void* pos0, const void* kv_valid, void* acc,
                          void* m, void* l, int B, int nkv, int rows, int sq,
                          int head_dim, int page_size, int pps, int kv_dtype,
                          int splits, int tokens_per_split, int kw, int rw,
                          float scale, float softcap, void* stream) {
  if (splits < 1 || splits > kMaxSplits || tokens_per_split <= 0 ||
      tokens_per_split % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{qg,   k_pages, v_pages, page_idx,  pos0,  kv_valid,
               acc,  m,       l,       B,         nkv,   rows,
               sq,   page_size, pps,   splits,    tokens_per_split,
               scale, softcap};
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64 && kv_dtype == 1)
    err = launch_mode<64, __nv_bfloat16>(kw, rw, a, s);
  else if (head_dim == 128 && kv_dtype == 1)
    err = launch_mode<128, __nv_bfloat16>(kw, rw, a, s);
  else if (head_dim == 64 && kv_dtype == 0)
    err = launch_mode<64, float>(kw, rw, a, s);
  else if (head_dim == 128 && kv_dtype == 0)
    err = launch_mode<128, float>(kw, rw, a, s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Paged flash-decode partials for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/paged_attention/kernel.py).
//
// Replaces the TPU kernel `_paged_kernel` (src/repro/kernels/paged_attention/
// kernel.py, launched by `paged_flash_decode`).  Same function: grouped
// queries qg (B, NKV, R = G*Sq, H), row r being query column r % Sq at
// position pos0[b] + r % Sq; a K/V page pool (P, page, NKV, H) in bf16 or
// fp32; page_idx (B, pps) int32 in any page map; and the ragged mask
// `t <= pos0 + c && t < kv_valid`.  Out: fp32 partials acc (B, NKV, R, H),
// m and l (B, NKV, R), to be normalized as acc / max(l, 1e-30).
//
// What bounds it: the K/V bytes of the valid tokens, read once per row
// block.  Design:
//  - one block per (b, kv_head, 16-row slice of R).  The loop over KV tiles
//    inside the block replaces the TPU's sequential grid axis; online
//    softmax state (m, l, acc) lives in registers across tiles.
//  - a tile is 32 tokens (one per lane), staged in shared memory as fp32.
//    The block loads page ids itself (no scalar prefetch): any page map.
//    Tokens at or past kv_valid are never read, so neither are their pages.
//    Each thread loads its share of a tile as independent 16-byte vectors
//    into registers one tile ahead, so the next tile's loads are in flight
//    while the current one is computed.
//  - every query row of the slice shares the staged tile: GQA costs no K/V
//    copy.  A warp owns up to 4 rows; per row, lane t scores token t
//    (K stride H+1 in shared memory: no bank conflicts), the tile's max and
//    sum are two warp reductions, and P.V runs with lane d owning head dims
//    d, d+32, ...
//  - masked scores contribute exactly 0 to l and acc; a kv_valid == 0 row
//    returns acc = 0, l = 0, m = -1e30, with no NaN.
// Known limits, later work: B*NKV blocks (64 at 8 slots for decode) fill
// under half of the 132 SMs, so split-KV (partials over KV ranges, combined
// after) is the next step; a prefill chunk's row slices each reload the
// K/V; loads are register-staged, not TMA; the math runs on CUDA cores,
// not tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;           // KV tokens per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of K or V -> fp32: 4 floats, or 8 bf16 (the top half of an fp32)
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

template <int H, typename KV>
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
                      float scale, float softcap) {
  constexpr int D = H / 32;  // head dims per lane in P.V
  constexpr int VE = 16 / sizeof(KV);          // elements per 16-byte vector
  constexpr int VPT = H / VE;                  // vectors per token row
  constexpr int PT = kTile * VPT / kThreads;   // vectors per thread per tile
  static_assert(PT * kThreads == kTile * VPT, "tile must split evenly");
  __shared__ float k_s[kTile][H + 1];
  __shared__ float v_s[kTile][H];
  __shared__ float q_s[kRowsPerBlock][H];

  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bn = (size_t)b * nkv + n;
  const int p0 = pos0[b];
  const int limit = min(kv_valid[b], pps * page_size);
  const int32_t* pages = page_idx + (size_t)b * pps;

  for (int i = threadIdx.x; i < kRowsPerBlock * H; i += blockDim.x) {
    const int r = i / H, d = i % H;
    const int row = row0 + r;
    q_s[r][d] = row < rows ? qg[(bn * rows + row) * H + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][D];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[j][i] = 0.f;
  }

  // register staging of one tile: thread-owned vectors of K and V
  uint4 kr[PT], vr[PT];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int vec = threadIdx.x + j * kThreads;
      const int tok = t0 + vec / VPT;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (tok < limit) {
        const int page = pages[tok / page_size];
        const size_t off =
            (((size_t)page * page_size + tok % page_size) * nkv + n) * H +
            (vec % VPT) * VE;
        kr[j] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[j] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int vec = threadIdx.x + j * kThreads;
      const int t = vec / VPT, d0 = (vec % VPT) * VE;
      float kf[VE], vf[VE];
      unpack(kr[j], kf, KV());
      unpack(vr[j], vf, KV());
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        k_s[t][d0 + e] = kf[e];
        v_s[t][d0 + e] = vf[e];
      }
    }
  };

  if (limit > 0) load(0);
  for (int t0 = 0; t0 < limit; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    store();
    __syncthreads();
    if (t0 + kTile < limit) load(t0 + kTile);  // in flight during compute

    const int tok = t0 + lane;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;  // block-local row, warp-uniform
      const int row = row0 + r;
      if (row < rows) {
        const bool ok = tok < limit && tok <= p0 + row % sq;
        float s = kNegInf;
        if (ok) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < H; ++d) dot += q_s[r][d] * k_s[lane][d];
          s = dot * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        }
        const float m_new = fmaxf(m[j], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m[j] - m_new);
        l[j] = l[j] * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < D; ++i) acc[j][i] *= corr;
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) {
          const float pt = __shfl_sync(kFull, p, t);
#pragma unroll
          for (int i = 0; i < D; ++i) acc[j][i] += pt * v_s[t][lane + 32 * i];
        }
        m[j] = m_new;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = row0 + warp + j * kWarps;
    if (row < rows) {
      const size_t o = bn * rows + row;
#pragma unroll
      for (int i = 0; i < D; ++i) acc_out[o * H + lane + 32 * i] = acc[j][i];
      if (lane == 0) {
        m_out[o] = m[j];
        l_out[o] = l[j];
      }
    }
  }
}

template <int H, typename KV>
void launch(const void* qg, const void* k, const void* v, const void* idx,
            const void* pos0, const void* valid, void* acc, void* m, void* l,
            int B, int nkv, int rows, int sq, int page_size, int pps,
            float scale, float softcap, cudaStream_t stream) {
  const dim3 grid(B, nkv, (rows + kRowsPerBlock - 1) / kRowsPerBlock);
  paged_partials_kernel<H, KV><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(qg), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(pos0), static_cast<const int32_t*>(valid),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      nkv, rows, sq, page_size, pps, scale, softcap);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  kv_dtype:
// 0 = fp32 pool, 1 = bf16 pool.  head_dim must be 64 or 128, and the pools
// 16-byte aligned.
int paged_partials_launch(const void* qg, const void* k_pages,
                          const void* v_pages, const void* page_idx,
                          const void* pos0, const void* kv_valid, void* acc,
                          void* m, void* l, int B, int nkv, int rows, int sq,
                          int head_dim, int page_size, int pps, int kv_dtype,
                          float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 && kv_dtype == 1) {
    launch<64, __nv_bfloat16>(qg, k_pages, v_pages, page_idx, pos0, kv_valid,
                              acc, m, l, B, nkv, rows, sq, page_size, pps,
                              scale, softcap, s);
  } else if (head_dim == 128 && kv_dtype == 1) {
    launch<128, __nv_bfloat16>(qg, k_pages, v_pages, page_idx, pos0, kv_valid,
                               acc, m, l, B, nkv, rows, sq, page_size, pps,
                               scale, softcap, s);
  } else if (head_dim == 64 && kv_dtype == 0) {
    launch<64, float>(qg, k_pages, v_pages, page_idx, pos0, kv_valid, acc, m,
                      l, B, nkv, rows, sq, page_size, pps, scale, softcap, s);
  } else if (head_dim == 128 && kv_dtype == 0) {
    launch<128, float>(qg, k_pages, v_pages, page_idx, pos0, kv_valid, acc, m,
                       l, B, nkv, rows, sq, page_size, pps, scale, softcap, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// once per query tile.  Two paths, chosen by dtype (kernel.fwd_plan names
// them; the host plan and this file compute the same tiles and reach):
//
// bf16: the tensor cores (`flash_fwd_tc`).
//  - one block of 4 warps per (128-row query tile, bn); warp w owns query
//    rows 32 w .. 32 w + 31 of the tile, two 16-row mma tiles that share
//    each K and V fragment (8 warps of 16 rows, which read twice the
//    shared memory, ran no faster on the card).  A loop over 64-row KV
//    tiles replaces the TPU's sequential kv grid axis.
//  - S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32 accumulators): the
//    products are exact in fp32, so it multiplies exactly what the TPU
//    kernel multiplies; only the order of the sums differs.  Q stays in
//    shared memory and K's fragments come by ldmatrix.
//  - the online softmax runs on the accumulator fragment in fp32: a row's
//    max and sum over the four lanes of a quad (xor shuffles), ex2 with
//    log2(e) folded in; the running sum l stays a per-lane partial until
//    the end.
//  - P.V with fp32-grade P: the S fragment's layout is the next mma's A
//    layout, so P is split in registers into p_hi = bf16(p) and p_lo =
//    bf16(p - p_hi) and O += P_hi V + P_lo V (V's fragments by
//    ldmatrix.trans).  One rounding of P to bf16 (what SDPA does) fails the
//    reference's tolerance; the split costs one more P.V product.
//  - K/V tiles double-buffered by cp.async (tile t + 1 in flight while t
//    is computed), rows stored as 16-byte chunks XOR-swizzled by row, so
//    ldmatrix's eight rows meet eight different bank groups with no
//    padding.  H 128: 32 KB of Q and 64 KB of K/V and up to 255 registers
//    a thread, two blocks an SM.
//  - causal block skip: a block stops at the last KV tile its largest
//    query position reaches.  With grouped rows a tile can wrap from the
//    end of one query head to the start of the next, so that position is
//    (last row) % sq_real when the tile does not wrap and sq_real - 1 when
//    it does.  A warp skips the tiles wholly above its own rows and
//    computes the mask only on the tiles that cross its diagonal, the Skv
//    edge or a head wrap.  Blocks are issued heaviest first (the query
//    tiles furthest down their heads; `block_tile`), so the longest start
//    first.  No atomics, no split-KV: the same inputs give the same bits.
//
// fp32: the CUDA cores (`flash_fwd_simt`), kept as it was: TF32 would miss
// the fp32 tolerance.  One block per (64-row query tile, bn), 256 threads;
// the tiles are staged in shared memory (Q and K at row stride H + 1); each
// thread computes a 4 x 4 register tile of scores and a 4 x (H / 16) tile
// of the output; the probabilities go through shared memory to P.V.  Same
// block skip and order, at 64-row tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// KV tiles a query tile of rows r0 .. min(r0 + bq, rows) - 1 visits: all of
// them, or causally up to the tile of the largest query position it holds
// (sq - 1 if the tile wraps into the next query head).  kernel.fwd_plan
// computes the same.
__device__ __forceinline__ int kv_tiles(int r0, int bq, int bkv, int rows,
                                        int skv, int sq, int causal) {
  int n = (skv + bkv - 1) / bkv;
  if (causal) {
    const int r_last = min(r0 + bq, rows) - 1;
    const int reach = r0 / sq == r_last / sq ? r_last % sq : sq - 1;
    n = min(n, reach / bkv + 1);
  }
  return n;
}

// The (bn, first query row) of block L of the 1-D grid, heaviest first.
// When sq is a multiple of the tile, tile i of each query head reaches as
// far as tile i of any other head and bn: the blocks go by i from the last,
// every (bn, head) at each i.  Otherwise tiles straddle heads, and the
// tiles go from the last, every bn at each.  kernel.fwd_plan lists the same.
__device__ __forceinline__ void block_tile(int L, int bq, int n_bn, int rows,
                                           int sq, size_t& bn, int& r0) {
  if (sq % bq == 0) {
    const int tph = sq / bq, heads = rows / sq, per = n_bn * heads;
    const int i = tph - 1 - L / per, rem = L % per;
    bn = rem / heads;
    r0 = ((rem % heads) * tph + i) * bq;
  } else {
    bn = L % n_bn;
    r0 = ((rows + bq - 1) / bq - 1 - L / n_bn) * bq;
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBKV = 64;            // KV rows per tile
constexpr int kRowsPerThread = kBQ / 16;
constexpr int kColsPerThread = kBKV / 16;
constexpr int kPLd = kBKV + 1;      // row stride of the probability tile

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

template <int H>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int n_bn, int rows, int skv, int sq,
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
  size_t bn;
  int r0;
  block_tile(blockIdx.x, kBQ, n_bn, rows, sq, bn, r0);
  const float* qb = q + bn * rows * H;
  const float* kb = k + bn * skv * H;
  const float* vb = v + bn * skv * H;

  for (int e = tid; e < kBQ * H; e += kThreads) {
    const int r = e / H, c = e % H;
    qs[r * kLd + c] = r0 + r < rows ? qb[size_t(r0 + r) * H + c] : 0.0f;
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

  const int n_tiles = kv_tiles(r0, kBQ, kBKV, rows, skv, sq, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();    // the last tile's readers are done (and Q is staged)
    for (int e = tid; e < kBKV * H; e += kThreads) {
      const int r = e / H, c = e % H;
      const bool in = kv0 + r < skv;
      const size_t g = size_t(kv0 + r) * H + c;
      ks[r * kLd + c] = in ? kb[g] : 0.0f;
      vs[r * H + c] = in ? vb[g] : 0.0f;
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
    for (int c = 0; c < kOut; ++c) out[o * H + tx + 16 * c] = acc[i][c] / denom;
    if (tx == 0) lse[o] = m[i] + logf(denom);
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;            // query rows per block
constexpr int kBKV = 64;            // KV rows per tile
constexpr int kMT = 2;              // 16-row mma tiles a warp
constexpr int kTcThreads = kBQ / (16 * kMT) * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int H>
constexpr int smem_bytes() {        // Q, then two K and two V tiles
  return 2 * H * (kBQ + 4 * kBKV);
}

// byte offset of 16-byte chunk c of row r in a tile of H-wide bf16 rows:
// the chunk index XORed with the row, so the eight rows an ldmatrix reads
// (8 consecutive, at one logical chunk) meet eight different 16-byte bank
// groups.  H 32 has four chunks a row, two rows a 128-byte line.
template <int H>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (H >= 64)
    return uint32_t(r * (2 * H) + ((c ^ (r & 7)) << 4));
  else
    return uint32_t(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; `src_bytes` 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a (16 x 16, row) b (16 x 8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// (a, b) as bf16x2 (a in the low half) in hi, and what rounding left in lo
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

template <int H>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
             int n_bn, int rows, int skv, int sq, int causal, float scale,
             float softcap) {
  constexpr int kChunks = H / 8;     // 16-byte chunks a row
  constexpr int kSteps = H / 16;     // k steps of Q K^T
  constexpr int kNO = H / 8;         // output n-tiles of 8 columns
  constexpr int kNS = kBKV / 8;      // score n-tiles
  constexpr uint32_t kTile = 2 * H * kBKV;   // bytes of a K or V tile
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t s_q = smem_u32(smem_tc);
  const uint32_t s_k = s_q + 2 * H * kBQ;    // two K tiles, then two V
  const uint32_t s_v = s_k + 2 * kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  size_t bn;
  int r0;
  block_tile(blockIdx.x, kBQ, n_bn, rows, sq, bn, r0);
  const __nv_bfloat16* qb = q + bn * rows * H;
  const __nv_bfloat16* kb = k + bn * skv * H;
  const __nv_bfloat16* vb = v + bn * skv * H;

  for (int e = tid; e < kBQ * kChunks; e += kTcThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r0 + r < rows;
    cp_async16(s_q + swz<H>(r, c), in ? qb + size_t(r0 + r) * H + 8 * c : qb,
               in ? 16 : 0);
  }
  auto load_kv = [&](int t) {
    const int kv0 = t * kBKV;
    const uint32_t buf = (t & 1) * kTile;
    for (int e = tid; e < kBKV * kChunks; e += kTcThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool in = kv0 + r < skv;
      const size_t off = in ? size_t(kv0 + r) * H + 8 * c : 0;
      const uint32_t d = buf + swz<H>(r, c);
      cp_async16(s_k + d, kb + off, in ? 16 : 0);
      cp_async16(s_v + d, vb + off, in ? 16 : 0);
    }
  };
  load_kv(0);
  cp_async_commit();

  // the warp's rows (kMT tiles of 16) and the query positions they span
  // (0 .. sq - 1 if they wrap into the next query head); this lane's rows
  // are g and g + 8 of each tile
  const int wq = kMT * 16 * warp;              // first row in the block
  const int wr0 = r0 + wq;
  const bool active = wr0 < rows;
  const int wr_last = min(wr0 + 16 * kMT - 1, rows - 1);
  const bool wraps = wr0 / sq != wr_last / sq;
  const int wq_min = wraps ? 0 : wr0 % sq;
  const int wq_max = wraps ? sq - 1 : wr_last % sq;
  int qp[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    qp[mt][0] = (wr0 + 16 * mt + g) % sq;
    qp[mt][1] = (wr0 + 16 * mt + g + 8) % sq;
  }

  float o[kMT][kNO][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.0f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  const int n_tiles = kv_tiles(r0, kBQ, kBKV, rows, skv, sq, causal);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();    // tile t (and Q) landed; tile t - 1's readers done
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    const int kv0 = t * kBKV;
    if (!active || (causal && kv0 > wq_max)) continue;   // wholly masked
    const uint32_t kt = s_k + (t & 1) * kTile, vt = s_v + (t & 1) * kTile;

    float s[kMT][kNS][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNS; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldsm_x4(a[mt], s_q + swz<H>(wq + 16 * mt + (lane & 7) +
                                        8 * ((lane >> 3) & 1),
                                    2 * ks + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < kNS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + swz<H>(16 * np + (lane & 7) + 8 * (lane >> 4),
                               2 * ks + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(s[mt][2 * np], a[mt], b[0], b[1]);
          mma(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // scale, cap, mask (only where the tile crosses the warp's diagonal,
    // the Skv edge or a head wrap); the tile's row max over the quad; the
    // probabilities, and O and l rescaled to the new max
    const bool masked =
        kv0 + kBKV > skv || (causal && kv0 + kBKV - 1 > wq_min);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          if (masked) {
            const int kv = kv0 + 8 * j + 2 * t4 + (e & 1);
            if (!(kv < skv && (!causal || kv <= qp[mt][e >> 1]))) x = kNegInf;
          }
          s[mt][j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m[mt][0], mx0), mn1 = fmaxf(m[mt][1], mx1);
      const float c0 = ex2((m[mt][0] - mn0) * kLog2e);
      const float c1 = ex2((m[mt][1] - mn1) * kLog2e);
      const float ml0 = mn0 * kLog2e, ml1 = mn1 * kLog2e;
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        s[mt][j][0] = ex2(fmaf(s[mt][j][0], kLog2e, -ml0));
        s[mt][j][1] = ex2(fmaf(s[mt][j][1], kLog2e, -ml0));
        s[mt][j][2] = ex2(fmaf(s[mt][j][2], kLog2e, -ml1));
        s[mt][j][3] = ex2(fmaf(s[mt][j][3], kLog2e, -ml1));
        sum0 += s[mt][j][0] + s[mt][j][1];
        sum1 += s[mt][j][2] + s[mt][j][3];
      }
      l[mt][0] = l[mt][0] * c0 + sum0;
      l[mt][1] = l[mt][1] * c1 + sum1;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        o[mt][n][0] *= c0;
        o[mt][n][1] *= c0;
        o[mt][n][2] *= c1;
        o[mt][n][3] *= c1;
      }
    }

    // O += P_hi V + P_lo V, 16 KV rows a step; the scores of n-tiles 2 kk
    // and 2 kk + 1 are the A fragment (rows g, g + 8; kv 2 t4 .. + 1, + 8)
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t hi[kMT][4], lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        split2(s[mt][2 * kk][0], s[mt][2 * kk][1], hi[mt][0], lo[mt][0]);
        split2(s[mt][2 * kk][2], s[mt][2 * kk][3], hi[mt][1], lo[mt][1]);
        split2(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], hi[mt][2],
               lo[mt][2]);
        split2(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], hi[mt][3],
               lo[mt][3]);
      }
#pragma unroll
      for (int hp = 0; hp < kNO / 2; ++hp) {
        uint32_t b[4];
        ldsm_x4_t(b, vt + swz<H>(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                 2 * hp + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(o[mt][2 * hp], lo[mt], b[0], b[1]);
          mma(o[mt][2 * hp + 1], lo[mt], b[2], b[3]);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(o[mt][2 * hp], hi[mt], b[0], b[1]);
          mma(o[mt][2 * hp + 1], hi[mt], b[2], b[3]);
        }
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lsum = l[mt][half];
      lsum += __shfl_xor_sync(kFull, lsum, 1);
      lsum += __shfl_xor_sync(kFull, lsum, 2);
      const int row = wr0 + 16 * mt + g + 8 * half;
      if (row >= rows) continue;
      const float d = fmaxf(lsum, 1e-30f);
      const size_t o_row = bn * rows + row;
      __nv_bfloat16* dst = out + o_row * H + 2 * t4;
#pragma unroll
      for (int n = 0; n < kNO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[mt][n][2 * half] / d,
                                  o[mt][n][2 * half + 1] / d);
      if (t4 == 0) lse[o_row] = m[mt][half] + logf(d);
    }
}

}  // namespace tc

// above 48 KB a block's shared memory must be asked for (once is enough)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int H>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                void* lse, int bn, int rows, int skv, int sq, int causal,
                float scale, float softcap, cudaStream_t stream) {
  constexpr size_t bytes = simt::smem_bytes<H>();
  static const cudaError_t attr = allow_smem(simt::flash_fwd_simt<H>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (rows + simt::kBQ - 1) / simt::kBQ * bn;
  simt::flash_fwd_simt<H><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), bn, rows, skv, sq, causal, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int bn, int rows, int skv, int sq, int causal,
              float scale, float softcap, cudaStream_t stream) {
  constexpr size_t bytes = tc::smem_bytes<H>();
  static const cudaError_t attr = allow_smem(tc::flash_fwd_tc<H>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = (rows + tc::kBQ - 1) / tc::kBQ * bn;
  tc::flash_fwd_tc<H><<<grid, tc::kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), bn, rows,
      skv, sq, causal, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           void* lse, int bn, int rows, int skv, int sq, int causal,
           float scale, float softcap, cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<H>(q, k, v, out, lse, bn, rows, skv, sq, causal,
                          scale, softcap, stream);
  if (dtype == 1)
    return launch_tc<H>(q, k, v, out, lse, bn, rows, skv, sq, causal, scale,
                        softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  dtype:
// 0 = fp32 (the CUDA cores), 1 = bf16 (the tensor cores; q, k and v
// 16-byte aligned), q, k, v and out alike.  head_dim must be 32, 64 or
// 128; bn times the query tiles at most 2^31 - 1; causal 0 or 1.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int bn, int rows, int skv, int sq,
                     int head_dim, int dtype, int causal, float scale,
                     float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(dtype, q, k, v, out, lse, bn, rows, skv, sq, causal,
                        scale, softcap, s);
    case 64:
      return launch<64>(dtype, q, k, v, out, lse, bn, rows, skv, sq, causal,
                        scale, softcap, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, lse, bn, rows, skv, sq, causal,
                         scale, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Weight-only int8 GEMM for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/wq_gemm/kernel.py).
//
// Replaces the TPU kernel `_wq_kernel` (src/repro/kernels/wq_gemm/
// kernel.py:22, pallas_call at :48): y (M, N) = x (M, K) @ (q (K, N) *
// scale[N]), q int8 with one fp32 scale per output channel.  As there, each
// int8 weight is widened inside the kernel, the products accumulate in
// fp32, the per-column scale is applied once at the store and the result
// is rounded once to the output type.  x is fp32 or bf16; y is x's type or
// fp32.  With `transposed` q is stored (N, K) row-major: the tied unembed's
// (V, d) embedding table, whose per-row scale is the per-output-channel
// scale, read in place (no transposed copy).  M, N and K are ragged: every
// edge is masked in the kernel.
//
// bf16 x runs on the tensor cores.  int8 -> bf16 is exact (|q| <= 127) and
// a bf16 x bf16 product is exact in fp32, so a bf16 tensor-core product with
// fp32 accumulation computes what the TPU kernel computes, up to the order
// of the sum.  The widening is two logic ops and one bf16x2 subtraction a
// pair of bytes (bf16 has 8 significant bits, too few for the one-add magic
// number that widens int8 to fp16, so the sign byte is split off):
//   v = 0x4300 | (b & 0x7f)  (128 + low bits),  s = 0x4300 | (b & 0x80)
//   (128, or 256 where b < 0),  b = v - s, exact.
// Three kernels, chosen by x's dtype and M (kernel.py's `plan`):
//  - M <= 8 (`wq_gemv`, decode), either x type: bytes-bound, the int8
//    weights read once (granite-3-2b's 2048 -> 8192: 16.8 MB, 5.0 us at
//    3.35 TB/s).  A block of 4 warps owns 64 output columns and a range of
//    K, and streams its q tiles (64 columns x 128 k, 8 KB, either layout)
//    and the matching x rows through an eight-stage 16-byte cp.async ring:
//    seven tiles, 70 KB, in flight a block while one is computed.  In `mma.sync.m16n8k16` the
//    weights are the 16-row operand (16 output columns) and the <= 8 decode
//    rows the n = 8 side; the k order inside each 16-step is permuted (the
//    same way for both operands), so a lane's four bytes of a column are
//    one 32-bit shared load: (N, K) reads them along a row, (K, N) picks
//    them out of four rows with byte permutes.  The two warps along K and
//    the blocks of a K split sum in a fixed order: the split's blocks form
//    one thread-block cluster and the first sums the others' partials out
//    of their shared memory (no workspace, no counter), so the bits do not
//    depend on which block ran first.  K is split only where the column
//    strips leave SMs idle (8192 -> 2048, 2048 -> 512), into at most 8
//    blocks (a portable cluster).  fp32 x (the reduced configurations'
//    parity path) takes the same ring and split on the CUDA cores: a lane
//    widens the same 16 bytes a step to fp32 (the bf16 widening, then a
//    shift) and makes 8 FMAs a weight; the four lanes of a column group
//    meet in a butterfly before the same fixed-order sums.
//  - bf16 x, M > 8 (`wq_wgmma`, prefill and mixed steps): operations-bound
//    at large M (M 4096 x 2048 -> 8192: 0.139 ms at 989 TFLOP/s), and in
//    practice bound by the tiles' traffic from L2 (each block reads its x
//    rows and q columns once: 1.07 GB at that shape) and by shared memory
//    (copies in, the widening, wgmma's reads).  A block owns a BM x BN tile
//    of y ((128, 256), (64, 128) or (64, 64), the first whose grid fills the
//    card) and has two roles.  The consumer warpgroups (one a 64 rows) load
//    a four-stage ring of x tiles (BM x 64, in the 128-byte swizzle wgmma
//    reads) and int8 q tiles (by TMA, or byte loads where 16-byte rows are
//    not possible) and issue `wgmma.m64nBNk16` (bf16, fp32 accumulators)
//    asynchronously; a warpgroup of wideners widens each stage's q tile
//    once into a triple-buffered, K-major, 128-byte-swizzled bf16 B tile
//    (the (K, N) layout transposed on the way, byte permutes picking a
//    column's bytes out of 8 rows).  mbarriers pass the stages between the
//    roles.  Both layouts thus feed wgmma one K-major B.  The tensor cores'
//    own accumulation drifts with the length of its chain, so the (64, 64)
//    tile adds its accumulators into fp32 sums every 256 k; the larger
//    tiles have no registers to spare for that and sum as cuBLAS's bf16
//    GEMM does (at K 8192 with unit-scale weights the same error from the
//    fp64 product as torch.mm's).
//  - fp32 x, M > 8 (`wq_gemm_tiled`): gemm.cu's register-tiled fp32 loop on
//    the CUDA cores (256 threads, a 4 x 4 or 8 x 8 tile each), the products
//    summed in chains of 128 k and the chains in order.  TF32 would break
//    the fp32 parity the engines' tests hold, so fp32 x stays here.  It is
//    the reduced (fp32) configurations' path, the parity checks'; a
//    full-width model runs bf16.  Not tuned for speed.
// Vector (16-byte) loads are used only where the row lengths and the base
// addresses allow them (the wrapper checks); otherwise the same kernels
// load bytes into the same shared layout.  Nothing falls back to another
// implementation.
#include <cooperative_groups.h>
#include <cuda.h>                   // CUtensorMap (the driver is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two consecutive outputs (n, n + 1) of one row, 4- or 8-byte aligned
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) are zero-filled
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

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  return __byte_perm(a, b, sel);
}

// the int8 bytes at bits 0-7 and 16-23 of w (other bits ignored) as bf16x2,
// the first in the low half; exact (see the note at the top)
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w) {
  const uint32_t v = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t s = (w & 0x00800080u) | 0x43004300u;
  uint32_t r;
  // v + s * -1 in bf16x2: exact, the result is an integer |b| <= 128
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(s), "r"(0xbf80bf80u), "r"(v));
  return r;
}

// byte i (0..3) of word a to bits 0-7 and byte i of word b to bits 16-23,
// the pair i8x2_bf16x2 widens
__device__ __forceinline__ uint32_t pick_pair(uint32_t a, uint32_t b,
                                              uint32_t i) {
  return prmt(a, b, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
}

// up to 16 bytes from p (those at or past `n` zero), for the byte loads
__device__ __forceinline__ uint4 load16_bytes(const int8_t* p, int n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[b]))
                           << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}
// up to 8 bf16 from p (those at or past `n` zero)
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p, int n) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) w[e / 2] |= static_cast<uint32_t>(h[e]) << (16 * (e % 2));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// up to 4 floats from p (those at or past `n` zero)
__device__ __forceinline__ uint4 load4_f32(const float* p, int n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) w[e] = __float_as_uint(p[e]);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a 16-byte chunk of a stage: cp.async (kVec) or byte loads into place
template <bool kVec>
__device__ __forceinline__ void stage_q16(uint8_t* dst, const int8_t* src,
                                          int n) {
  n = max(0, min(n, 16));
  if (kVec)
    cp_async16(smem_u32(dst), src, n);     // n == 0: nothing is read
  else
    *reinterpret_cast<uint4*>(dst) = n ? load16_bytes(src, n)
                                       : make_uint4(0u, 0u, 0u, 0u);
}
template <bool kVec>
__device__ __forceinline__ void stage_x16(uint8_t* dst,
                                          const __nv_bfloat16* src, int n) {
  n = max(0, min(n, 8));
  if (kVec)
    cp_async16(smem_u32(dst), src, 2 * n);
  else
    *reinterpret_cast<uint4*>(dst) = n ? load8_bf16(src, n)
                                       : make_uint4(0u, 0u, 0u, 0u);
}
template <bool kVec>
__device__ __forceinline__ void stage_x16(uint8_t* dst, const float* src,
                                          int n) {
  n = max(0, min(n, 4));
  if (kVec)
    cp_async16(smem_u32(dst), src, 4 * n);
  else
    *reinterpret_cast<uint4*>(dst) = n ? load4_f32(src, n)
                                       : make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------
// M <= 8: the GEMV (bf16 x on the tensor cores, fp32 x on the CUDA cores)
// ---------------------------------------------------------------------------
constexpr int kGvWK = 2;          // warps along K (4 measured no faster)
constexpr int kGvThreads = 64 * kGvWK;   // warps (wn, wk) in 2 x kGvWK
constexpr int kGvBN = 64;         // output columns a block, 32 a warp
constexpr int kGvBK = 128;        // k a stage
constexpr int kGvKW = kGvBK / kGvWK;     // k a warp a stage: 64, four steps
constexpr int kGvStages = 8;
constexpr int kGvQBytes = kGvBN * kGvBK;   // 8 KB
template <typename Tx>                     // 8 rows: 2 KB bf16, 4 KB fp32
constexpr int kGvXBytes = 8 * kGvBK * static_cast<int>(sizeof(Tx));

// shared byte offset of 16-byte chunk c of a stage's q tile, swizzled so a
// warp's 32 four-byte reads of one step meet 32 different banks.
// (N, K): row n (64) of 128 bytes; (K, N): row k (128) of 64 bytes, two rows
// a 128-byte line.
__device__ __forceinline__ int gv_q_nk(int n, int c) {
  return n * 128 + ((c ^ ((n >> 2) & 7)) << 4);
}
__device__ __forceinline__ int gv_q_kn(int k, int c) {
  return (k >> 1) * 128 + (((((k & 1) << 2) | c) ^ (((k >> 2) & 3) << 1)) << 4);
}
// bf16 x: row m (8) of 256 bytes (fp32 x: of 512, unswizzled: a warp's
// reads of a row are four adjacent 16-byte chunks)
__device__ __forceinline__ int gv_x(int m, int c) {
  return m * 256 + ((c ^ ((m & 3) << 1)) << 4);
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fp32 (bits 16-31 of the word) of the int8 bytes of w, byte b in v[b]
__device__ __forceinline__ void i8x4_f32(uint32_t w, float* v) {
  const uint32_t lo = i8x2_bf16x2(w), hi = i8x2_bf16x2(w >> 8);
  v[0] = __uint_as_float(lo << 16);
  v[1] = __uint_as_float(hi << 16);
  v[2] = __uint_as_float(lo & 0xffff0000u);
  v[3] = __uint_as_float(hi & 0xffff0000u);
}

template <typename To, typename Tx, bool kTrans, bool kVec>
__global__ void __launch_bounds__(kGvThreads)
    wq_gemv(const Tx* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, To* __restrict__ y, int M,
            int N, int K, int k_per_split) {
  constexpr bool kXf32 = sizeof(Tx) == 4;
  // the ring: kGvStages q tiles, then as many x tiles (dynamic, 80 KB for
  // bf16 x, 96 KB for fp32)
  extern __shared__ __align__(128) uint8_t gv_ring[];
  uint8_t(*qs)[kGvQBytes] = reinterpret_cast<uint8_t(*)[kGvQBytes]>(gv_ring);
  uint8_t(*xs)[kGvXBytes<Tx>] = reinterpret_cast<uint8_t(*)[kGvXBytes<Tx>]>(
      gv_ring + kGvStages * kGvQBytes);
  __shared__ float red[kGvWK - 1][2][32][8];   // the wk > 0 warps' sums
  __shared__ float part[kGvBN * 8];        // the block's sums, (n, m)
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wn = warp & 1, wk = warp >> 1;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kGvBN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tiles = k_end > k_begin ? (k_end - k_begin + kGvBK - 1) / kGvBK
                                    : 0;

  auto load = [&](int slot, int k0) {
    uint8_t* qd = qs[slot];
#pragma unroll
    for (int u = 0; u < kGvQBytes / 16 / kGvThreads; ++u) {
      const int idx = tid + u * kGvThreads;
      if (kTrans) {                    // 64 rows n x 8 chunks
        const int n = idx >> 3, c = idx & 7, k = k0 + 16 * c;
        const bool ok = n0 + n < N;
        stage_q16<kVec>(qd + gv_q_nk(n, c),
                        q + static_cast<size_t>(n0 + n) * K + k,
                        ok ? k_end - k : 0);
      } else {                         // 128 rows k x 4 chunks
        const int kr = idx >> 2, c = idx & 3, k = k0 + kr, n = n0 + 16 * c;
        stage_q16<kVec>(qd + gv_q_kn(kr, c),
                        q + static_cast<size_t>(k) * N + n,
                        k < k_end ? N - n : 0);
      }
    }
    if constexpr (kXf32) {             // 8 rows m x 32 chunks
#pragma unroll
      for (int u = 0; u < 256 / kGvThreads; ++u) {
        const int idx = tid + u * kGvThreads;
        const int m = idx >> 5, c = idx & 31, k = k0 + 4 * c;
        stage_x16<kVec>(xs[slot] + m * 512 + 16 * c,
                        x + static_cast<size_t>(m) * K + k,
                        m < M ? k_end - k : 0);
      }
    } else if (tid < 128) {            // 8 rows m x 16 chunks
      const int m = tid >> 4, c = tid & 15, k = k0 + 8 * c;
      stage_x16<kVec>(xs[slot] + gv_x(m, c),
                      x + static_cast<size_t>(m) * K + k,
                      m < M ? k_end - k : 0);
    }
  };

  // fp32 x: this lane's sums of columns 32 wn + 4 g + i, all 8 rows m, over
  // its k (4 t .. 4 t + 3 of each 16); the lanes t meet at the end
  float f32acc[kXf32 ? 4 : 1][8] = {};
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kGvStages - 1; ++s) {
    if (s < tiles) load(s, k_begin + s * kGvBK);
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kGvStages - 2>();
    __syncthreads();         // tile `it` landed; tile it - 1 is consumed
    {
      const int nt = it + kGvStages - 1;
      if (nt < tiles) load(nt % kGvStages, k_begin + nt * kGvBK);
      cp_async_commit();
    }
    const uint8_t* qd = qs[it % kGvStages];
    const uint8_t* xd = xs[it % kGvStages];
    if constexpr (kXf32) {
#pragma unroll
      for (int j = 0; j < kGvKW / 16; ++j) {
        const int kk = kGvKW * wk + 16 * j + 4 * t;
        uint32_t w[4];   // (N, K): column 4 g + i, k kk..kk+3 in its bytes;
                         // (K, N): row kk + i, columns 4 g..4 g + 3
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = kTrans ? *reinterpret_cast<const uint32_t*>(
                              qd + gv_q_nk(32 * wn + 4 * g + i,
                                           kGvKW / 16 * wk + j) + 4 * t)
                        : *reinterpret_cast<const uint32_t*>(
                              qd + gv_q_kn(kk + i, 2 * wn + (g >> 2)) +
                              4 * (g & 3));
        float f[4][4];   // column 4 g + i at k kk + r
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v[4];
          i8x4_f32(w[u], v);
#pragma unroll
          for (int b = 0; b < 4; ++b) (kTrans ? f[u][b] : f[b][u]) = v[b];
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xd + m * 512 + 4 * kk);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = f32acc[i][m];
            a = fmaf(f[i][0], xv.x, a);
            a = fmaf(f[i][1], xv.y, a);
            a = fmaf(f[i][2], xv.z, a);
            f32acc[i][m] = fmaf(f[i][3], xv.w, a);
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kGvKW / 16; ++j) {
      // this lane's k: kGvKW wk + 16 j + 4 t + {0, 1, 2, 3}
      const uint2 xv = *reinterpret_cast<const uint2*>(
          xd + gv_x(g, kGvKW / 8 * wk + 2 * j + (t >> 1)) + 8 * (t & 1));
      uint32_t b0, b1, a[2][4];
      if (kTrans) {
        // mma k positions (2t, 2t+1) <- k (0, 2), (2t+8, 2t+9) <- (1, 3)
        b0 = prmt(xv.x, xv.y, 0x5410);
        b1 = prmt(xv.x, xv.y, 0x7632);
#pragma unroll
        for (int T = 0; T < 2; ++T) {
          const int n = 32 * wn + 4 * g + 2 * T;
          const uint32_t lo = *reinterpret_cast<const uint32_t*>(
              qd + gv_q_nk(n, kGvKW / 16 * wk + j) + 4 * t);
          const uint32_t hi = *reinterpret_cast<const uint32_t*>(
              qd + gv_q_nk(n + 1, kGvKW / 16 * wk + j) + 4 * t);
          a[T][0] = i8x2_bf16x2(lo);
          a[T][1] = i8x2_bf16x2(hi);
          a[T][2] = i8x2_bf16x2(lo >> 8);
          a[T][3] = i8x2_bf16x2(hi >> 8);
        }
      } else {
        // mma k positions (2t, 2t+1) <- k (0, 1), (2t+8, 2t+9) <- (2, 3)
        b0 = xv.x;
        b1 = xv.y;
        uint32_t w[4];                 // rows k, columns 4 g .. 4 g + 3
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(
              qd + gv_q_kn(kGvKW * wk + 16 * j + 4 * t + r,
                           2 * wn + (g >> 2)) +
              4 * (g & 3));
#pragma unroll
        for (int T = 0; T < 2; ++T) {
          a[T][0] = i8x2_bf16x2(pick_pair(w[0], w[1], 2 * T));
          a[T][1] = i8x2_bf16x2(pick_pair(w[0], w[1], 2 * T + 1));
          a[T][2] = i8x2_bf16x2(pick_pair(w[2], w[3], 2 * T));
          a[T][3] = i8x2_bf16x2(pick_pair(w[2], w[3], 2 * T + 1));
        }
      }
      // rows g, g + 8 of tile T are columns 32 wn + 4 g + 2 T (+ 1)
      mma_bf16_16816(acc[0], a[0], b0, b1);
      mma_bf16_16816(acc[1], a[1], b0, b1);
    }
  }

  if constexpr (kXf32) {
    // the four lanes t of a column group sum in a butterfly (the same bits
    // in each), then hold their rows as the tensor-core path does
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float v = f32acc[i][m];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        f32acc[i][m] = v + __shfl_xor_sync(0xffffffffu, v, 2);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        float v = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (m == 2 * t + mm) v = f32acc[i][m];
        acc[i / 2][(i % 2) * 2 + mm] = v;
      }
  }

  // this lane: columns n = 32 wn + 4 g + i (i = 0..3), rows m = 2 t, 2 t + 1
  // at acc[i / 2][(i % 2) * 2 + (m - 2 t)]
  if (wk > 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[wk - 1][wn][lane][e] = acc[e / 4][e % 4];
  }
  __syncthreads();
  const bool split = gridDim.y > 1;
  if (wk == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const int e = (i / 2) * 4 + (i % 2) * 2 + mm;
        float v = acc[e / 4][e % 4];   // the K warps' sums in warp order
#pragma unroll
        for (int w = 0; w < kGvWK - 1; ++w) v += red[w][wn][lane][e];
        const int nl = 32 * wn + 4 * g + i, m = 2 * t + mm;
        if (split) {
          part[nl * 8 + m] = v;
        } else if (m < M && n0 + nl < N) {
          y[static_cast<size_t>(m) * N + n0 + nl] =
              from_float<To>(v * scale[n0 + nl]);
        }
      }
  }
  if (!split) return;
  // the K split: one cluster along y; its first block sums the blocks'
  // partials in rank order out of their shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int o = tid; o < kGvBN * 8; o += kGvThreads) {
      const int m = o / kGvBN, nl = o % kGvBN, n = n0 + nl;
      if (m >= M || n >= N) continue;
      float s = 0.f;
      for (int r = 0; r < static_cast<int>(gridDim.y); ++r)
        s += cluster.map_shared_rank(part, r)[nl * 8 + m];
      y[static_cast<size_t>(m) * N + n] = from_float<To>(s * scale[n]);
    }
  }
  cluster.sync();            // no block leaves while its partials are read
}

// ---------------------------------------------------------------------------
// bf16 x, M > 8: wgmma
// ---------------------------------------------------------------------------
constexpr int kWgBK = 64;           // k a stage: one 128-byte swizzled row
constexpr int kWgStages = 4;        // x and q tiles in flight
constexpr int kWgBBufs = 3;         // widened B tiles: the wideners run ahead
// k tiles wgmma sums into one set of accumulators before they are added
// into fp32 sums (256 k, 16 wgmma steps): the tensor cores' accumulation
// drifts with the length of its chain (at K 8192, unit-scale weights, M 65
// x N 1024: 2.5e-3 from the fp64 product unpromoted, 8.6e-5 promoted;
// fp32 torch.matmul 1.4e-4)
constexpr int kWgSum = 4;

template <int BM, int BN>
struct WgCfg {
  static constexpr int kConsumers = BM / 64 * 128;  // one warpgroup a 64 rows
  static constexpr int kWideners = 128;             // one warpgroup
  static constexpr int kThreads = kConsumers + kWideners;
  static constexpr int kABytes = BM * 128;          // x tile, bf16
  static constexpr int kQBytes = BN * kWgBK;        // q tile, int8
  static constexpr int kBBytes = BN * 128;          // widened B tile, bf16
  // accumulators and their sums (BN registers a thread) leave two blocks
  // an SM only at BN 64: at 128 they cost (64, 128) its second block (16%
  // at M 256, 2048 -> 8192), at 256 they do not fit
  static constexpr bool kPromote = BN == 64;
  static constexpr int kSmem =
      kWgStages * (kABytes + kQBytes) + kWgBBufs * kBBytes +
      1024;                                         // + alignment
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

// mbarriers in shared memory (CTA scope)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// a 2-d box of `map` at (c0 innermost, c1) into shared memory at dst; its
// bytes complete on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}
// a barrier of the `count` consumer threads only (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// descriptor of a K-major bf16 tile in the 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart (SBO 64 x 16 bytes); LBO unused (1)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}
// byte offset of chunk c (8 bf16) of row r in that swizzle
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// widen a stage's int8 q tile (qd) into the K-major, 128-byte-swizzled bf16
// B tile (bd), by the NW threads wt = 0 .. NW - 1
template <bool kTrans, int BN, int NW>
__device__ __forceinline__ void widen(const uint8_t* qd, uint8_t* bd,
                                      int wt) {
  // a fixed count of items a thread, unrolled: their shared loads are
  // issued together, so one warp a scheduler keeps its pipes busy
  if (kTrans) {                        // (n, 8 k): 8 bytes in, 16 out
    static_assert(BN * 8 % NW == 0, "items divide among the wideners");
#pragma unroll 4
    for (int it = 0; it < BN * 8 / NW; ++it) {
      const int idx = wt + it * NW;
      const int n = idx >> 3, c = idx & 7;
      const uint2 w = *reinterpret_cast<const uint2*>(qd + n * 64 + 8 * c);
      uint4 o;
      o.x = i8x2_bf16x2(prmt(w.x, 0u, 0x0100));
      o.y = i8x2_bf16x2(prmt(w.x, 0u, 0x0302));
      o.z = i8x2_bf16x2(prmt(w.y, 0u, 0x0100));
      o.w = i8x2_bf16x2(prmt(w.y, 0u, 0x0302));
      *reinterpret_cast<uint4*>(bd + sw128(n, c)) = o;
    }
  } else {                             // (4 n, 8 k): 8 rows of 4 bytes in
    static_assert(BN * 2 % NW == 0, "items divide among the wideners");
#pragma unroll
    for (int it = 0; it < BN * 2 / NW; ++it) {
      const int idx = wt + it * NW;
      const int n4 = idx % (BN / 4), c = idx / (BN / 4);
      uint32_t w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(qd + (8 * c + r) * BN +
                                                  4 * n4);
      // lanes start at different columns of their four, so the eight lanes
      // of a quarter warp store to eight different bank groups
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t ie = (i + (n4 >> 1)) & 3;
        uint4 o;
        o.x = i8x2_bf16x2(pick_pair(w[0], w[1], ie));
        o.y = i8x2_bf16x2(pick_pair(w[2], w[3], ie));
        o.z = i8x2_bf16x2(pick_pair(w[4], w[5], ie));
        o.w = i8x2_bf16x2(pick_pair(w[6], w[7], ie));
        *reinterpret_cast<uint4*>(bd + sw128(4 * n4 + ie, c)) = o;
      }
    }
  }
}

template <typename To, bool kTrans, int BM, int BN, bool kVec>
__global__ void __launch_bounds__(WgCfg<BM, BN>::kThreads, 1)
    wq_wgmma(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ q, const float* __restrict__ scale,
             To* __restrict__ y, int M, int N, int K,
             const __grid_constant__ CUtensorMap x_map,
             const __grid_constant__ CUtensorMap q_map) {
  using C = WgCfg<BM, BN>;
  constexpr int NC = C::kConsumers, NW = C::kWideners;
  extern __shared__ uint8_t smem_raw[];
  // full: a stage's x and q landed; ready / free: a widened B buffer
  // written (the wideners) / read by wgmma (the consumers); empty: a
  // stage read by both (x by wgmma, q by the wideners)
  __shared__ uint64_t full[kWgStages], empty[kWgStages];
  __shared__ uint64_t ready[kWgBBufs], free_[kWgBBufs];
  // wgmma's swizzle atoms want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_s = smem;                                   // [stage][BM][128]
  uint8_t* q_s = a_s + kWgStages * C::kABytes;           // [stage] q tile
  uint8_t* b_s = q_s + kWgStages * C::kQBytes;           // [buf][BN][128]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tiles = (K + kWgBK - 1) / kWgBK;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], kVec ? 1 : NC);        // the TMA's issuer, or all
      mbar_init(&empty[s], (NC + NW) / 32);      // a lane a warp
    }
    for (int b = 0; b < kWgBBufs; ++b) {
      mbar_init(&ready[b], NW);
      mbar_init(&free_[b], NC / 32);
    }
  }
  __syncthreads();

  // Two roles, so that widening runs ahead of the products: the consumer
  // warpgroups load the stages and issue wgmma, a warpgroup of wideners
  // widens.  The widened B tile is written through the generic proxy and
  // read by wgmma through the async proxy, so its writers fence
  // (fence.proxy.async, a memory barrier over the fencing thread's own
  // accesses): as the wideners have no copies in flight, the fence waits
  // on nothing but their own stores.
  if (tid >= NC) {
    // the wideners
    const int wt = tid - NC;
    for (int kt = 0; kt < tiles; ++kt) {
      const int slot = kt % kWgStages, buf = kt % kWgBBufs;
      mbar_wait(&full[slot], (kt / kWgStages) & 1);
      if (kt >= kWgBBufs)
        mbar_wait(&free_[buf], (kt / kWgBBufs - 1) & 1);
      widen<kTrans, BN, NW>(q_s + slot * C::kQBytes, b_s + buf * C::kBBytes,
                            wt);
      fence_proxy_async();             // generic writes -> wgmma's reads
      mbar_arrive(&ready[buf]);
      __syncwarp();
      if (wt % 32 == 0) mbar_arrive(&empty[slot]);   // q slot read
    }
    return;
  }

  // the consumers.  Loads: with 16-byte rows, one thread issues two TMA
  // boxes a stage (x in the 128-byte swizzle, q as it lies; past M, N or K
  // the hardware fills zeros); otherwise every thread loads bytes.
  auto load = [&](int kt) {
    const int slot = kt % kWgStages, k0 = kt * kWgBK;
    if (kVec) {
      if (tid != 0) return;
      if (kt >= kWgStages)             // x read by wgmma, q by the wideners
        mbar_wait(&empty[slot], (kt / kWgStages - 1) & 1);
      mbar_expect_tx(&full[slot], C::kABytes + C::kQBytes);
      tma_load(a_s + slot * C::kABytes, &x_map, k0, m0, &full[slot]);
      if (kTrans)
        tma_load(q_s + slot * C::kQBytes, &q_map, k0, n0, &full[slot]);
      else
        tma_load(q_s + slot * C::kQBytes, &q_map, n0, k0, &full[slot]);
      return;
    }
    if (kt >= kWgStages) mbar_wait(&empty[slot], (kt / kWgStages - 1) & 1);
    uint8_t* ad = a_s + slot * C::kABytes;
    for (int idx = tid; idx < BM * 8; idx += NC) {     // BM rows x 8
      const int r = idx >> 3, c = idx & 7, m = m0 + r, k = k0 + 8 * c;
      stage_x16<false>(ad + sw128(r, c), x + static_cast<size_t>(m) * K + k,
                       m < M ? K - k : 0);
    }
    uint8_t* qd = q_s + slot * C::kQBytes;
    if (kTrans) {                      // BN rows n x 4 chunks, rows 64 bytes
      for (int idx = tid; idx < BN * 4; idx += NC) {
        const int n = idx >> 2, c = idx & 3, k = k0 + 16 * c;
        stage_q16<false>(qd + n * 64 + 16 * c,
                         q + static_cast<size_t>(n0 + n) * K + k,
                         n0 + n < N ? K - k : 0);
      }
    } else {                           // 64 rows k x BN / 16 chunks
      for (int idx = tid; idx < kWgBK * (BN / 16); idx += NC) {
        const int kr = idx / (BN / 16), c = idx % (BN / 16);
        const int k = k0 + kr, n = n0 + 16 * c;
        stage_q16<false>(qd + kr * BN + 16 * c,
                         q + static_cast<size_t>(k) * N + n,
                         k < K ? N - n : 0);
      }
    }
    fence_proxy_async();               // plain stores, read by wgmma
    mbar_arrive(&full[slot]);
  };

  for (int kt = 0; kt < kWgStages - 1 && kt < tiles; ++kt) load(kt);
  const int wg = tid / 128;
  // kPromote: every kWgSum k tiles, once their wgmma are done, acc is added
  // into `sum` and zeroed
  constexpr bool kPromote = C::kPromote;
  float acc[BN / 2], sum[kPromote ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0.f;
    if constexpr (kPromote) sum[i] = 0.f;
  }
  for (int kt = 0; kt < tiles; ++kt) {
    const int slot = kt % kWgStages, buf = kt % kWgBBufs;
    mbar_wait(&full[slot], (kt / kWgStages) & 1);   // x tile kt landed
    mbar_wait(&ready[buf], (kt / kWgBBufs) & 1);    // B tile kt widened
    wgmma_fence();
    const uint64_t da = gmma_desc(smem_u32(a_s + slot * C::kABytes +
                                           wg * 64 * 128));
    const uint64_t db = gmma_desc(smem_u32(b_s + buf * C::kBBytes));
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)   // 32 bytes a k step
      wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();                   // wgmma(kt - 1) done in this group
    if (kt > 0 && tid % 32 == 0) {     // its x slot and B buffer are free
      mbar_arrive(&empty[(kt - 1) % kWgStages]);
      mbar_arrive(&free_[(kt - 1) % kWgBBufs]);
    }
    const int nt = kt + kWgStages - 1; // into slot (kt - 1) % stages
    if (nt < tiles) load(nt);
    if constexpr (kPromote) {
      if ((kt + 1) % kWgSum == 0 || kt + 1 == tiles) {   // block-uniform
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          sum[i] += acc[i];
          acc[i] = 0.f;
        }
      }
    }
  }
  wgmma_wait<0>();
  auto total = [&](int i) {
    if constexpr (kPromote)
      return sum[i];
    else
      return acc[i];
  };

  // total(4 j + e): row 16 w + g (+ 8 for e >= 2), column 8 j + 2 t (+ 1 for
  // odd e), w the warp within the warpgroup.  The scaled tile goes through
  // shared memory (every stage is consumed; rows padded by 16 bytes, so the
  // pairs of a warp meet no bank conflict) and out in 16-byte stores.
  consumers_sync(NC);                  // no group still reads a stage
  constexpr int kE = 16 / static_cast<int>(sizeof(To));   // a 16-byte chunk
  constexpr int kLd = BN + kE;                            // padded row
  static_assert(BM * kLd * sizeof(To) <= C::kSmem - 1024, "y tile fits");
  To* ys = reinterpret_cast<To*>(smem);
  {
    const int lane = tid % 32, w = (tid % 128) / 32;
    const int r = wg * 64 + 16 * w + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4), n = n0 + c;
      const float s0 = n < N ? scale[n] : 0.f;
      const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(ys + (r + 8 * h) * kLd + c, total(4 * j + 2 * h) * s0,
               total(4 * j + 2 * h + 1) * s1);
    }
  }
  consumers_sync(NC);
  const bool vec_out =
      ((reinterpret_cast<uintptr_t>(y) | (static_cast<uintptr_t>(N) *
                                          sizeof(To))) & 15) == 0;
  for (int idx = tid; idx < BM * (BN / kE); idx += NC) {
    const int r = idx / (BN / kE), c = (idx % (BN / kE)) * kE;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    To* dst = y + static_cast<size_t>(m) * N + n;
    const To* src = ys + r * kLd + c;
    if (vec_out && n + kE <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kE && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 x: register-tiled GEMM on the CUDA cores (either layout)
// ---------------------------------------------------------------------------
template <typename To, int TM, int TN, bool kTrans>
__global__ void __launch_bounds__(kThreads)
    wq_gemm_tiled(const float* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, To* __restrict__ y, int M,
                  int N, int K) {
  constexpr int BK = 16;
  constexpr int kSum = 8;                  // k tiles a partial sum covers
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
      a_next[i] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
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

  // products summed in chains of kSum * BK k, then the chains' sums in
  // order: at K 8192 a sequential fp32 chain drifts ~10x as far
  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

  load(0);
  for (int k0 = 0, t = 1; k0 < K; k0 += BK, ++t) {
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
        for (int j = 0; j < TN; ++j)
          part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    if (t % kSum == 0 || k0 + BK >= K) {   // block-uniform
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename To, int TM, int TN>
cudaError_t launch_tiled(const float* x, const int8_t* q, const float* scale,
                         To* y, int M, int N, int K, bool trans,
                         cudaStream_t s) {
  const dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
  if (trans)
    wq_gemm_tiled<To, TM, TN, true><<<grid, kThreads, 0, s>>>(x, q, scale, y,
                                                              M, N, K);
  else
    wq_gemm_tiled<To, TM, TN, false><<<grid, kThreads, 0, s>>>(x, q, scale,
                                                               y, M, N, K);
  return cudaGetLastError();
}

// cudaFuncSetAttribute once a kernel and device: a decode step calls the
// GEMV hundreds of times
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

template <typename To, typename Tx, bool kTrans, bool kVec>
cudaError_t launch_gemv(const Tx* x, const int8_t* q, const float* scale,
                        To* y, int M, int N, int K, int splits,
                        int k_per_split, cudaStream_t s) {
  constexpr int kSmem = kGvStages * (kGvQBytes + kGvXBytes<Tx>);
  const cudaError_t set = allow_smem<wq_gemv<To, Tx, kTrans, kVec>>(kSmem);
  if (set != cudaSuccess) return set;
  const dim3 grid((N + kGvBN - 1) / kGvBN, splits);
  if (splits == 1) {
    wq_gemv<To, Tx, kTrans, kVec><<<grid, kGvThreads, kSmem, s>>>(
        x, q, scale, y, M, N, K, k_per_split);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kGvThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wq_gemv<To, Tx, kTrans, kVec>, x, q, scale, y, M, N, K,
      k_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime (no link to the driver)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a map of a row-major (rows, cols) matrix with `elem`-byte elements, read
// in boxes of (box_rows, box_cols)
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                     const void* base, int rows, int cols, int box_rows,
                     int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename To, bool kTrans, int BM, int BN, bool kVec>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const int8_t* q,
                         const float* scale, To* y, int M, int N, int K,
                         cudaStream_t s) {
  using C = WgCfg<BM, BN>;
  const cudaError_t set = allow_smem<wq_wgmma<To, kTrans, BM, BN, kVec>>(
      C::kSmem);
  if (set != cudaSuccess) return set;
  CUtensorMap x_map = {}, q_map = {};   // the TMA's, for 16-byte rows
  if (kVec && K > 0) {
    cudaError_t err = make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                               x, M, K, BM, kWgBK,
                               CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = kTrans ? make_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N,
                              K, BN, kWgBK, CU_TENSOR_MAP_SWIZZLE_NONE)
                   : make_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K,
                              N, kWgBK, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  wq_wgmma<To, kTrans, BM, BN, kVec><<<grid, C::kThreads, C::kSmem, s>>>(
      x, q, scale, y, M, N, K, x_map, q_map);
  return cudaGetLastError();
}

template <typename To, bool kTrans, bool kVec>
cudaError_t launch_bf16(const __nv_bfloat16* x, const int8_t* q,
                        const float* scale, To* y, int M, int N, int K,
                        int path, int tile, int splits, int k_per_split,
                        cudaStream_t s) {
  if (path == 1)
    return launch_gemv<To, __nv_bfloat16, kTrans, kVec>(
        x, q, scale, y, M, N, K, splits, k_per_split, s);
  switch (tile) {
    case 0:
      return launch_wgmma<To, kTrans, 128, 256, kVec>(x, q, scale, y, M, N,
                                                      K, s);
    case 1:
      return launch_wgmma<To, kTrans, 64, 128, kVec>(x, q, scale, y, M, N, K,
                                                     s);
    default:
      return launch_wgmma<To, kTrans, 64, 64, kVec>(x, q, scale, y, M, N, K,
                                                    s);
  }
}

// fp32 x (fp32 y): the GEMV or the tiled kernel
cudaError_t launch_f32(const float* x, const int8_t* q, const float* scale,
                       float* y, int M, int N, int K, int path, int tile,
                       bool trans, bool vec, int splits, int k_per_split,
                       cudaStream_t s) {
  if (path == 0)
    return tile == 0 ? launch_tiled<float, 4, 4>(x, q, scale, y, M, N, K,
                                                 trans, s)
                     : launch_tiled<float, 8, 8>(x, q, scale, y, M, N, K,
                                                 trans, s);
  if (trans)
    return vec ? launch_gemv<float, float, true, true>(
                     x, q, scale, y, M, N, K, splits, k_per_split, s)
               : launch_gemv<float, float, true, false>(
                     x, q, scale, y, M, N, K, splits, k_per_split, s);
  return vec ? launch_gemv<float, float, false, true>(
                   x, q, scale, y, M, N, K, splits, k_per_split, s)
             : launch_gemv<float, float, false, false>(
                   x, q, scale, y, M, N, K, splits, k_per_split, s);
}

// bf16 x, y bf16 or fp32
template <typename To>
cudaError_t launch_out(const void* x, const int8_t* q, const float* scale,
                       To* y, int M, int N, int K, int path, int tile,
                       bool trans, bool vec, int splits, int k_per_split,
                       cudaStream_t s) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (trans)
    return vec ? launch_bf16<To, true, true>(xb, q, scale, y, M, N, K, path,
                                             tile, splits, k_per_split, s)
               : launch_bf16<To, true, false>(xb, q, scale, y, M, N, K, path,
                                              tile, splits, k_per_split, s);
  return vec ? launch_bf16<To, false, true>(xb, q, scale, y, M, N, K, path,
                                            tile, splits, k_per_split, s)
             : launch_bf16<To, false, false>(xb, q, scale, y, M, N, K, path,
                                             tile, splits, k_per_split, s);
}

}  // namespace

extern "C" {

// x (M, K) contiguous, fp32 with flag 8, else bf16; q int8, (K, N) or, with
// flag 2 (transposed), (N, K), contiguous; scale (N,) fp32; y (M, N), bf16
// with flag 1, else fp32 (bf16 only from bf16 x).
// `plan` holds 8 ints: M, N, K, path, tile, flags, splits, k_per_split.
//   path 0: fp32 x, tiled, tile 0 (4 x 4 a thread) or 1 (8 x 8);
//   path 1: the GEMV (M <= 8), K split into `splits` (1..8) ranges of
//           `k_per_split` (a multiple of 128) rows, one cluster a column strip;
//   path 2: bf16 x, wgmma, tile 0 (128 x 256), 1 (64 x 128) or 2 (64 x 64).
// Flag 4 (vec): x's and q's row lengths and bases allow 16-byte loads.
// Launches on `stream`; returns a CUDA error code (0 on success).
int wq_gemm_launch(const void* x, const void* q, const void* scale, void* y,
                   const int* plan, void* stream) {
  const int M = plan[0], N = plan[1], K = plan[2], path = plan[3];
  const int tile = plan[4], flags = plan[5], splits = plan[6];
  const int k_per_split = plan[7];
  if (M <= 0 || N <= 0) return 0;
  const bool out_bf16 = flags & 1, trans = flags & 2, vec = flags & 4;
  const bool x_f32 = flags & 8;
  if (K < 0 || path < 0 || path > 2 || (x_f32 && out_bf16) ||
      (path == 0 && !x_f32) || (path == 2 && x_f32) ||
      (path == 1 && (M > 8 || splits < 1 || splits > 8 ||
                     k_per_split % kGvBK != 0 ||
                     static_cast<long long>(splits) * k_per_split < K)) ||
      (path != 1 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_f32)
    err = launch_f32(static_cast<const float*>(x), qb, sc,
                     static_cast<float*>(y), M, N, K, path, tile, trans, vec,
                     splits, k_per_split, s);
  else if (out_bf16)
    err = launch_out<__nv_bfloat16>(x, qb, sc, static_cast<__nv_bfloat16*>(y),
                                    M, N, K, path, tile, trans, vec, splits,
                                    k_per_split, s);
  else
    err = launch_out<float>(x, qb, sc, static_cast<float*>(y), M, N, K, path,
                            tile, trans, vec, splits, k_per_split, s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

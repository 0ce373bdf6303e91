// Chunked Mamba-2 SSD scan for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/ssd_scan/kernel.py).
//
// Replaces the TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan/
// kernel.py:25, launched by `ssd_scan`, pallas_call at :80), and computes
// what `repro.models.mamba2._ssd_chunked` computes, in fp32 in and out.  Per
// (b, h) stream, per chunk of L rows, with cum = cumsum(dt * A) within the
// chunk (A < 0):
//   y_l = sum_{m <= l} exp(cum_l - cum_m) (C_l . B_m) dt_m x_m
//         + exp(cum_l) C_l . h_prev + D x_l
//   h   <- exp(cum_L) h + sum_m exp(cum_L - cum_m) dt_m x_m B_m^T
// and the state after the last real token is written out as h_final
// (b, h, P, N), which the TPU kernel keeps in VMEM and drops.  Layouts are
// the model's: x / y (b, S, H, P), dt (b, S, H), B / C (b, S, N) shared by
// the H heads of a batch row (ngroups = 1) and read in place, A / D one
// value per stream (b * H).  The stream layout (BH, S, P) is the case H = 1.
// Any S: a chunk may be shorter than L (the last one, or all of them when
// L > S); its missing rows count as dt = 0, as the reference's padding does,
// so they neither decay nor feed the state.
//
// What bounds it: operations.  Over the causal pairs only, L(L+1)/2 * N
// multiply-adds for C.B^T once per (batch row, chunk), and per head
// L(L+1)/2 * P for W.xdt and 2 L P N for the inter-chunk term and the chunk
// state; the bytes are each input read once and y and h_final written once.
// At mamba2-780m's layer (b 8, S 2048, 48 heads, P 64, N 128, L 256) that is
// 3.9e10 operations against ~435 MB: 0.59 ms at the CUDA cores' fp32 rate,
// 0.24 ms for the three TF32 products a product takes here (below).
//
// Design: the chunk-parallel form of the plain version (ref.py:
// chunk_states, state_pass, chunk_outputs), four kernels on one stream,
// no host sync, with workspaces the binding allocates:
//  (a) ssd_cb_kernel: C.B^T once per (batch row, chunk), the 64 x 64 tiles
//      on and below the diagonal, into cb (b, nc, Lp, Lp) fp32 (Lp: L to a
//      multiple of 64; 16.8 MB at the layer shape, which stays in L2 for (d)).
//  (b) ssd_states_kernel: per (b, h, chunk) the chunk's own state
//      s_c = sum_m exp(cum_L - cum_m) dt_m x_m^T B_m (P x N) into states
//      (b, nc, H, P, N); it also writes the chunk's cum into cum (b, H, nc,
//      Lp) for (c) and (d).  3072 independent blocks at the layer shape.
//  (c) ssd_pass_kernel: per (b, h), in chunk order, h_c = exp(cum_L,c)
//      h_{c-1} + s_c, elementwise (a float4 a thread, the loads of 8 chunks
//      in flight together); the state BEFORE each chunk replaces s_c in
//      place, and h_final is written after the last.
//  (d) ssd_out_kernel: per (b, h, chunk, 64-row query tile), the query
//      tiles of a (b, h, chunk) and then the heads of a (b, chunk) next to
//      each other in the grid, so that the x tiles, h_prev, C.B^T and C
//      they share come from L2.  One ring of steps, 37 KB of shared memory
//      at P 64, N 128 (five blocks an SM): first exp(cum_l) C_l . h_prev,
//      32 of N a step (none for the first chunk), then the keys up to the
//      diagonal, 32 a step (the tiles above it are never visited; near it
//      a warp stops at its last row), with W = cb * exp(cum_l - cum_m) *
//      dt_m formed as the fragment is loaded.  Where a step holds keys
//      past the tile's first query the decay is masked BEFORE the exp:
//      above the diagonal cum_l - cum_m > 0 overflows, so its argument is
//      -inf there and exp gives 0.  Before it (every key before every
//      query) the decay is e_l f_m, e_l = exp(cum_l - cum_end) and f_m =
//      exp(cum_end - cum_m), cum_end the step's last key: both <= 1 (cum
//      falls: A < 0), and one exp a row and a key instead of a pair.
//  - every product runs on the tensor cores, mma.sync m16n8k8 with tf32
//    operands and fp32 sums, in 3xTF32: each fp32 operand a = hi + lo with
//    hi = a's top 19 bits and lo = the top 19 bits of a - hi (exact), and
//    the product is lo.hi + hi.lo + hi.hi (lo.lo, below 2^-20 relative, is
//    dropped).  One TF32 pass alone would carry ~5e-4 relative error; this
//    keeps fp32 grade.  Operands are split as their fragments are loaded
//    from shared memory.
//  - tiles come into shared memory by 16-byte cp.async (dt by 4-byte ones:
//    it is strided by H), two stages in (b) and (d) with the next tile or
//    step in flight while one is computed, and two column halves in (a).  Row
//    pitches are padded so that every fragment load is free of bank
//    conflicts (pitch / 4 odd where a lane's rows differ, pitch / 8 odd
//    where its k rows do).
// Known limits, later work: mma.sync, not wgmma (its tiles would want a
// TMA-fed, swizzled layout); the operands are split in every warp that loads
// them (the shared one of (d), x or h_prev, four times); the states
// workspace (100.7 MB at the layer shape) goes through device memory three
// times.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;              // rows of a query, key and C.B^T tile
constexpr int kMaxChunk = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kTf32Mask = 0xffffe000u;   // sign, exponent, 10 bits

__host__ __device__ constexpr int padded(int L) {
  return (L + kT - 1) / kT * kT;
}

// ---- cp.async ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
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

// ---- 3xTF32 on mma.sync m16n8k8 ----
// Fragments (PTX ISA, m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & kTf32Mask;
  lo = __float_as_uint(a - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// an A fragment: at(row, k) for rows r0 + {g, g + 8}, k k0 + {t, t + 4}
struct FragA {
  uint32_t hi[4], lo[4];
  template <class At>
  __device__ __forceinline__ void load(At&& at, int r0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    split(at(r0 + g, k0 + t), hi[0], lo[0]);
    split(at(r0 + g + 8, k0 + t), hi[1], lo[1]);
    split(at(r0 + g, k0 + t + 4), hi[2], lo[2]);
    split(at(r0 + g + 8, k0 + t + 4), hi[3], lo[3]);
  }
};

// a B fragment: bt(k, col) for k k0 + {t, t + 4}, col n0 + g
struct FragB {
  uint32_t hi[2], lo[2];
  template <class Bt>
  __device__ __forceinline__ void load(Bt&& bt, int k0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    split(bt(k0 + t, n0 + g), hi[0], lo[0]);
    split(bt(k0 + t + 4, n0 + g), hi[1], lo[1]);
  }
};

// c += a . b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// cudaFuncSetAttribute once a kernel and device (above 48 KB a block's
// dynamic shared memory must be asked for; once, at the largest chunk)
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  done[dev] = err == cudaSuccess;
  return err;
}

// ---------------------------------------------------------------------------
// (a) C.B^T per (batch row, chunk), the tiles on and below the diagonal
// ---------------------------------------------------------------------------
constexpr int kCbThreads = 128;     // 2 x 2 warps of 32 x 32

template <int N>
struct CbCfg {
  static constexpr int kLd = N + 4;                 // pitch / 4 odd
  static constexpr size_t kBytes = 2 * kT * kLd * sizeof(float);
};

template <int N>
__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int L, int nc) {
  using Cfg = CbCfg<N>;
  constexpr int kLd = Cfg::kLd;
  constexpr int kVec = N / 4;                       // 16-byte vectors a row
  constexpr int kHalf = kVec / 2;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                                 // [kT][kLd]: C rows l
  float* bs = smem + kT * kLd;                      // [kT][kLd]: B rows m

  const int Lp = padded(L);
  const int T = Lp / kT;
  int blk = blockIdx.x;
  const int tile = blk % (T * (T + 1) / 2);
  blk /= T * (T + 1) / 2;
  const int c = blk % nc;
  const int bi = blk / nc;
  int i = 0;                                        // tile -> (i, j <= i)
  while ((i + 1) * (i + 2) / 2 <= tile) ++i;
  const int j = tile - i * (i + 1) / 2;
  const int t0 = c * L;
  const int lc = min(L, S - t0);                    // real rows
  if (i * kT >= lc) return;                         // no query reads it
  const size_t row0 = static_cast<size_t>(bi) * S + t0;

  // two column halves, two commit groups
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (int e = threadIdx.x; e < kT * kHalf; e += kCbThreads) {
      const int r = e / kHalf, v = h * kHalf + e % kHalf;
      const int l = i * kT + r, m = j * kT + r;
      cp_async16(cs + r * kLd + 4 * v,
                 Cm + (row0 + (l < lc ? l : 0)) * N + 4 * v, l < lc ? 16 : 0);
      cp_async16(bs + r * kLd + 4 * v,
                 Bm + (row0 + (m < lc ? m : 0)) * N + 4 * v, m < lc ? 16 : 0);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  float acc[2][4][4] = {};
  auto at = [&](int r, int k) { return cs[r * kLd + k]; };
  auto bt = [&](int k, int n) { return bs[n * kLd + k]; };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k0 = h * N / 2; k0 < (h + 1) * N / 2; k0 += 8) {
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) a[mt].load(at, wr + 16 * mt, k0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        FragB b;
        b.load(bt, k0, wc + 8 * nt);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], a[mt], b);
      }
    }
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* out = cb + (static_cast<size_t>(bi) * nc + c) * Lp * Lp +
               static_cast<size_t>(i * kT) * Lp + j * kT;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wr + 16 * mt + g, col = wc + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * Lp + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8) * Lp +
                                 col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// ---------------------------------------------------------------------------
// (b) each chunk's own state, and its cum
// ---------------------------------------------------------------------------
template <int P, int N>
struct StCfg {
  static constexpr int kMt = P >= 32 ? 2 : 1;       // m16 tiles a warp (p)
  static constexpr int kWm = P / (16 * kMt);
  static constexpr int kNt = N >= 32 ? 4 : 2;       // n8 tiles a warp (n)
  static constexpr int kWn = N / (8 * kNt);
  static constexpr int kThreads = 32 * kWm * kWn;
  static constexpr int kKt = 32;                    // tokens a stage
  static constexpr int kLdx = P + 8;                // pitch / 8 odd
  static constexpr int kLdb = N + 8;
  static constexpr int kStage = kKt * (kLdx + kLdb);   // floats
  static size_t bytes(int Lp) {
    return sizeof(float) * (2 * static_cast<size_t>(kStage) + 2 * Lp);
  }
};

// cum = cumsum(dts * a) over Lp rows by warp 0 (a run of Lp / 32 rows a
// lane, then a shuffle scan of the lane totals)
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cum,
                                             float a, int Lp) {
  const int lane = threadIdx.x;
  const int per = Lp / 32;
  const int lo = lane * per;
  float run = 0.0f;
  for (int r = lo; r < lo + per; ++r) {
    run += dts[r] * a;
    cum[r] = run;
  }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, tot, o);
    if (lane >= o) tot += v;
  }
  const float off = tot - run;
  for (int r = lo; r < lo + per; ++r) cum[r] += off;
}

template <int P, int N>
__global__ void __launch_bounds__(StCfg<P, N>::kThreads)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ A,
                  float* __restrict__ states, float* __restrict__ cum_out,
                  int S, int H, int L, int nc) {
  using Cfg = StCfg<P, N>;
  constexpr int kKt = Cfg::kKt, kLdx = Cfg::kLdx, kLdb = Cfg::kLdb;
  constexpr int kXv = P / 4, kBv = N / 4;
  extern __shared__ __align__(16) float smem[];
  const int Lp = padded(L);
  float* ring = smem;                               // 2 x [xs | bs]
  float* cum = smem + 2 * Cfg::kStage;              // [Lp]
  float* w = cum + Lp;                              // [Lp]: dt, then weights

  const int tid = threadIdx.x;
  const int h = blockIdx.x % H;
  const int c = (blockIdx.x / H) % nc;
  const int bi = blockIdx.x / (H * nc);
  const int t0 = c * L;
  const int lc = min(L, S - t0);
  const size_t row0 = static_cast<size_t>(bi) * S + t0;

  auto stage = [&](int kt, int s) {
    float* xs = ring + s * Cfg::kStage;
    float* bs = xs + kKt * kLdx;
    const int k0 = kt * kKt;
    for (int e = tid; e < kKt * kXv; e += Cfg::kThreads) {
      const int r = e / kXv, v = e % kXv, m = k0 + r;
      const bool ok = m < lc;
      cp_async16(xs + r * kLdx + 4 * v,
                 x + ((row0 + (ok ? m : 0)) * H + h) * P + 4 * v,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < kKt * kBv; e += Cfg::kThreads) {
      const int r = e / kBv, v = e % kBv, m = k0 + r;
      const bool ok = m < lc;
      cp_async16(bs + r * kLdb + 4 * v, Bm + (row0 + (ok ? m : 0)) * N + 4 * v,
                 ok ? 16 : 0);
    }
  };
  const int n_kt = (lc + kKt - 1) / kKt;
  stage(0, 0);                      // the first tile flies during the cumsum
  cp_async_commit();

  for (int r = tid; r < Lp; r += Cfg::kThreads)
    w[r] = r < lc ? dt[(row0 + r) * H + h] : 0.0f;
  __syncthreads();
  if (tid < 32) chunk_cumsum(w, cum, A[bi * H + h], Lp);
  __syncthreads();
  const float total = cum[Lp - 1];
  float* cum_g = cum_out + ((static_cast<size_t>(bi) * H + h) * nc + c) * Lp;
  for (int r = tid; r < Lp; r += Cfg::kThreads) {
    cum_g[r] = cum[r];
    w[r] *= expf(total - cum[r]);    // exp(cum_L - cum_m) dt_m
  }

  const int warp = tid / 32;
  const int pr = (warp / Cfg::kWn) * 16 * Cfg::kMt;
  const int nc0 = (warp % Cfg::kWn) * 8 * Cfg::kNt;
  float acc[Cfg::kMt][Cfg::kNt][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                 // tile kt (and the weights) are in
    const float* xs = ring + (kt & 1) * Cfg::kStage;
    const float* bs = xs + kKt * kLdx;
    const float* wk = w + kt * kKt;
    // A(p, m) = x_m[p] w_m (xs is [m][p]); B(m, n) = B_m[n]
    auto at = [&](int p, int m) { return xs[m * kLdx + p] * wk[m]; };
    auto bt = [&](int m, int n) { return bs[m * kLdb + n]; };
#pragma unroll
    for (int k0 = 0; k0 < kKt; k0 += 8) {
      FragA a[Cfg::kMt];
#pragma unroll
      for (int mt = 0; mt < Cfg::kMt; ++mt) a[mt].load(at, pr + 16 * mt, k0);
#pragma unroll
      for (int nt = 0; nt < Cfg::kNt; ++nt) {
        FragB b;
        b.load(bt, k0, nc0 + 8 * nt);
#pragma unroll
        for (int mt = 0; mt < Cfg::kMt; ++mt) mma3(acc[mt][nt], a[mt], b);
      }
    }
    __syncthreads();                 // the stage is consumed before reuse
  }
  cp_async_wait<0>();

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* out = states + ((static_cast<size_t>(bi) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int mt = 0; mt < Cfg::kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::kNt; ++nt) {
      const int p = pr + 16 * mt + g, n = nc0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(out + p * N + n) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (p + 8) * N + n) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// ---------------------------------------------------------------------------
// (c) the state pass
// ---------------------------------------------------------------------------
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 8;       // chunks whose loads fly together

__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                float* __restrict__ h_final, int H, int PN, int nc, int Lp) {
  const int per = PN / 4;                           // float4s a stream
  const int blocks = (per + kPassThreads - 1) / kPassThreads;
  const int bh = blockIdx.x / blocks;
  const int e = (blockIdx.x % blocks) * kPassThreads + threadIdx.x;
  if (e >= per) return;
  const int bi = bh / H, h = bh % H;
  const float* cum_s = cum + static_cast<size_t>(bh) * nc * Lp + Lp - 1;
  auto at = [&](int c) {
    return reinterpret_cast<float4*>(
               states + ((static_cast<size_t>(bi) * nc + c) * H + h) * PN) +
           e;
  };
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    // a batch's loads all in flight before the chain uses them
    float4 own[kPassBatch];
    float d[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) {
        own[i] = *at(c0 + i);
        d[i] = expf(cum_s[static_cast<size_t>(c0 + i) * Lp]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) {
        *at(c0 + i) = s;             // the state before chunk c0 + i
        s = make_float4(fmaf(s.x, d[i], own[i].x), fmaf(s.y, d[i], own[i].y),
                        fmaf(s.z, d[i], own[i].z), fmaf(s.w, d[i], own[i].w));
      }
    }
  }
  reinterpret_cast<float4*>(h_final + static_cast<size_t>(bh) * PN)[e] = s;
}

// ---------------------------------------------------------------------------
// (d) the chunk outputs
// ---------------------------------------------------------------------------
constexpr int kOutThreads = 128;    // 4 warps, 16 query rows each, all of P
constexpr int kKs = 32;             // keys a step of the intra-chunk term

template <int P, int N>
struct OutCfg {
  static constexpr int kNt = P / 8;                 // n8 tiles a warp (p)
  static constexpr int kKi = N < 32 ? N : 32;       // n a step of the inter
  static constexpr int kLdi = kKi + 4;              // C and h rows: / 4 odd
  static constexpr int kLdw = kKs + 4;              // cb rows: / 4 odd
  static constexpr int kLdx = P + 8;                // x rows: / 8 odd
  // a step's operands, in one stage of the ring: the inter-chunk term's
  // C [kT][kLdi] and h_prev [P][kLdi], or the intra-chunk term's cb
  // [kT][kLdw], x [kKs][kLdx], dt [kKs] and cum [kKs]
  static constexpr int kInter = (kT + P) * kLdi;
  static constexpr int kIntra = kT * kLdw + kKs * kLdx + 2 * kKs;
  static constexpr int kStage = kInter > kIntra ? kInter : kIntra;
  // two stages, then the query rows' cum, f_m and e_l
  static constexpr size_t kBytes =
      sizeof(float) * (2 * static_cast<size_t>(kStage) + kT + kKs + kT);
  static_assert(kStage % 4 == 0 && kT * kLdw % 4 == 0 && kKs * kLdx % 4 == 0,
                "16-byte aligned regions");
};

template <int P, int N>
__global__ void __launch_bounds__(kOutThreads)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ cb, const float* __restrict__ cum,
               const float* __restrict__ h_prev, float* __restrict__ y,
               int S, int H, int L, int nc) {
  using Cfg = OutCfg<P, N>;
  constexpr int kKi = Cfg::kKi, kLdi = Cfg::kLdi, kLdw = Cfg::kLdw,
                kLdx = Cfg::kLdx;
  extern __shared__ __align__(16) float smem[];
  float* cumq = smem + 2 * Cfg::kStage;             // [kT]: query rows' cum
  float* fk = cumq + kT;              // [kKs]: exp(cum_end - cum_m) dt_m
  float* eq = fk + kKs;               // [kT]: exp(cum_l - cum_end)

  const int Lp = padded(L);
  const int QT = Lp / kT;
  // the query tiles of a (b, h, chunk) next to each other (they share its
  // x tiles and h_prev), the heads of a (b, chunk) next (they share its
  // C.B^T and C): what they read twice comes from L2
  const int qt = QT - 1 - static_cast<int>(blockIdx.x % QT);
  const int rest = blockIdx.x / QT;
  const int h = rest % H;
  const int c = (rest / H) % nc;
  const int bi = rest / (H * nc);
  const int t0 = c * L;
  const int lc = min(L, S - t0);
  const int q0 = qt * kT;
  if (q0 >= lc) return;
  const size_t row0 = static_cast<size_t>(bi) * S + t0;
  const int bh = bi * H + h;
  const float* cum_c = cum + (static_cast<size_t>(bh) * nc + c) * Lp;
  const float* hp =
      h_prev + ((static_cast<size_t>(bi) * nc + c) * H + h) * P * N;
  const float* cb_q = cb + (static_cast<size_t>(bi) * nc + c) * Lp * Lp +
                      static_cast<size_t>(q0) * Lp;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31, g = lane >> 2;
  const int wr = 16 * warp;                         // the warp's query rows
  for (int r = tid; r < kT; r += kOutThreads) cumq[r] = cum_c[q0 + r];

  // the steps: N / kKi of the inter-chunk term (none for the first chunk,
  // whose h_prev is 0), then the key steps of kKs up to the diagonal and
  // the chunk's last real row
  const int n_inter = c > 0 ? N / kKi : 0;
  const int n_keys = min(q0 + kT, lc);
  const int n_steps = n_inter + (n_keys + kKs - 1) / kKs;
  auto load = [&](int st, int s) {
    float* base = smem + s * Cfg::kStage;
    if (st < n_inter) {
      float* cs = base;                             // [kT][kLdi]
      float* hs = base + kT * kLdi;                 // [P][kLdi]
      const int n0 = st * kKi;
      constexpr int kV = kKi / 4;
      for (int e = tid; e < kT * kV; e += kOutThreads) {
        const int r = e / kV, v = e % kV, l = q0 + r;
        const bool ok = l < lc;
        cp_async16(cs + r * kLdi + 4 * v,
                   Cm + (row0 + (ok ? l : 0)) * N + n0 + 4 * v, ok ? 16 : 0);
      }
      for (int e = tid; e < P * kV; e += kOutThreads) {
        const int r = e / kV, v = e % kV;
        cp_async16(hs + r * kLdi + 4 * v, hp + r * N + n0 + 4 * v, 16);
      }
    } else {
      float* ws = base;                             // [kT][kLdw]: cb
      float* xs = ws + kT * kLdw;                   // [kKs][kLdx]: x rows
      float* dts = xs + kKs * kLdx;                 // [kKs]
      float* cumk = dts + kKs;                      // [kKs]
      const int k0 = (st - n_inter) * kKs;
      constexpr int kWv = kKs / 4, kXv = P / 4;
      for (int e = tid; e < kT * kWv; e += kOutThreads) {
        const int r = e / kWv, v = e % kWv;
        cp_async16(ws + r * kLdw + 4 * v,
                   cb_q + static_cast<size_t>(r) * Lp + k0 + 4 * v, 16);
      }
      for (int e = tid; e < kKs * kXv; e += kOutThreads) {
        const int r = e / kXv, v = e % kXv, m = k0 + r;
        const bool ok = m < lc;
        cp_async16(xs + r * kLdx + 4 * v,
                   x + ((row0 + (ok ? m : 0)) * H + h) * P + 4 * v,
                   ok ? 16 : 0);
      }
      for (int r = tid; r < kKs; r += kOutThreads) {
        const int m = k0 + r;
        const bool ok = m < lc;
        cp_async4(dts + r, dt + (row0 + (ok ? m : 0)) * H + h, ok ? 4 : 0);
      }
      for (int v = tid; v < kWv; v += kOutThreads)
        cp_async16(cumk + 4 * v, cum_c + k0 + 4 * v, 16);
    }
  };

  float acc[Cfg::kNt][4] = {};
  // acc[nt] += A(rows wr.., k) . B(k, cols 8 nt..) over the warp's k-steps
  auto product = [&](auto&& at, auto&& bt, int k_steps) {
    for (int ks = 0; ks < k_steps; ++ks) {
      FragA a;
      a.load(at, wr, 8 * ks);
#pragma unroll
      for (int nt = 0; nt < Cfg::kNt; ++nt) {
        FragB b;
        b.load(bt, 8 * ks, 8 * nt);
        mma3(acc[nt], a, b);
      }
    }
  };

  load(0, 0);
  cp_async_commit();
  for (int st = 0; st < n_steps; ++st) {
    if (st + 1 < n_steps) load(st + 1, (st + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                 // step st (and cumq) is in
    const float* base = smem + (st & 1) * Cfg::kStage;
    if (st < n_inter) {
      // ---- exp(cum_l) C_l . h_prev, kKi of n a step ----
      const float* cs = base;
      const float* hs = base + kT * kLdi;
      product([&](int r, int k) { return cs[r * kLdi + k]; },
              [&](int k, int p) { return hs[p * kLdi + k]; }, kKi / 8);
      if (st == n_inter - 1) {
        const float e0 = expf(cumq[wr + g]), e1 = expf(cumq[wr + g + 8]);
#pragma unroll
        for (int nt = 0; nt < Cfg::kNt; ++nt) {
          acc[nt][0] *= e0;
          acc[nt][1] *= e0;
          acc[nt][2] *= e1;
          acc[nt][3] *= e1;
        }
      }
    } else {
      // ---- W . x over kKs keys: W(l, m) = cb exp(cum_l - cum_m) dt_m ----
      const float* ws = base;
      const float* xs = ws + kT * kLdw;
      const float* dts = xs + kKs * kLdx;
      const float* cumk = dts + kKs;
      const int k0 = (st - n_inter) * kKs;
      auto bt = [&](int k, int p) { return xs[k * kLdx + p]; };
      if (k0 + kKs > q0) {
        // keys past the tile's first query: the decay masked BEFORE the
        // exp (above the diagonal cum_l - cum_m > 0 would overflow); a
        // warp's k-steps end at its last row
        const int dk = k0 - q0;
        const int k_steps = min(max((wr + 16 - dk + 7) / 8, 0), kKs / 8);
        product([&](int r, int k) {
          const float arg = k + dk <= r ? cumq[r] - cumk[k] : -INFINITY;
          return ws[r * kLdw + k] * expf(arg) * dts[k];
        }, bt, k_steps);
      } else {
        // every key before every query: exp(cum_l - cum_m) = e_l f_m, both
        // <= 1 (cum falls, A < 0), so neither overflows, and an exp a row
        // and a key instead of one a pair
        const float end = cumk[kKs - 1];
        if (tid < kKs)
          fk[tid] = expf(end - cumk[tid]) * dts[tid];
        else if (tid < kKs + kT)
          eq[tid - kKs] = expf(cumq[tid - kKs] - end);
        __syncthreads();
        product([&](int r, int k) { return ws[r * kLdw + k] * eq[r] * fk[k]; },
                bt, kKs / 8);
      }
    }
    __syncthreads();                 // the stage is consumed before reuse
  }
  cp_async_wait<0>();

  // ---- y = acc + D x ----
  const int t = lane & 3;
  const float d = D[bh];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = q0 + wr + g + 8 * half;
    if (l >= lc) continue;
    const size_t at = ((row0 + l) * H + h) * P;
#pragma unroll
    for (int nt = 0; nt < Cfg::kNt; ++nt) {
      const int p = 8 * nt + 2 * t;
      const float2 xv = *reinterpret_cast<const float2*>(x + at + p);
      *reinterpret_cast<float2*>(y + at + p) =
          make_float2(fmaf(d, xv.x, acc[nt][2 * half]),
                      fmaf(d, xv.y, acc[nt][2 * half + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// the launcher
// ---------------------------------------------------------------------------
struct Args {
  const float *x, *dt, *B, *C, *A, *D;
  float *y, *h_final, *cb, *cum, *states;
  int batch, S, H, L, nc;
};

template <int P, int N>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr auto cb_k = ssd_cb_kernel<N>;
  constexpr auto st_k = ssd_states_kernel<P, N>;
  constexpr auto out_k = ssd_out_kernel<P, N>;
  using St = StCfg<P, N>;
  using Out = OutCfg<P, N>;
  cudaError_t err = allow_smem<cb_k>(CbCfg<N>::kBytes);
  if (err == cudaSuccess) err = allow_smem<st_k>(St::bytes(kMaxChunk));
  if (err == cudaSuccess) err = allow_smem<out_k>(Out::kBytes);
  if (err != cudaSuccess) return err;
  const int Lp = padded(a.L), T = Lp / kT;
  const long long streams = static_cast<long long>(a.batch) * a.H;
  if (a.nc > 0) {
    const long long cb_blocks =
        static_cast<long long>(a.batch) * a.nc * (T * (T + 1) / 2);
    const long long out_blocks = streams * a.nc * T;
    if (cb_blocks > INT32_MAX || out_blocks > INT32_MAX)
      return cudaErrorInvalidValue;
    ssd_cb_kernel<N><<<static_cast<unsigned>(cb_blocks), kCbThreads,
                       CbCfg<N>::kBytes, s>>>(a.B, a.C, a.cb, a.S, a.L, a.nc);
    ssd_states_kernel<P, N><<<static_cast<unsigned>(streams * a.nc),
                              St::kThreads, St::bytes(Lp), s>>>(
        a.x, a.dt, a.B, a.A, a.states, a.cum, a.S, a.H, a.L, a.nc);
  }
  const int per = P * N / 4;
  const long long pass_blocks =
      streams * ((per + kPassThreads - 1) / kPassThreads);
  ssd_pass_kernel<<<static_cast<unsigned>(pass_blocks), kPassThreads, 0, s>>>(
      a.states, a.cum, a.h_final, a.H, P * N, a.nc, Lp);
  if (a.nc > 0)
    ssd_out_kernel<P, N><<<static_cast<unsigned>(streams * a.nc * T),
                           kOutThreads, Out::kBytes, s>>>(
        a.x, a.dt, a.C, a.D, a.cb, a.cum, a.states, a.y, a.S, a.H, a.L,
        a.nc);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(int N, const Args& a, cudaStream_t s) {
  switch (N) {
    case 16: return launch<P, 16>(a, s);
    case 32: return launch<P, 32>(a, s);
    case 64: return launch<P, 64>(a, s);
    case 128: return launch<P, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the four kernels on `stream`; returns cudaGetLastError() (0 on
// success).  All operands fp32 and contiguous, x, B, C, cb and states
// 16-byte aligned: x / y (batch, S, H, P), dt (batch, S, H), B / C (batch,
// S, N), A / D (batch * H), h_final (batch, H, P, N); the workspaces cb
// (batch, nc, Lp, Lp), cum (batch, H, nc, Lp) and states (batch, nc, H, P,
// N), nc = ceil(S / L), Lp = L rounded up to a multiple of 64.  P in {16,
// 32, 64}, N in {16, 32, 64, 128}, 1 <= L <= 1024, batch * H >= 1.
int ssd_scan_launch(const void* x, const void* dt, const void* B,
                    const void* C, const void* A, const void* D, void* y,
                    void* h_final, void* cb, void* cum, void* states,
                    int batch, int S, int H, int P, int N, int L,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > kMaxChunk || batch < 1 || H < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(B), static_cast<const float*>(C),
               static_cast<const float*>(A), static_cast<const float*>(D),
               static_cast<float*>(y),       static_cast<float*>(h_final),
               static_cast<float*>(cb),      static_cast<float*>(cum),
               static_cast<float*>(states),  batch, S, H, L,
               (S + L - 1) / L};
  cudaError_t err = cudaErrorInvalidValue;
  switch (P) {
    case 16: err = launch_n<16>(N, a, s); break;
    case 32: err = launch_n<32>(N, a, s); break;
    case 64: err = launch_n<64>(N, a, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

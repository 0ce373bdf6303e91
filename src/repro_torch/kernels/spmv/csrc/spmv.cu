// ELL sparse matrix-vector product for Hopper (sm_90a), in two idioms, CUDA
// C++ with a plain C interface (loaded with ctypes by kernels/spmv/kernel.py).
//
// Replaces the TPU kernel `_spmv_take_kernel` (src/repro/kernels/spmv/
// kernel.py:24, pallas_call at :56), the gather idiom.  Same function:
//   y[r] = sum_k vals[r, k] * x[cols[r, k]]
// over vals (R, K) fp32, cols (R, K) int32 and a dense x (C,) fp32, into
// y (R, 1); a column outside [0, C) adds nothing (memory stays safe
// without a host check; the plain version raises on such a column).  On
// the TPU, x sits whole in VMEM and each row block gathers from it; here x
// is gathered through the read-only path from L1 and L2.
//
// What bounds it: device memory, then L2.  Each nonzero moves 8 bytes
// (value and column) for 2 operations; at R = C = 2^22 and K = 16 the
// function moves 570 MB (vals, cols, x once, y), 0.170 ms at 3.35 TB/s on
// an H100 SXM.  (1) The stream of vals and cols has to keep enough bytes in
// flight to cover the memory's latency: a thread that loads its nonzeros
// and then waits on the gather they address has none in flight while it
// waits.  (2) Each random gather misses L1 and fetches a 32-byte sector of
// x (16 MiB at that size, inside the 50 MB L2) from L2 for 4 useful bytes:
// 2^26 of them move 2.1 GB between L2 and the SMs, which the bound does
// not count.  On the card (2^22 x 16, PERF.md) (1) takes the stream to
// 0.21 ms with unit-stride columns, and (2) holds random columns at
// ~0.58 ms: columns drawn from 4 MB of x (in L2) cost as much as from all
// 16 MiB, from 64 KB (in L1) a third of that.  Design:
//  - a persistent grid, `sms x blocks a SM` blocks (kernel.take_plan);
//    each walks tiles of consecutive rows, tile t, t + grid, ...;
//  - a ring of 2-4 stages in shared memory, each a tile's vals and cols,
//    filled by one producer thread with 1-D bulk copies (TMA,
//    `cp.async.bulk`) that complete on the stage's "full" mbarrier, with
//    an evict-first L2 policy so that x's lines stay in L2 against the
//    stream; the next tiles' bytes are on their way while a tile's
//    gathers wait, which is (1);
//  - eight consumer warps: a row goes to G lanes (the power of two at or
//    above K / 4, at most 32), and each lane takes 4 consecutive nonzeros
//    of its row with one 16-byte shared load of columns and one of values:
//    4 independent gathers a lane a row, times RPG rows (block_multiplier:
//    the rows a lane group takes a stage), all issued before the first is
//    used, so (2) runs at L2's rate, not its latency;
//  - a warp frees its stage (an arrive on the stage's "empty" mbarrier) as
//    soon as its nonzeros are in registers, before its gathers return,
//    after a `fence.proxy.async`: the refill is written by the async proxy
//    and must not overtake the reads (without it, rows came out wrong);
//  - the blocks of an SM take at most 132 KB of shared memory, so L1
//    keeps 124 KB for the gathers (kernel.TAKE_SMEM_PER_SM);
//  - the lanes of a row meet in a shuffle-xor reduction in a fixed order
//    and lane 0 writes y[r]: no atomics, the same bits every call.
// Where K % 4 != 0, an operand starts off a 16-byte boundary or no block
// would walk a second tile, the binding's plan takes the general path, the
// first design (a scalar load of a column and a value a lane):
//  - a group of G lanes per row, G the power of two at or above K (at most
//    32): lane l takes nonzeros l, l+G, ...; for K = 16 a warp reads two
//    rows' values and columns as one 128-byte line each;
//  - each group walks RPG rows (block_multiplier), RPG * (256 / G)
//    consecutive rows per block, so each step of the walk is coalesced and
//    a thread has RPG independent gathers in flight;
//  - the group's partial sums meet in a shuffle-xor reduction, and lane 0
//    of the group writes y[r].
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

// take idiom, vector path: a persistent block of eight consumer warps and
// one producer warp over a ring of `stages` tiles of kTileRows rows
constexpr int kTakeConsumers = 256;
constexpr int kTakeThreads = kTakeConsumers + 32;
constexpr int kTakeMaxStages = 4;
constexpr int kTakeSmemLimit = 227 * 1024;    // a block's shared memory
constexpr int kBlockReserved = 1024;          // shared memory the system keeps

// blocks a SM the plan counts on at each RPG (kernel.TAKE_BLOCKS_PER_SM):
// the registers are held to that many
__host__ __device__ constexpr int take_min_blocks(int rpg) {
  return rpg == 1 ? 4 : rpg == 2 ? 3 : rpg == 4 ? 2 : 1;
}

// dynamic shared memory of the ring: each stage a tile's vals and cols,
// then a "full" and an "empty" mbarrier a stage
__host__ __device__ constexpr int take_smem_bytes(int K, int lanes, int rpg,
                                                  int stages) {
  return stages * (2 * (kTakeConsumers / lanes) * rpg * K * 4 + 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`; the lines it brings into L2 go
// first when L2 evicts (`policy`: evict-first), so x's stay
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// x[c], or 0 for a column outside [0, C); through L1, which holds the
// lines of the gathers in flight and x's hot lines (an L1::no_allocate
// load was slower)
__device__ __forceinline__ float take_x(const float* __restrict__ x, int c,
                                        int C) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(C) ? __ldg(x + c)
                                                             : 0.f;
}

template <int G, int RPG>
__global__ void __launch_bounds__(kTakeThreads, take_min_blocks(RPG))
    spmv_take_kernel(const float* __restrict__ vals,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ x, float* __restrict__ y,
                     int R, int K, int C, int stages, long long ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kGroups = kTakeConsumers / G;
  constexpr int kTileRows = kGroups * RPG;
  const int half = kTileRows * K * 4;       // bytes of a tile's vals (cols)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * stages * half);
  uint64_t* empty = full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kTakeConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTakeConsumers) {      // the producer warp
    if (threadIdx.x != kTakeConsumers) return;
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    int s = 0;
    unsigned round = 0;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      if (round > 0) mbar_wait(smem_u32(empty + s), (round - 1) & 1);
      const long long r0 = t * kTileRows;
      const uint32_t bytes = static_cast<uint32_t>(
          min(static_cast<long long>(kTileRows), R - r0) * K * 4);
      const uint32_t bar = smem_u32(full + s);
      mbar_expect_tx(bar, 2 * bytes);
      bulk_load(smem_u32(smem + 2 * s * half), vals + r0 * K, bytes, bar,
                policy);
      bulk_load(smem_u32(smem + (2 * s + 1) * half), cols + r0 * K, bytes,
                bar, policy);
      if (++s == stages) {
        s = 0;
        ++round;
      }
    }
    return;
  }

  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int quads = K / 4;
  int s = 0;
  unsigned round = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long r0 = t * kTileRows;
    mbar_wait(smem_u32(full + s), round & 1);
    const float4* vs = reinterpret_cast<const float4*>(smem + 2 * s * half);
    const int4* cs =
        reinterpret_cast<const int4*>(smem + (2 * s + 1) * half);
    float acc[RPG];
#pragma unroll
    for (int j = 0; j < RPG; ++j) acc[j] = 0.f;
    for (int q0 = 0; q0 < quads; q0 += G) {   // one pass while K <= 4 G
      const int q = q0 + lane;
      int4 c[RPG];
      float4 v[RPG];
#pragma unroll
      for (int j = 0; j < RPG; ++j) {
        const int row = j * kGroups + group;
        const bool ok = q < quads && r0 + row < R;
        c[j] = ok ? cs[row * quads + q] : make_int4(-1, -1, -1, -1);
        v[j] = ok ? vs[row * quads + q] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (q0 + G >= quads) {                  // the stage is read: free it
        // the refill is a write of the async proxy: order this thread's
        // reads of the stage (generic proxy) before it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(smem_u32(empty + s));
      }
      float4 xv[RPG];
#pragma unroll
      for (int j = 0; j < RPG; ++j) {
        xv[j].x = take_x(x, c[j].x, C);
        xv[j].y = take_x(x, c[j].y, C);
        xv[j].z = take_x(x, c[j].z, C);
        xv[j].w = take_x(x, c[j].w, C);
      }
#pragma unroll
      for (int j = 0; j < RPG; ++j) {
        acc[j] = fmaf(v[j].x, xv[j].x, acc[j]);
        acc[j] = fmaf(v[j].y, xv[j].y, acc[j]);
        acc[j] = fmaf(v[j].z, xv[j].z, acc[j]);
        acc[j] = fmaf(v[j].w, xv[j].w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2) {
        acc[j] += __shfl_xor_sync(kFull, acc[j], off, G);
      }
      const long long r = r0 + j * kGroups + group;
      if (lane == 0 && r < R) y[r] = acc[j];
    }
    if (++s == stages) {
      s = 0;
      ++round;
    }
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

// the shared-memory share of an SM's L1 for this kernel, as a percent of
// the most an SM has, set again only when the plan asks for another
template <auto kernel>
cudaError_t set_carveout(int percent) {
  static int last[64] = {};         // one a device, 0 for not set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || last[dev] == percent) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
  if (err == cudaSuccess) last[dev] = percent;
  return err;
}

template <int G, int RPG>
cudaError_t launch_take(const float* vals, const int32_t* cols,
                        const float* x, float* y, int R, int K, int C,
                        int stages, int grid, int blocks_per_sm,
                        cudaStream_t s) {
  const int smem = take_smem_bytes(K, G, RPG, stages);
  cudaError_t err = allow_smem<spmv_take_kernel<G, RPG>>(kTakeSmemLimit);
  if (err != cudaSuccess) return err;
  int dev = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  // enough shared memory for the plan's blocks a SM, the rest L1 (where
  // hot columns of x stay)
  const long long need =
      static_cast<long long>(blocks_per_sm) * (smem + kBlockReserved);
  const long long percent = (100 * need + per_sm - 1) / per_sm;
  err = set_carveout<spmv_take_kernel<G, RPG>>(
      static_cast<int>(percent < 100 ? percent : 100));
  if (err != cudaSuccess) return err;
  constexpr int kTileRows = kTakeConsumers / G * RPG;
  const long long ntiles = (static_cast<long long>(R) + kTileRows - 1) /
                           kTileRows;
  spmv_take_kernel<G, RPG><<<grid, kTakeThreads, smem, s>>>(
      vals, cols, x, y, R, K, C, stages, ntiles);
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

// The vector path of the take idiom: vals (R, K) fp32, cols (R, K) int32,
// both contiguous and 16-byte aligned, K a multiple of 4; x (C,) fp32,
// y (R,) fp32.  `lanes` (G: 1, 2, 4, ..., 32 a row), `rpg` (rows a lane
// group takes a stage: 1, 2, 4 or 8), `stages` (1 to 4), `grid` blocks,
// `blocks_per_sm` the blocks the plan counts on an SM (it sets the
// shared-memory carveout), as kernel.take_plan gives them.  Launches on
// `stream` and returns a CUDA error code (0 on success).
int spmv_take_launch(const void* vals, const void* cols, const void* x,
                     void* y, int R, int K, int C, int lanes, int rpg,
                     int stages, int grid, int blocks_per_sm, void* stream) {
  if (R <= 0) return 0;
  if (K <= 0 || K % 4 || C < 0 || stages < 1 || stages > kTakeMaxStages ||
      grid < 1 || blocks_per_sm < 1 ||
      (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(cols)) %
          16 ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (rpg != 1 && rpg != 2 && rpg != 4 && rpg != 8) ||
      static_cast<long long>(stages) *
              (2LL * (kTakeConsumers / lanes) * rpg * K * 4 + 16) >
          kTakeSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaError_t err = cudaErrorInvalidValue;
#define TAKE(G_, RPG_)                                                   \
  if (lanes == G_ && rpg == RPG_)                                        \
    err = launch_take<G_, RPG_>(v, c, xf, yf, R, K, C, stages, grid,     \
                                blocks_per_sm, s);
#define TAKE_G(G_) TAKE(G_, 1) TAKE(G_, 2) TAKE(G_, 4) TAKE(G_, 8)
  TAKE_G(1) TAKE_G(2) TAKE_G(4) TAKE_G(8) TAKE_G(16) TAKE_G(32)
#undef TAKE_G
#undef TAKE
  return static_cast<int>(err);
}

// The ring's dynamic shared memory in bytes (kernel.take_smem_bytes).
int spmv_take_smem_bytes(int K, int lanes, int rpg, int stages) {
  return take_smem_bytes(K, lanes, rpg, stages);
}

// The blocks of the vector path's kernel that fit on one SM with `smem`
// bytes of dynamic shared memory (after a launch has set its carveout),
// or minus a CUDA error code.
int spmv_take_occupancy(int lanes, int rpg, int smem) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define OCC(G_, RPG_)                                                    \
  if (lanes == G_ && rpg == RPG_)                                        \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
        &n, spmv_take_kernel<G_, RPG_>, kTakeThreads, smem);
#define OCC_G(G_) OCC(G_, 1) OCC(G_, 2) OCC(G_, 4) OCC(G_, 8)
  OCC_G(1) OCC_G(2) OCC_G(4) OCC_G(8) OCC_G(16) OCC_G(32)
#undef OCC_G
#undef OCC
  return err == cudaSuccess ? n : -static_cast<int>(err);
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

// Tiled GEMM for Hopper (sm_90a), fp32 and fp64, CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/gemm/kernel.py).
//
// Replaces the TPU kernel `_gemm_kernel` (src/repro/kernels/gemm/
// kernel.py:24, pallas_call at :48): C (M, N) = A (M, K) @ B (K, N), all
// row-major.  `block_multiplier` m scales the block tile, as it scales the
// TPU's 128 x 128 MXU tile (the paper's LMUL axis, Fig 7): m = 1, 2, 4, 8
// -> BM x BN = 64 x 64, 128 x 128, 256 x 128, 256 x 256, K in slices of
// BK = 16.  kernel.plan computes the same tiles, stages and grid.
//
// Precision.  fp32 stays fp32 throughout: plain FMAs on the CUDA cores, no
// TF32, like the JAX kernel's fp32 accumulator.  fp64 accumulates in fp64.
// The JAX kernel accumulates f64 inputs in an fp32 scratch
// (`preferred_element_type=jnp.float32`) because the TPU has no f64 matrix
// unit; its relative error against f64 is ~1e-7.  The H100 computes in
// fp64 natively and the paper's DGEMM is f64, so that adaptation is not
// carried over: this kernel's fp64 result agrees with an f64 product to
// ~1e-15.
//
// What bounds it: operations.  At 4096^3, 137 GFLOP against 201 MB (fp32)
// or 403 MB (fp64) of operands; the card's ceilings are 67 TFLOP/s fp32
// (CUDA cores) and 67 TFLOP/s fp64 (tensor cores, DMMA; the CUDA cores'
// DFMA has half that): 2.05 ms either way on an H100 SXM.
//
// fp64 (`gemm_dmma`): the tensor cores, mma.sync.m16n8k8 f64 (DMMA.16x8x8
// in the SASS; m16n8k4 and m16n8k16 measured no faster), fp64
// accumulators.  8 warps; a warp owns a (BM / WM) x (BN / WN) tile of C as
// 16 x 8 mma tiles.  A and B slices arrive through a three-stage cp.async
// ring; rows are padded by four doubles (32 bytes), so a fragment's 16
// lanes (rows g, k t, or k t, columns g) read 16 different 8-byte bank
// pairs.  The accumulators of a 128 x 128 tile take half the register
// file (one block an SM); at m 4 and 8 they do not fit and spill: Fig 7's
// cliff.
//
// fp32 (`gemm_simt`): the CUDA cores.  256 threads as 16 x 16; thread (ty,
// tx) owns a TM x TN register tile (4 x 4, 8 x 8, 16 x 8, 16 x 16) at rows
// 4 ty + 64 i + (0..3) and columns 4 tx + 64 j + (0..3), read as float4
// from k-major shared tiles: per k, TM / 4 + TN / 4 16-byte loads feed TM x
// TN FMAs.  A is transposed on its way into shared memory by 4-byte
// cp.async; B arrives in 16-byte cp.async chunks; two stages (the next
// slice in flight while one is multiplied).  8 x 8 is held to 128
// registers, so two blocks share an SM; 16 x 16 spills (m 8).
//
// Both: blocks run in groups of eight block rows (`block_origin`).  The
// ragged edge (M, N, K not multiples of the tile) is zero-filled by the
// copies (a source size of 0) and masked on store.  16-byte copies
// need 16-byte rows: A's (fp64) or B's row length a multiple of 16 bytes
// and the base aligned; otherwise the same ring copies element by element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;                // k a stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` (4, 8 or 16) global -> shared; `src_bytes` 0 zero-fills and
// reads nothing
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte chunk (16 / sizeof(T) elements of a row) into shared memory,
// the `n` (may be <= 0) first of them valid: one copy when rows are 16-byte
// aligned (n is then 0 or the whole chunk), else one copy an element
template <typename T, bool kVec>
__device__ __forceinline__ void chunk(uint32_t dst, const T* src, int n,
                                      const T* base) {
  constexpr int kE = 16 / sizeof(T);
  if constexpr (kVec) {
    cp_async<16>(dst, n > 0 ? src : base, n > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      cp_async<sizeof(T)>(dst + e * sizeof(T), e < n ? src + e : base,
                          e < n ? int(sizeof(T)) : 0);
  }
}

// The first row and column of this block's tile of C.  Blocks run in
// groups of kGroup block rows, column by column within a group, so the
// blocks in flight share A's and B's slices in L2 (faster in fp64 than
// row by row on the card; no change in fp32).
constexpr int kGroup = 8;
__device__ __forceinline__ void block_origin(int bm, int bn, int& row0,
                                             int& col0) {
  const int pid = blockIdx.y * gridDim.x + blockIdx.x;
  const int per = kGroup * gridDim.x, first = pid / per * kGroup;
  const int rows = min(int(gridDim.y) - first, kGroup);
  row0 = (first + pid % per % rows) * bm;
  col0 = pid % per / rows * bn;
}

// ---------------------------------------------------------------------------
// fp64: tensor cores (DMMA)
// ---------------------------------------------------------------------------
namespace dmma {

constexpr int kPad = 4;                // doubles a row is padded by
constexpr int kStages = 3;
constexpr int kMmaK = 8;               // m16n8k8: DMMA.16x8x8 in the SASS

template <int BM, int BN>
constexpr int smem_bytes() {
  return kStages * 8 * (BM * (kBK + kPad) + kBK * (BN + kPad));
}

// d (16 x 8) += a (16 x kMmaK) b (kMmaK x 8): a[i] holds row g + 8 (i % 2),
// column t + 4 (i / 2); b[i] row t + 4 i, column g (g = lane / 4, t =
// lane % 4); d[i] row g + 8 (i / 2), column 2 t + i % 2
__device__ __forceinline__ void mma(double* d, const double* a,
                                    const double* b) {
  if constexpr (kMmaK == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (kMmaK == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

template <int BM, int BN, int WM, int WN, bool kVec>
__global__ void __launch_bounds__(32 * WM * WN)
gemm_dmma(const double* __restrict__ A, const double* __restrict__ B,
          double* __restrict__ C, int M, int N, int K) {
  constexpr int kT = 32 * WM * WN;       // threads
  constexpr int MT = BM / WM / 16;       // 16-row mma tiles a warp
  constexpr int NT = BN / WN / 8;        // 8-column mma tiles a warp
  constexpr int kALd = kBK + kPad, kBLd = BN + kPad;
  constexpr int kAStage = BM * kALd, kBStage = kBK * kBLd;  // doubles
  constexpr int kACh = BM * kBK / 2, kBCh = kBK * BN / 2;  // chunks
  static_assert(MT * 16 * WM == BM && NT * 8 * WN == BN, "warp tiling");
  static_assert(kACh % kT == 0 && kBCh % kT == 0, "chunks");
  extern __shared__ __align__(16) double smem_d[];
  double* As = smem_d;                          // [stage][BM][kALd]
  double* Bs = smem_d + kStages * kAStage;      // [stage][kBK][kBLd]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp % WM) * (BM / WM), wn0 = (warp / WM) * (BN / WN);
  int row0, col0;
  block_origin(BM, BN, row0, col0);

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < kACh / kT; ++i) {
      const int e = tid + i * kT;
      const int m = e / (kBK / 2), c = e % (kBK / 2);
      const int gm = row0 + m, gk = k0 + 2 * c;
      const int n = gm < M ? K - gk : 0;
      chunk<double, kVec>(smem_u32(As + stage * kAStage + m * kALd + 2 * c),
                          A + size_t(gm) * K + gk, n, A);
    }
#pragma unroll
    for (int i = 0; i < kBCh / kT; ++i) {
      const int e = tid + i * kT;
      const int k = e / (BN / 2), c = e % (BN / 2);
      const int gk = k0 + k, gn = col0 + 2 * c;
      const int n = gk < K ? N - gn : 0;
      chunk<double, kVec>(smem_u32(Bs + stage * kBStage + k * kBLd + 2 * c),
                          B + size_t(gk) * N + gn, n, B);
    }
  };

  double acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0;

  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();        // slice kt landed; slice kt - 1's readers done
    if (kt + kStages - 1 < n_k)
      load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kBK);
    cp_async_commit();
    const double* as = As + (kt % kStages) * kAStage + (wm0 + g) * kALd + t;
    const double* bs = Bs + (kt % kStages) * kBStage + t * kBLd + wn0 + g;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += kMmaK) {
      double a[MT][kMmaK / 2], b[NT][kMmaK / 4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < kMmaK / 2; ++r)
          a[i][r] = as[(16 * i + 8 * (r % 2)) * kALd + kk + 4 * (r / 2)];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < kMmaK / 4; ++r)
          b[j][r] = bs[(kk + 4 * r) * kBLd + 8 * j];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[i][j], a[i], b[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + wm0 + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = col0 + wn0 + 8 * j + 2 * t;
        double* c = C + size_t(m) * N + n;
        if (n < N) c[0] = acc[i][j][2 * h];
        if (n + 1 < N) c[1] = acc[i][j][2 * h + 1];
      }
    }
}

}  // namespace dmma

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kStages = 2;
constexpr int kPad = 4;                // floats A's k-major rows are padded by

template <int TM, int TN>
constexpr int smem_bytes() {
  return kStages * 4 * (kBK * (16 * TM + kPad) + kBK * 16 * TN);
}

// 8 x 8 is cut to 128 registers, two blocks an SM
template <int TM, int TN, bool kVec>
__global__ void __launch_bounds__(kThreads, TM * TN == 64 ? 2 : 1)
gemm_simt(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int M, int N, int K) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int kALd = BM + kPad;
  constexpr int kAStage = kBK * kALd, kBStage = kBK * BN;   // floats
  constexpr int kAEl = BM * kBK / kThreads;    // A elements a thread copies
  constexpr int kBCh = kBK * BN / 4 / kThreads;   // B chunks a thread copies
  static_assert(kAEl * kThreads == BM * kBK && kBCh * kThreads * 4 == kBK * BN,
                "tile does not divide among the threads");
  extern __shared__ __align__(16) float smem_f[];
  float* As = smem_f;                          // [stage][kBK][kALd], k-major
  float* Bs = smem_f + kStages * kAStage;      // [stage][kBK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int row0, col0;
  block_origin(BM, BN, row0, col0);

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < kAEl; ++i) {           // transposed, 4 bytes a copy
      const int e = tid + i * kThreads;
      const int m = e / kBK, k = e % kBK;
      const bool in = row0 + m < M && k0 + k < K;
      cp_async<4>(smem_u32(As + stage * kAStage + k * kALd + m),
                  in ? A + size_t(row0 + m) * K + k0 + k : A, in ? 4 : 0);
    }
#pragma unroll
    for (int i = 0; i < kBCh; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / (BN / 4), c = e % (BN / 4);
      const int gk = k0 + k, gn = col0 + 4 * c;
      chunk<float, kVec>(smem_u32(Bs + stage * kBStage + k * BN + 4 * c),
                         B + size_t(gk) * N + gn, gk < K ? N - gn : 0, B);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int n_k = (K + kBK - 1) / kBK;
  if (n_k > 0) load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<0>();
    __syncthreads();        // slice kt landed; slice kt - 1's readers done
    if (kt + 1 < n_k) load((kt + 1) % kStages, (kt + 1) * kBK);
    cp_async_commit();
    const float* as = As + (kt % kStages) * kAStage + 4 * ty;
    const float* bs = Bs + (kt % kStages) * kBStage + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i)
        *reinterpret_cast<float4*>(a + 4 * i) =
            *reinterpret_cast<const float4*>(as + kk * kALd + 64 * i);
#pragma unroll
      for (int j = 0; j < TN / 4; ++j)
        *reinterpret_cast<float4*>(b + 4 * j) =
            *reinterpret_cast<const float4*>(bs + kk * BN + 64 * j);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = row0 + 4 * ty + 64 * (i / 4) + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + 4 * tx + 64 * (j / 4) + j % 4;
      if (n < N) C[size_t(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace simt

// above 48 KB a block's shared memory must be asked for (once a kernel)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BM, int BN, int WM, int WN>
int launch_dmma(const void* a, const void* b, void* c, int M, int N, int K,
                bool vec, cudaStream_t s) {
  constexpr int bytes = dmma::smem_bytes<BM, BN>();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  static const cudaError_t attr[2] = {
      allow_smem(dmma::gemm_dmma<BM, BN, WM, WN, false>, bytes),
      allow_smem(dmma::gemm_dmma<BM, BN, WM, WN, true>, bytes)};
  if (attr[vec] != cudaSuccess) return static_cast<int>(attr[vec]);
  auto* kernel = vec ? dmma::gemm_dmma<BM, BN, WM, WN, true>
                     : dmma::gemm_dmma<BM, BN, WM, WN, false>;
  kernel<<<grid, 32 * WM * WN, bytes, s>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<double*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int TM, int TN>
int launch_simt(const void* a, const void* b, void* c, int M, int N, int K,
                bool vec, cudaStream_t s) {
  constexpr int bytes = simt::smem_bytes<TM, TN>();
  const dim3 grid((N + 16 * TN - 1) / (16 * TN),
                  (M + 16 * TM - 1) / (16 * TM));
  static const cudaError_t attr[2] = {
      allow_smem(simt::gemm_simt<TM, TN, false>, bytes),
      allow_smem(simt::gemm_simt<TM, TN, true>, bytes)};
  if (attr[vec] != cudaSuccess) return static_cast<int>(attr[vec]);
  auto* kernel = vec ? simt::gemm_simt<TM, TN, true>
                     : simt::gemm_simt<TM, TN, false>;
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const float*>(a),
                                       static_cast<const float*>(b),
                                       static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// a (M, K), b (K, N), c (M, N), contiguous row-major; dtype 0 = fp32 (the
// CUDA cores), 1 = fp64 (the tensor cores); multiplier in {1, 2, 4, 8}.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int gemm_launch(const void* a, const void* b, void* c, int M, int N, int K,
                int dtype, int multiplier, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const bool vec = N % 4 == 0 && aligned16(b);
    switch (multiplier) {
      case 1: return launch_simt<4, 4>(a, b, c, M, N, K, vec, s);
      case 2: return launch_simt<8, 8>(a, b, c, M, N, K, vec, s);
      case 4: return launch_simt<16, 8>(a, b, c, M, N, K, vec, s);
      case 8: return launch_simt<16, 16>(a, b, c, M, N, K, vec, s);
    }
  } else if (dtype == 1) {
    const bool vec = K % 2 == 0 && N % 2 == 0 && aligned16(a) && aligned16(b);
    switch (multiplier) {
      case 1: return launch_dmma<64, 64, 2, 4>(a, b, c, M, N, K, vec, s);
      case 2: return launch_dmma<128, 128, 2, 4>(a, b, c, M, N, K, vec, s);
      case 4: return launch_dmma<256, 128, 4, 2>(a, b, c, M, N, K, vec, s);
      case 8: return launch_dmma<256, 256, 2, 4>(a, b, c, M, N, K, vec, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Tiled GEMM for Hopper (sm_90a), fp32 and fp64, CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/gemm/kernel.py).
//
// Replaces the TPU kernel `_gemm_kernel` (src/repro/kernels/gemm/
// kernel.py:24, pallas_call at :48): C (M, N) = A (M, K) @ B (K, N), all
// row-major.  `block_multiplier` scales the tile, as it scales the TPU's
// 128 x 128 MXU tile (the paper's LMUL axis, Fig 7).
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
// (CUDA cores) and 67 TFLOP/s fp64 (tensor cores): 2.05 ms either way on
// an H100 SXM.  Design (simple and right first):
//  - 256 threads as 16 x 16; each owns a TM x TN register tile of C at
//    rows ty + 16 i and columns tx + 16 j, so shared-memory reads of B are
//    16 consecutive words (no bank conflict), reads of A broadcast, and
//    stores of C are 16 consecutive elements;
//  - block tile BM = 16 TM by BN = 16 TN; block_multiplier m -> (TM, TN) =
//    1 (4, 4), 2 (8, 4), 4 (8, 8), 8 (16, 8).  At m = 8 an fp64 tile needs
//    256 registers of accumulator and spills: the LMUL cliff of Fig 7;
//  - K advances in slices of 64 bytes (BK 16 fp32 or 8 fp64), A staged
//    transposed (k-major, padded by one) and B as is; the next slice is
//    loaded into registers while the current one is multiplied;
//  - the ragged edge (M, N, K not multiples of the tile) is zero-filled on
//    load and masked on store.
// Known limits, later work: the math runs on CUDA cores, so fp64 reaches
// at most the 34 TFLOP/s DFMA rate, half the fp64 tensor-core bound
// (DMMA through mma.sync is the next step); loads are register-staged, not
// cp.async or TMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, int M, int N, int K) {
  constexpr int BK = 64 / sizeof(T);
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  constexpr int kA = BM * BK / kThreads;   // A elements a thread stages
  constexpr int kB = BN * BK / kThreads;   // B elements a thread stages
  static_assert(kA * kThreads == BM * BK && kB * kThreads == BN * BK,
                "tile does not divide among the threads");
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  T a_next[kA], b_next[kB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      const int m = row0 + e / BK, k = k0 + e % BK;
      a_next[i] = (m < M && k < K) ? A[static_cast<size_t>(m) * K + k] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / BN, n = col0 + e % BN;
      b_next[i] = (k < K && n < N) ? B[static_cast<size_t>(k) * N + n] : T(0);
    }
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      As[e % BK][e / BK] = a_next[i];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int e = tid + i * kThreads;
      Bs[e / BN][e % BN] = b_next[i];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);      // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
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
      if (n < N) C[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <typename T, int TM, int TN>
void launch_tile(const void* a, const void* b, void* c, int M, int N, int K,
                 cudaStream_t s) {
  const dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
  gemm_kernel<T, TM, TN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
}

template <typename T>
int launch_type(const void* a, const void* b, void* c, int M, int N, int K,
                int multiplier, cudaStream_t s) {
  switch (multiplier) {
    case 1: launch_tile<T, 4, 4>(a, b, c, M, N, K, s); break;
    case 2: launch_tile<T, 8, 4>(a, b, c, M, N, K, s); break;
    case 4: launch_tile<T, 8, 8>(a, b, c, M, N, K, s); break;
    case 8: launch_tile<T, 16, 8>(a, b, c, M, N, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// a (M, K), b (K, N), c (M, N), contiguous row-major; dtype 0 = fp32,
// 1 = fp64; multiplier in {1, 2, 4, 8}.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int gemm_launch(const void* a, const void* b, void* c, int M, int N, int K,
                int dtype, int multiplier, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch_type<float>(a, b, c, M, N, K, multiplier, s);
  } else if (dtype == 1) {
    err = launch_type<double>(a, b, c, M, N, K, multiplier, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

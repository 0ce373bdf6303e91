// ELL sparse matrix-vector product for Hopper (sm_90a), in two idioms, CUDA
// C++ with a plain C interface (loaded with ctypes by kernels/spmv/kernel.py).
//
// Replaces the TPU kernel `_spmv_take_kernel` (src/repro/kernels/spmv/
// kernel.py:24, pallas_call at :56), the gather idiom.  Same function:
//   y[r] = sum_k vals[r, k] * x[cols[r, k]]
// over vals (R, K) fp32, cols (R, K) int32 and a dense x (C,) fp32, into
// y (R, 1).  On the TPU, x sits whole in VMEM and each row block gathers
// from it; here x is read through the read-only (texture) path, so hot
// columns stay in L1/L2 and the gather costs one cached load per nonzero.
//
// What bounds it: device memory.  Each nonzero moves 8 bytes (value and
// column) for 2 operations; at R = C = 2^22 and K = 16 the function moves
// 570 MB (vals, cols, x once, y), 0.170 ms at 3.35 TB/s on an H100 SXM.
// The random gather from x (16 MiB at that size, inside the 50 MB L2)
// adds sectors the bound does not count.  Design:
//  - a group of G lanes per row, G the power of two at or above K (at most
//    32): lane l takes nonzeros l, l+G, ...; for K = 16 a warp reads two
//    rows' values and columns as one 128-byte line each;
//  - each group walks RPG rows (block_multiplier), RPG * (256 / G)
//    consecutive rows per block, so each step of the walk is coalesced and
//    a thread has RPG independent gathers in flight;
//  - the group's partial sums meet in a shuffle-xor reduction, and lane 0
//    of the group writes y[r];
//  - a column outside [0, C) adds nothing (memory stays safe without a
//    host check; the plain version raises on such a column instead).
//
// Also replaces `_spmv_onehot_kernel` (src/repro/kernels/spmv/kernel.py:32,
// pallas_call at :56), the one-hot idiom of the same product:
//   y[r] = sum_k vals[r, k] * sum_c [cols[r, k] == c] * x[c]
// where a column outside [0, C) contributes 0.  The idiom is the paper's
// subject (the cost of predication set against an indexed load), so the
// kernel keeps its character: there is no indexed global load of x.  x is
// staged through shared memory 2048 floats at a time, and each nonzero's
// contribution comes from a predicated compare-and-select over the whole
// staged tile (sel = (col == c) ? x[c] : sel), so the work grows with C as
// the TPU kernel's does: R * K * C compare-selects (2^32 at the JAX
// veceval size, 2^14 x 16 nonzeros against C = 2^14).  What bounds it:
// those operations, far above the function's bytes (vals, cols, x once
// and y: 2.1 MB there, 0.0006 ms at 3.35 TB/s).  Design: the take
// kernel's lane groups (G lanes a row, lane l holding nonzeros l, l+G, ...,
// up to 4 a pass), each staged tile read as 16-byte broadcasts, one select
// a nonzero and column, and the group's sum in a shuffle-xor reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kXTile = 2048;        // x floats staged a pass (8 KB)

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

// one-hot idiom: NS nonzeros a lane holds during one pass over x
template <int G, int NS>
__global__ void __launch_bounds__(kThreads)
    spmv_onehot_kernel(const float* __restrict__ vals,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ x, float* __restrict__ y,
                       int R, int K, int C) {
  __shared__ __align__(16) float x_s[kXTile];
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const long long r = static_cast<long long>(blockIdx.x) * kGroups + group;
  const bool live = r < R;
  const int per_lane = (K + G - 1) / G;       // nonzeros a lane owns
  float acc = 0.f;
  for (int s0 = 0; s0 < per_lane; s0 += NS) {  // block-uniform
    int col[NS];
    float val[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int k = lane + (s0 + i) * G;
      const bool ok = live && k < K;
      col[i] = ok ? __ldg(cols + r * K + k) : -1;   // -1 matches no column
      val[i] = ok ? __ldg(vals + r * K + k) : 0.f;
    }
    for (int c0 = 0; c0 < C; c0 += kXTile) {
      __syncthreads();                         // the last tile is consumed
      for (int i = threadIdx.x; i < kXTile; i += kThreads)
        x_s[i] = c0 + i < C ? x[c0 + i] : 0.f;  // padding matches as 0
      __syncthreads();
      int d[NS];
      float sel[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        d[i] = col[i] - c0;
        sel[i] = 0.f;
      }
#pragma unroll 8
      for (int c = 0; c < kXTile; c += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x_s + c);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          sel[i] = d[i] == c ? xv.x : sel[i];
          sel[i] = d[i] == c + 1 ? xv.y : sel[i];
          sel[i] = d[i] == c + 2 ? xv.z : sel[i];
          sel[i] = d[i] == c + 3 ? xv.w : sel[i];
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) acc += val[i] * sel[i];
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(kFull, acc, off, G);
  }
  if (lane == 0 && live) y[r] = acc;
}

template <int G>
void launch_onehot_g(const float* vals, const int32_t* cols, const float* x,
                     float* y, int R, int K, int C, cudaStream_t s) {
  constexpr int kGroups = kThreads / G;
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(R) + kGroups - 1) / kGroups);
  if (K <= G) {
    spmv_onehot_kernel<G, 1><<<grid, kThreads, 0, s>>>(vals, cols, x, y, R, K,
                                                       C);
  } else {
    spmv_onehot_kernel<G, 4><<<grid, kThreads, 0, s>>>(vals, cols, x, y, R, K,
                                                       C);
  }
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

// The one-hot idiom: vals (R, K) fp32, cols (R, K) int32, x (C,) fp32,
// y (R,) fp32, all contiguous.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int spmv_onehot_launch(const void* vals, const void* cols, const void* x,
                       void* y, int R, int K, int C, void* stream) {
  if (R <= 0) return 0;
  if (K < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (K <= 1) {
    launch_onehot_g<1>(v, c, xf, yf, R, K, C, s);
  } else if (K <= 2) {
    launch_onehot_g<2>(v, c, xf, yf, R, K, C, s);
  } else if (K <= 4) {
    launch_onehot_g<4>(v, c, xf, yf, R, K, C, s);
  } else if (K <= 8) {
    launch_onehot_g<8>(v, c, xf, yf, R, K, C, s);
  } else if (K <= 16) {
    launch_onehot_g<16>(v, c, xf, yf, R, K, C, s);
  } else {
    launch_onehot_g<32>(v, c, xf, yf, R, K, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Strided row gather for Hopper (sm_90a), two idioms in one source, CUDA
// C++ with a plain C interface (loaded with ctypes by
// kernels/strided/kernel.py).
//
// Replaces the TPU kernels `_row_kernel` (src/repro/kernels/strided/
// kernel.py:24, pallas_call at :32, `strided_rowwise`) and `_select_kernel`
// (:42, pallas_call at :56, `overfetch_select`): out[i] = x[i * stride] over
// the rows of a (rows, cols) fp32 array, the paper's Fig 2 idioms.
//  - strided_rowwise (the vlse analogue): cdiv(rows, stride) output rows.
//    Each thread moves one 16-byte vector of one output row; with cols =
//    128 a warp moves one whole 512-byte row, and only the rows it needs
//    are read.
//  - overfetch_select (the masked-vle analogue): rows / stride output rows.
//    A block owns br = 8 * block_multiplier output rows and streams the
//    contiguous span of br * stride input rows behind them: for each output
//    vector a thread loads the vector in all `stride` rows of its group and
//    keeps row 0 of the group, the TPU kernel's in-register
//    x.reshape(br, stride, lane)[:, 0, :].  The loads are ld.volatile, so
//    that no compiler stage drops the rows whose values go unused: with
//    plain loads in an asm volatile block the first build of this kernel
//    ran exactly as fast as the row-wise one.  It never reads past the last
//    whole group, row (rows / stride) * stride - 1: the TPU kernel leaves
//    a ragged last block to Pallas's padding, this one checks each row.
//
// What bounds it: device memory.  The function needs each output element
// read once and written once (8 bytes, no arithmetic); over-fetch moves
// (stride + 1) * 4 bytes per output element by design.  On the H100 a
// 512-byte row is a whole number of 32-byte sectors, so the row-wise reads
// waste nothing, and the prediction is that over-fetch loses by about
// (stride + 1) / 2 — the opposite of the TPU model (PERF.md, PR 13).
// Rows whose width is not a multiple of 4 floats (or misaligned data) take
// the same paths one float per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T load_volatile(const T* p);

template <>
__device__ __forceinline__ float load_volatile<float>(const float* p) {
  float v;
  asm volatile("ld.volatile.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <>
__device__ __forceinline__ float4 load_volatile<float4>(const float4* p) {
  float4 v;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// T is float4 (cv = cols / 4 vectors a row) or float (cv = cols)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rowwise_kernel(const T* __restrict__ x, T* __restrict__ out,
                   long long out_rows, long long cv, int stride) {
  const long long v =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= out_rows * cv) return;
  const long long r = v / cv, c = v - r * cv;
  out[v] = __ldg(x + r * stride * cv + c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    overfetch_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long out_rows, long long cv, int stride, int br) {
  const long long r0 = static_cast<long long>(blockIdx.x) * br;
  const long long span = static_cast<long long>(br) * cv;
  for (long long o = threadIdx.x; o < span; o += kThreads) {
    const long long r = r0 + o / cv, c = o % cv;
    if (r >= out_rows) break;                // rows grow with o
    const T* group = x + r * stride * cv + c;
    T keep = load_volatile(group);
    for (int j = 1; j < stride; ++j) {       // the over-fetched rows
      const T dropped = load_volatile(group + j * cv);
      (void)dropped;
    }
    out[r * cv + c] = keep;
  }
}

}  // namespace

extern "C" {

// idiom: 0 strided_rowwise, 1 overfetch_select.  x: rows x cols fp32;
// out: out_rows x cols (cdiv(rows, stride) rows for 0, rows / stride for
// 1, which the caller sized); vec: 1 if cols % 4 == 0 and both pointers
// are 16-byte aligned.  br (output rows a block of idiom 1 owns) > 0.
// Launches on `stream` and returns cudaGetLastError().
int strided_launch(const void* x, void* out, long long rows, long long cols,
                   int stride, int idiom, int br, int vec, void* stream) {
  if (rows < 0 || cols <= 0 || stride < 1 || br < 1 || idiom < 0 ||
      idiom > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long out_rows =
      idiom == 0 ? (rows + stride - 1) / stride : rows / stride;
  if (out_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cv = vec ? cols / 4 : cols;
  if (idiom == 0) {
    const unsigned grid =
        static_cast<unsigned>((out_rows * cv + kThreads - 1) / kThreads);
    if (vec)
      rowwise_kernel<float4><<<grid, kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<float4*>(out),
          out_rows, cv, stride);
    else
      rowwise_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), out_rows,
          cv, stride);
  } else {
    const unsigned grid = static_cast<unsigned>((out_rows + br - 1) / br);
    if (vec)
      overfetch_kernel<float4><<<grid, kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<float4*>(out),
          out_rows, cv, stride, br);
    else
      overfetch_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), out_rows,
          cv, stride, br);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Chunked Mamba-2 SSD scan for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by kernels/ssd_scan/kernel.py).
//
// Replaces the TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan/
// kernel.py, launched by `ssd_scan`), and computes what
// `repro.models.mamba2._ssd_chunked` computes, in fp32 in and out.  Per
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
// What bounds it: operations.  Per stream and chunk, over the causal pairs
// only, L(L+1)/2 * N multiply-adds for C.B^T, L(L+1)/2 * P for W.xdt and
// 2 L P N for the inter-chunk term and the state update; the bytes are each
// input read once and y and h_final written once.  At mamba2-780m's layer
// (b 8, S 2048, 48 heads, P 64, N 128, L 256) that is ~3.9e10 operations
// against ~435 MB: ops-bound on the CUDA cores' fp32 rate.
//
// Design, simple first:
//  - one block per (b, h) stream, walking its chunks in order; the state h
//    (P x N fp32, 32 KB at 64 x 128) stays in registers (each thread owns a
//    (P/16) x (N/16) tile) and is mirrored to shared memory for the
//    inter-chunk term.  The loop over chunks replaces the TPU's sequential
//    chunk grid axis.
//  - the chunk's cumsum: warp 0, a run of L/32 rows a lane, then a shuffle
//    scan of the lane totals.
//  - outputs in 64-row query tiles, each looping over 64-row key tiles up
//    to the diagonal (causal tile skip).  C (query rows), B and x * dt (key
//    rows) are staged in shared memory as fp32, B and C at row stride N + 1
//    (no bank conflicts).  256 threads as 16 x 16: thread (ty, tx) owns
//    query rows ty + 16 i (i < 4), scores key columns tx + 16 j (j < 4) and
//    output columns p = tx + 16 c (c < P/16).  The decay is masked BEFORE
//    the exp: above the diagonal cum_l - cum_m > 0 overflows, and 0 * inf
//    would be NaN, so exp is never evaluated there.
//  - the state update reuses the B / x tiles: x * dt * exp(cum_L - cum_m),
//    accumulated into the register tile after scaling it by exp(cum_L).
//  - shared memory: 134 KB at P 64, N 128, L 256 (dynamic, above 48 KB
//    after cudaFuncSetAttribute), so one block per SM; 384 streams at the
//    static serving shape are ~3 waves on 132 SMs.
// Known limits, later work: CUDA cores, not tensor cores (mma.sync /
// wgmma); no cp.async / TMA staging or double buffering; C.B^T is computed
// once per head, not once per (batch row, chunk); the chunk-parallel
// three-pass form (chunk states, state passing, chunk outputs) would fill
// the card at small batch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;              // rows per query tile and per key tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kRows = kT / 16;      // query rows / key columns a thread
constexpr int kMaxChunk = 1024;
constexpr unsigned kFull = 0xffffffffu;

// offsets (in floats) of the shared-memory regions; cum and dt (L each)
// come last, so the size depends on L
template <int P, int N>
struct Layout {
  static constexpr int kLdN = N + 1;
  static constexpr int kLdW = kT + 1;
  static constexpr int cs = 0;                      // kT x kLdN: C rows
  static constexpr int bs = cs + kT * kLdN;         // kT x kLdN: B rows
  static constexpr int xs = bs + kT * kLdN;         // kT x P: x * dt (...)
  static constexpr int ws = xs + kT * P;            // kT x kLdW: weights
  static constexpr int hs = ws + kT * kLdW;         // P x kLdN: state
  static constexpr int cum = hs + P * kLdN;         // L, then dt: L
  static size_t bytes(int L) { return sizeof(float) * (size_t(cum) + 2 * L); }
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ D,
                float* __restrict__ y, float* __restrict__ h_final, int S,
                int H, int L) {
  using Ly = Layout<P, N>;
  constexpr int kLdN = Ly::kLdN;
  constexpr int kLdW = Ly::kLdW;
  constexpr int kPc = P / 16;       // output columns (p) a thread
  constexpr int kNc = N / 16;       // state columns (n) a thread
  extern __shared__ float smem[];
  float* cs = smem + Ly::cs;
  float* bs = smem + Ly::bs;
  float* xs = smem + Ly::xs;
  float* ws = smem + Ly::ws;
  float* hs = smem + Ly::hs;
  float* cum = smem + Ly::cum;
  float* dts = cum + L;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int hi = bh % H;
  const size_t row0 = size_t(bh / H) * S;   // the batch row's first token
  const float a = A[bh];
  const float d = D[bh];

  // h[p = ty + 16 i][n = tx + 16 j]
  float hr[kPc][kNc];
#pragma unroll
  for (int i = 0; i < kPc; ++i)
#pragma unroll
    for (int j = 0; j < kNc; ++j) hr[i][j] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int lc = min(L, S - t0);            // real rows of this chunk
    const size_t c0 = row0 + t0;
    __syncthreads();          // the last chunk's readers of dts / cum done
    for (int r = tid; r < L; r += kThreads)
      dts[r] = r < lc ? dt[(c0 + r) * H + hi] : 0.0f;
    __syncthreads();
    if (tid < 32) {           // cum = cumsum(dt * a), inclusive
      const int per = (L + 31) / 32;
      const int lo = tid * per, end = min(lo + per, L);
      float run = 0.0f;
      for (int r = lo; r < end; ++r) {
        run += dts[r] * a;
        cum[r] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(kFull, tot, o);
        if (tid >= o) tot += v;
      }
      const float off = tot - run;
      for (int r = lo; r < end; ++r) cum[r] += off;
    }

    // ---- outputs, one 64-row query tile at a time ----
    for (int q0 = 0; q0 < lc; q0 += kT) {
      __syncthreads();        // cum written; the last tile's cs readers done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, c = e % N;
        cs[r * kLdN + c] = q0 + r < lc ? Cm[(c0 + q0 + r) * N + c] : 0.0f;
      }
      float acc[kRows][kPc];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kPc; ++c) acc[i][c] = 0.0f;

      for (int k0 = 0; k0 <= q0; k0 += kT) {  // key tiles to the diagonal
        __syncthreads();      // cs staged; the last key tile's readers done
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, c = e % N;
          bs[r * kLdN + c] = k0 + r < lc ? Bm[(c0 + k0 + r) * N + c] : 0.0f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, c = e % P;
          xs[r * P + c] = k0 + r < lc
                              ? x[((c0 + k0 + r) * H + hi) * P + c] *
                                    dts[k0 + r]
                              : 0.0f;
        }
        __syncthreads();

        float s[kRows][kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) s[i][j] = 0.0f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          float ca[kRows], cb[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) ca[i] = cs[(ty + 16 * i) * kLdN + n];
#pragma unroll
          for (int j = 0; j < kRows; ++j) cb[j] = bs[(tx + 16 * j) * kLdN + n];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kRows; ++j)
              s[i][j] = fmaf(ca[i], cb[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int l = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int m = k0 + tx + 16 * j;
            // causal and real rows only; the exp is never taken above the
            // diagonal (it overflows there)
            const bool keep = m <= l && l < lc;
            ws[(ty + 16 * i) * kLdW + tx + 16 * j] =
                keep ? s[i][j] * expf(cum[l] - cum[m]) : 0.0f;
          }
        }
        __syncthreads();

        const int m_end = min(kT, lc - k0);
        for (int m = 0; m < m_end; ++m) {
          float w[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) w[i] = ws[(ty + 16 * i) * kLdW + m];
#pragma unroll
          for (int c = 0; c < kPc; ++c) {
            const float xv = xs[m * P + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(w[i], xv, acc[i][c]);
          }
        }
      }

      // inter-chunk term C_l . h_prev (hs: the state before this chunk)
      float inter[kRows][kPc];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kPc; ++c) inter[i][c] = 0.0f;
      if (t0 > 0) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float ca[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) ca[i] = cs[(ty + 16 * i) * kLdN + n];
#pragma unroll
          for (int c = 0; c < kPc; ++c) {
            const float hv = hs[(tx + 16 * c) * kLdN + n];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              inter[i][c] = fmaf(ca[i], hv, inter[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int l = q0 + ty + 16 * i;
        if (l >= lc) continue;
        const float e = expf(cum[l]);
#pragma unroll
        for (int c = 0; c < kPc; ++c) {
          const size_t g = ((c0 + l) * H + hi) * P + tx + 16 * c;
          y[g] = acc[i][c] + e * inter[i][c] + d * x[g];
        }
      }
    }

    // ---- state update: h <- exp(cum_L) h + sum_m u_m B_m^T ----
    const float total = cum[lc - 1];
    const float cdecay = expf(total);
#pragma unroll
    for (int i = 0; i < kPc; ++i)
#pragma unroll
      for (int j = 0; j < kNc; ++j) hr[i][j] *= cdecay;
    for (int k0 = 0; k0 < lc; k0 += kT) {
      __syncthreads();        // the readers of bs / xs / hs are done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, c = e % N;
        bs[r * kLdN + c] = k0 + r < lc ? Bm[(c0 + k0 + r) * N + c] : 0.0f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int r = e / P, c = e % P;
        const int m = k0 + r;
        xs[r * P + c] = m < lc ? x[((c0 + m) * H + hi) * P + c] * dts[m] *
                                     expf(total - cum[m])
                               : 0.0f;
      }
      __syncthreads();
      const int m_end = min(kT, lc - k0);
      for (int m = 0; m < m_end; ++m) {
        float u[kPc], bv[kNc];
#pragma unroll
        for (int i = 0; i < kPc; ++i) u[i] = xs[m * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kNc; ++j) bv[j] = bs[m * kLdN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPc; ++i)
#pragma unroll
          for (int j = 0; j < kNc; ++j) hr[i][j] = fmaf(u[i], bv[j], hr[i][j]);
      }
    }
    __syncthreads();          // the update's readers of xs / bs are done
#pragma unroll
    for (int i = 0; i < kPc; ++i)
#pragma unroll
      for (int j = 0; j < kNc; ++j)
        hs[(ty + 16 * i) * kLdN + tx + 16 * j] = hr[i][j];
  }

  float* hf = h_final + size_t(bh) * P * N;
#pragma unroll
  for (int i = 0; i < kPc; ++i)
#pragma unroll
    for (int j = 0; j < kNc; ++j)
      hf[(ty + 16 * i) * N + tx + 16 * j] = hr[i][j];
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* B, const void* C,
           const void* A, const void* D, void* y, void* h_final, int streams,
           int S, int H, int L, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for (once is enough,
  // at the largest chunk)
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<P, N>::bytes(kMaxChunk)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_scan_kernel<P, N><<<streams, kThreads, Layout<P, N>::bytes(L), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<float*>(h_final), S, H, L);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(int N, const void* x, const void* dt, const void* B,
             const void* C, const void* A, const void* D, void* y,
             void* h_final, int streams, int S, int H, int L,
             cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(x, dt, B, C, A, D, y, h_final, streams, S, H, L,
                           stream);
    case 32:
      return launch<P, 32>(x, dt, B, C, A, D, y, h_final, streams, S, H, L,
                           stream);
    case 64:
      return launch<P, 64>(x, dt, B, C, A, D, y, h_final, streams, S, H, L,
                           stream);
    case 128:
      return launch<P, 128>(x, dt, B, C, A, D, y, h_final, streams, S, H, L,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// operands fp32 and contiguous: x / y (batch, S, H, P), dt (batch, S, H),
// B / C (batch, S, N), A / D (batch * H), h_final (batch, H, P, N).  P in
// {16, 32, 64}, N in {16, 32, 64, 128}, 1 <= L <= 1024, batch * H >= 1.
int ssd_scan_launch(const void* x, const void* dt, const void* B,
                    const void* C, const void* A, const void* D, void* y,
                    void* h_final, int batch, int S, int H, int P, int N,
                    int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > kMaxChunk || batch < 1 || H < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int streams = batch * H;
  switch (P) {
    case 16:
      return launch_n<16>(N, x, dt, B, C, A, D, y, h_final, streams, S, H, L,
                          s);
    case 32:
      return launch_n<32>(N, x, dt, B, C, A, D, y, h_final, streams, S, H, L,
                          s);
    case 64:
      return launch_n<64>(N, x, dt, B, C, A, D, y, h_final, streams, S, H, L,
                          s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

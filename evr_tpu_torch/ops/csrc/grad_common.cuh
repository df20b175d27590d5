// Pieces shared by the backward kernels K5a (block_attn_bwd.cu) and K5b
// (block_mlp_bwd.cu):
//
// - gemm_t, the fp32 calls' GEMM: out[M, N] = epilogue(op(A)[M, K] @
//   op(B)[K, N]) in full fp32 on the CUDA cores, either operand read
//   transposed; the on-card parity path the fp32 bands are measured on. A
//   weight gradient (a product over all B*T rows, K = rows) is one launch:
//   each block walks the whole K range for its output tile, so the sum over
//   rows has one fixed order and no atomics. The bf16 calls run their ten
//   products on the wgmma kernel of gemm_sm90.cuh instead, with its
//   transposed layouts and fp32 epilogues.
// - LayerNorm over rows (y rounded to T, with the fp32 statistics kept) and
//   its backward (dx = g + dx_ln, rounded once).
// - column sums over rows in two fixed-order stages (per 128-row chunk, then
//   over the chunks): the bias and LayerNorm-parameter gradients.
#pragma once

#include "gemm_sm90.cuh"

namespace evr {

// -- fp32 tiled GEMM ---------------------------------------------------------
// Tiles as gemm_kernel: one 64x128 output tile per block, K in 32-wide steps,
// 8 warps as 2 x 4 each owning 32x32. A is stored [M, K] (lda) or, with TA,
// [K, M]; B is stored [K, N] (ldb) or, with TB, [N, K]. A transposed operand
// is staged transposed and read by the tile product as such, so global reads
// stay contiguous. M and K may be ragged; N must be a multiple of 64: a last
// tile half past N reads zeros for its missing columns and hands none of
// them to the epilogue (the tiny test tower's W of 64 and 3W of 192), and
// every N a multiple of 128 runs as before, no column masked.
constexpr int kTBM = 64, kTBN = 128, kTBK = 32;

template <bool TA, bool TB>
struct GemmTLayout {
  static constexpr int LDA = TA ? kTBM + 8 : kTBK + 8;  // staged A row stride
  static constexpr int LDB = TB ? kTBK + 8 : kTBN + 8;  // staged B row stride
  static constexpr int LDC = kTBN + 4;
  static constexpr size_t a_bytes = align128(sizeof(float) * (TA ? kTBK : kTBM) * LDA);
  static constexpr size_t b_bytes = align128(sizeof(float) * (TB ? kTBN : kTBK) * LDB);
  static constexpr size_t bytes = a_bytes + b_bytes + align128(sizeof(float) * kTBM * LDC);
};

template <bool TA, bool TB, class Epi>
__global__ void __launch_bounds__(kThreads) gemm_t_kernel(const float* __restrict__ a, int lda,
                                                          const float* __restrict__ b, int ldb, int M, int N,
                                                          int K, Epi epi) {
  using L = GemmTLayout<TA, TB>;
  constexpr int BM = kTBM, BN = kTBN, BK = kTBK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = reinterpret_cast<float*>(smem + L::a_bytes);
  float* sc = reinterpret_cast<float*>(smem + L::a_bytes + L::b_bytes);

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  Tile<float>::Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) Tile<float>::zero(acc[i][j]);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      if constexpr (TA) {  // element (m, k) at a[k*lda + m], m fastest
        const int m = i % BM, k = i / BM, gm = row0 + m, gk = k0 + k;
        sa[k * L::LDA + m] = (gm < M && gk < K) ? a[static_cast<size_t>(gk) * lda + gm] : 0.f;
      } else {
        const int m = i / BK, k = i % BK, gm = row0 + m, gk = k0 + k;
        sa[m * L::LDA + k] = (gm < M && gk < K) ? a[static_cast<size_t>(gm) * lda + gk] : 0.f;
      }
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      if constexpr (TB) {  // element (k, n) at b[n*ldb + k], k fastest
        const int k = i % BK, n = i / BK, gk = k0 + k;
        sb[n * L::LDB + k] = gk < K && col0 + n < N ? b[static_cast<size_t>(col0 + n) * ldb + gk] : 0.f;
      } else {
        const int k = i / BN, n = i % BN, gk = k0 + k;
        sb[k * L::LDB + n] = gk < K && col0 + n < N ? b[static_cast<size_t>(gk) * ldb + col0 + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = wr * 32 + i * 16, c = wc * 32 + j * 16;
          const float* pa = TA ? sa + kk * L::LDA + r : sa + r * L::LDA + kk;
          const float* pb = TB ? sb + c * L::LDB + kk : sb + kk * L::LDB + c;
          Tile<float>::mma<TB, TA>(acc[i][j], pa, L::LDA, pb, L::LDB);
        }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      Tile<float>::store(sc + (wr * 32 + i * 16) * L::LDC + wc * 32 + j * 16, L::LDC, acc[i][j]);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN, gm = row0 + r;
    if (gm < M && col0 + c < N) epi(gm, col0 + c, sc[r * L::LDC + c]);
  }
}

template <bool TA, bool TB, class Epi>
int launch_gemm_t(const float* a, int lda, const float* b, int ldb, int M, int N, int K, Epi epi,
                  cudaStream_t stream) {
  if (N < kTBN / 2 || N % (kTBN / 2) != 0 || M < 1 || K < 1) return -1;
  constexpr size_t smem = GemmTLayout<TA, TB>::bytes;
  auto kernel = gemm_t_kernel<TA, TB, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM), kThreads, smem, stream>>>(a, lda, b, ldb, M, N, K,
                                                                                      epi);
  return static_cast<int>(cudaGetLastError());
}

// Epilogues: called once per output element with its fp32 sum.
struct EpiF32 {  // the fp32 sum as it is (gradients, dy)
  float* out;
  int ldo;
  __device__ void operator()(int m, int n, float v) const { out[static_cast<size_t>(m) * ldo + n] = v; }
};

struct EpiBias {  // the fp32 sum plus an optional bias
  float* out;
  const float* bias;
  int ldo;
  __device__ void operator()(int m, int n, float v) const {
    if (bias != nullptr) v += bias[n];
    out[static_cast<size_t>(m) * ldo + n] = v;
  }
};

// -- LayerNorm over rows -----------------------------------------------------
// One warp per row: fp32 statistics (row_stats), y rounded to T, as the
// reference kernels' LN prologue; mean and rstd kept for the backward.
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ s,
                                                           const T* __restrict__ bias, T* __restrict__ y,
                                                           float* __restrict__ mean, float* __restrict__ rstd,
                                                           int M, int W) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * W;
  float mu, rs;
  row_stats(xr, W, mu, rs);
  for (int k = lane; k < W; k += 32)
    y[static_cast<size_t>(row) * W + k] = from_f<T>((to_f(xr[k]) - mu) * rs * to_f(s[k]) + to_f(bias[k]));
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// The LayerNorm backward of one row (the reference kernels' LN tail):
// xhat = (x - mean) rstd, dxhat = dy * scale,
// dx = g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                                                          const float* __restrict__ rstd,
                                                          const float* __restrict__ dy, const T* __restrict__ s,
                                                          const T* __restrict__ g, T* __restrict__ dx, int M,
                                                          int W) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t o = static_cast<size_t>(row) * W;
  const float mu = mean[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < W; k += 32) {
    const float xhat = (to_f(x[o + k]) - mu) * rs, dxhat = dy[o + k] * to_f(s[k]);
    s1 += dxhat;
    s2 += dxhat * xhat;
  }
  const float m1 = warp_sum(s1) / W, m2 = warp_sum(s2) / W;
  for (int k = lane; k < W; k += 32) {
    const float xhat = (to_f(x[o + k]) - mu) * rs, dxhat = dy[o + k] * to_f(s[k]);
    dx[o + k] = from_f<T>(to_f(g[o + k]) + rs * (dxhat - m1 - xhat * m2));
  }
}

template <typename T>
int launch_ln_rows(const T* x, const T* s, const T* b, T* y, float* mean, float* rstd, int M, int W,
                   cudaStream_t stream) {
  constexpr int rows = kThreads / 32;
  ln_rows_kernel<T><<<(M + rows - 1) / rows, kThreads, 0, stream>>>(x, s, b, y, mean, rstd, M, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_bwd(const T* x, const float* mean, const float* rstd, const float* dy, const T* s, const T* g,
                  T* dx, int M, int W, cudaStream_t stream) {
  constexpr int rows = kThreads / 32;
  ln_bwd_kernel<T><<<(M + rows - 1) / rows, kThreads, 0, stream>>>(x, mean, rstd, dy, s, g, dx, M, W);
  return static_cast<int>(cudaGetLastError());
}

// -- column sums over rows ---------------------------------------------------
constexpr int kColChunk = 128;  // rows per first-stage partial sum

inline int col_chunks(int M) { return (M + kColChunk - 1) / kColChunk; }

template <class F>
__global__ void __launch_bounds__(kThreads) colsum_partial_kernel(F f, float* __restrict__ partial, int M,
                                                                  int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x, c = blockIdx.y;
  if (n >= N) return;
  const int m1 = min(M, (c + 1) * kColChunk);
  float s = 0.f;
  for (int m = c * kColChunk; m < m1; ++m) s += f(m, n);
  partial[static_cast<size_t>(c) * N + n] = s;
}

__global__ void __launch_bounds__(kThreads) colsum_final_kernel(const float* __restrict__ partial,
                                                                float* __restrict__ out, int chunks, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[static_cast<size_t>(c) * N + n];
  out[n] = s;
}

// out[n] = sum over m < M of f(m, n); ``partial`` holds col_chunks(M) * N floats.
template <class F>
int launch_colsum(F f, float* partial, float* out, int M, int N, cudaStream_t stream) {
  const int chunks = col_chunks(M), nb = (N + kThreads - 1) / kThreads;
  colsum_partial_kernel<F><<<dim3(nb, chunks), kThreads, 0, stream>>>(f, partial, M, N);
  colsum_final_kernel<<<nb, kThreads, 0, stream>>>(partial, out, chunks, N);
  return static_cast<int>(cudaGetLastError());
}

struct ColF32 {  // a fp32 matrix's entries
  const float* a;
  int ld;
  __device__ float operator()(int m, int n) const { return a[static_cast<size_t>(m) * ld + n]; }
};

template <typename T>
struct ColElt {  // a T matrix's entries in fp32
  const T* a;
  int ld;
  __device__ float operator()(int m, int n) const { return to_f(a[static_cast<size_t>(m) * ld + n]); }
};

template <typename T>
struct ColLnScale {  // dy * xhat: the LayerNorm scale's gradient terms
  const float* dy;
  const T* x;
  const float* mean;
  const float* rstd;
  int W;
  __device__ float operator()(int m, int n) const {
    const size_t o = static_cast<size_t>(m) * W + n;
    return dy[o] * ((to_f(x[o]) - mean[m]) * rstd[m]);
  }
};

// dy's column sums (LN bias) and dy * xhat's (LN scale), then dx.
template <typename T>
int ln_backward(const T* x, const float* mean, const float* rstd, const float* dy, const T* s, const T* g,
                T* dx, float* dls, float* dlb, float* partial, int M, int W, cudaStream_t stream) {
  int rc = launch_colsum(ColLnScale<T>{dy, x, mean, rstd, W}, partial, dls, M, W, stream);
  if (rc != 0) return rc;
  rc = launch_colsum(ColF32{dy, W}, partial, dlb, M, W, stream);
  if (rc != 0) return rc;
  return launch_ln_bwd<T>(x, mean, rstd, dy, s, g, dx, M, W, stream);
}

}  // namespace evr

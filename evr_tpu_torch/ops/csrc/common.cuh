// Shared pieces of the fused transformer-block kernels (block_attn.cu,
// block_mlp.cu, block_quant.cu, block_attn_bwd.cu, block_mlp_bwd.cu):
// element-type helpers, a warp-level 16x16x16 tile product with fp32
// accumulation, and a row-tiled GEMM with a LayerNorm prologue and the
// residual/activation epilogues the two block halves need.
//
// Element types: __nv_bfloat16 (the serving dtype; tile products run on the
// tensor cores through WMMA) and float (tile products run as fp32 FMAs on the
// CUDA cores, so an fp32 call keeps full fp32 precision instead of TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace evr {

using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-5f;
constexpr int kThreads = 256;  // 8 warps per block in every kernel

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T and back: the cast points of the reference kernels
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm statistics of one row, fp32, two passes (mean, then the mean
// squared deviation) as the reference computes them. Called by a whole warp.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int n, float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < n; k += 32) s += to_f(row[k]);
  mean = warp_sum(s) / n;
  float v = 0.f;
  for (int k = lane; k < n; k += 32) {
    const float d = to_f(row[k]) - mean;
    v += d * d;
  }
  rstd = rsqrtf(warp_sum(v) / n + kLnEps);
}

// erf by Abramowitz-Stegun 7.1.26, the formula the reference kernel uses
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float sign = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  return sign * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_as(float x) {
  return 0.5f * x * (1.f + erf_as(x * 0.7071067811865476f));
}

__device__ __forceinline__ float quick_gelu(float x) {
  return x * (1.f / (1.f + expf(-1.702f * x)));
}

// -- warp-level 16x16x16 tile product, fp32 accumulator ---------------------
// A is row-major with leading dimension lda, or, with AT, the transpose of a
// row-major matrix (element (m, k) at a[k*lda + m]). B is row-major (ldb), or,
// with BT, the transpose of a row-major matrix (element (k, n) at
// b[n*ldb + k]). Pointers into shared memory must be 32-byte aligned for the
// bf16 path.
template <typename T>
struct Tile;

template <>
struct Tile<bf16> {
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  __device__ static void zero(Acc& c) { nvcuda::wmma::fill_fragment(c, 0.f); }
  template <bool BT, bool AT = false>
  __device__ static void mma(Acc& c, const bf16* a, int lda, const bf16* b, int ldb) {
    using namespace nvcuda::wmma;
    using LA = typename std::conditional<AT, col_major, row_major>::type;
    using LB = typename std::conditional<BT, col_major, row_major>::type;
    fragment<matrix_a, 16, 16, 16, bf16, LA> fa;
    fragment<matrix_b, 16, 16, 16, bf16, LB> fb;
    load_matrix_sync(fa, a, lda);
    load_matrix_sync(fb, b, ldb);
    mma_sync(c, fa, fb, c);
  }
  __device__ static void store(float* out, int ldc, const Acc& c) {
    nvcuda::wmma::store_matrix_sync(out, c, ldc, nvcuda::wmma::mem_row_major);
  }
};

// fp32: the same tile split over the warp by hand, lane l owning row l/2 and
// eight neighbouring columns, so both element types share the kernels' code.
template <>
struct Tile<float> {
  struct Acc {
    float v[8];
  };
  __device__ static void zero(Acc& c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c.v[j] = 0.f;
  }
  template <bool BT, bool AT = false>
  __device__ static void mma(Acc& c, const float* a, int lda, const float* b, int ldb) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = AT ? a[k * lda + r] : a[r * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = BT ? b[(c0 + j) * ldb + k] : b[k * ldb + c0 + j];
        c.v[j] = fmaf(av, bv, c.v[j]);
      }
    }
  }
  __device__ static void store(float* out, int ldc, const Acc& c) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[r * ldc + c0 + j] = c.v[j];
  }
};

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// -- row-tiled GEMM with fused prologue / epilogue --------------------------
// out[M, N] = epilogue(prologue(A)[M, K] @ W[K, N] + bias), one 64x128 output
// tile per block, K walked in 32-wide steps through shared memory; 8 warps as
// 2 x 4, each owning a 32x32 quarter (2 x 2 tiles).
enum Prologue { kPlain = 0, kLayerNorm = 1 };
enum Epilogue { kResidualOnce = 0, kQuickGelu = 1, kGelu = 2, kResidualTwice = 3, kRound = 4 };

constexpr int kGemmBM = 64, kGemmBN = 128, kGemmBK = 32;

template <typename T>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return align128(sizeof(T) * kGemmBM * (kGemmBK + 8)) +
         align128(sizeof(T) * kGemmBK * (kGemmBN + 8)) +
         align128(sizeof(float) * kGemmBM * (kGemmBN + 4)) + align128(sizeof(float) * 2 * kGemmBM);
}

template <typename T, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const T* __restrict__ a,      // [M, K]; for kLayerNorm the pre-norm rows
    const T* __restrict__ ln_s,   // [K] (kLayerNorm)
    const T* __restrict__ ln_b,   // [K] (kLayerNorm)
    const T* __restrict__ w,      // [K, N]
    const T* __restrict__ bias,   // [N]
    const T* __restrict__ res,    // [M, N] residual (kResidual*)
    T* __restrict__ out,          // [M, N]
    int M, int N, int K) {
  constexpr int BM = kGemmBM, BN = kGemmBN, BK = kGemmBK;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = reinterpret_cast<T*>(smem + align128(sizeof(T) * BM * LDA));
  float* sc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sb) +
                                       align128(sizeof(T) * BK * LDB));
  float* s_mean = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sc) +
                                           align128(sizeof(float) * BM * LDC));
  float* s_rstd = s_mean + BM;

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if constexpr (PRO == kLayerNorm) {
    for (int r = warp; r < BM; r += kThreads / 32) {
      float mean = 0.f, rstd = 0.f;
      if (row0 + r < M) row_stats(a + static_cast<size_t>(row0 + r) * K, K, mean, rstd);
      if (lane == 0) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int wr = warp >> 2, wc = warp & 3;
  typename Tile<T>::Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) Tile<T>::zero(acc[i][j]);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, gr = row0 + r;
      float v = 0.f;
      if (gr < M) {
        v = to_f(a[static_cast<size_t>(gr) * K + k0 + c]);
        if constexpr (PRO == kLayerNorm)
          v = rnd<T>((v - s_mean[r]) * s_rstd[r] * to_f(ln_s[k0 + c]) + to_f(ln_b[k0 + c]));
      }
      sa[r * LDA + c] = from_f<T>(v);
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      sb[r * LDB + c] = w[static_cast<size_t>(k0 + r) * N + col0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          Tile<T>::template mma<false>(acc[i][j], sa + (wr * 32 + i * 16) * LDA + kk, LDA,
                                       sb + kk * LDB + wc * 32 + j * 16, LDB);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      Tile<T>::store(sc + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, LDC, acc[i][j]);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN, gr = row0 + r, gc = col0 + c;
    if (gr >= M) continue;
    const float v = sc[r * LDC + c] + to_f(bias[gc]);
    const size_t o = static_cast<size_t>(gr) * N + gc;
    if constexpr (EPI == kResidualOnce) {
      out[o] = from_f<T>(to_f(res[o]) + v);  // fp32 sum, one rounding
    } else if constexpr (EPI == kResidualTwice) {
      out[o] = from_f<T>(to_f(res[o]) + rnd<T>(v));  // sum of two T values
    } else if constexpr (EPI == kRound) {
      out[o] = from_f<T>(v);  // the fp32 sum plus bias, rounded once
    } else if constexpr (EPI == kQuickGelu) {
      out[o] = from_f<T>(quick_gelu(v));
    } else {
      out[o] = from_f<T>(gelu_as(v));
    }
  }
}

// Launch one gemm_kernel instantiation; returns the CUDA error code.
template <typename T, int PRO, int EPI>
int launch_gemm(const T* a, const T* ln_s, const T* ln_b, const T* w, const T* bias,
                const T* res, T* out, int M, int N, int K, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem_bytes<T>();
  auto kernel = gemm_kernel<T, PRO, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kThreads, smem, stream>>>(a, ln_s, ln_b, w, bias, res, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace evr

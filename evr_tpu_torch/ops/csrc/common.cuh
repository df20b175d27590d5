// Shared pieces of the hand-written kernels (block_attn.cu, block_mlp.cu,
// block_merged.cu, block_quant.cu, block_attn_bwd.cu, block_mlp_bwd.cu,
// flash_attn.cu, layernorm.cu, topk_fused.cu): element-type helpers, a
// warp-level 16x16x16 fp32 tile product (the fp32 attention of flash.cuh and
// flash_attn.cu), the block halves' epilogues, the LayerNorm row pass (K8's
// device code) and the fp32 row-tiled GEMM of the forward block halves' fp32
// calls. Their bf16 GEMMs, and those of the backward halves, run on the wgmma
// kernel of gemm_sm90.cuh.
//
// Element types: __nv_bfloat16 (the serving dtype; its products run on the
// wgmma kernels) and float (products run as fp32 FMAs on the CUDA cores, so
// an fp32 call keeps full fp32 precision instead of TF32).
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

// the activations' derivatives, fp32 (K5b's backward):
// d/dh [h sigmoid(1.702 h)] = sig (1 + 1.702 h (1 - sig))
__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float sig = 1.f / (1.f + expf(-1.702f * h));
  return sig * (1.f + 1.702f * h * (1.f - sig));
}

// d/dh [h Phi(h)] = Phi(h) + h phi(h), Phi = 0.5 (1 + erf(h / sqrt 2))
__device__ __forceinline__ float gelu_grad(float h) {
  const float pdf = 0.3989422804014327f * expf(-0.5f * h * h);
  return 0.5f * (1.f + erf_as(h * 0.7071067811865476f)) + h * pdf;
}

// -- warp-level 16x16x16 tile product, fp32 accumulator ---------------------
// A is row-major with leading dimension lda, or, with AT, the transpose of a
// row-major matrix (element (m, k) at a[k*lda + m]). B is row-major (ldb), or,
// with BT, the transpose of a row-major matrix (element (k, n) at
// b[n*ldb + k]). Only fp32 takes it (the fp32 attention of flash.cuh and
// flash_attn.cu, full fp32 on the CUDA cores): the tile split over the warp
// by hand, lane l owning row l/2 and eight neighbouring columns. bf16
// attention runs on the wgmma kernels of attn_sm90.cuh and attn_bwd_sm90.cuh.
template <typename T>
struct Tile;

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

// The block halves' epilogues, applied to v = the fp32 sum plus the bias, at
// the reference's rounding points (evr_tpu/ops/block_fused.py): kRound rounds
// v once; kResidualOnce adds the residual in fp32 and rounds once (K1);
// kResidualTwice adds the rounded v to the residual in the element type (K2);
// kQuickGelu and kGelu apply the activation in fp32 and round.
enum Epilogue { kResidualOnce = 0, kQuickGelu = 1, kGelu = 2, kResidualTwice = 3, kRound = 4 };

template <int EPI>
__host__ __device__ constexpr bool epilogue_reads_residual() {
  return EPI == kResidualOnce || EPI == kResidualTwice;
}

template <typename T, int EPI>
__device__ __forceinline__ T apply_epilogue(float v, float res) {
  if constexpr (EPI == kResidualOnce) {
    return from_f<T>(res + v);  // fp32 sum, one rounding
  } else if constexpr (EPI == kResidualTwice) {
    return from_f<T>(res + rnd<T>(v));  // sum of two T values
  } else if constexpr (EPI == kRound) {
    return from_f<T>(v);
  } else if constexpr (EPI == kQuickGelu) {
    return from_f<T>(quick_gelu(v));
  } else {
    return from_f<T>(gelu_as(v));
  }
}

// -- LayerNorm row pass (K8's device code) ----------------------------------
// y = LN(x) * scale + bias (then y * sigmoid(1.702 y) with TAIL), one warp a
// row, eight rows a block: row_stats' two passes, then a third that
// normalises, scales and casts once. scale and bias are fp32. K8 launches it
// on its own; the block halves launch it before the QKV and fc GEMMs, with
// the fp32 values of their element-type LN parameters, so y is exactly the
// rounded LN output the reference multiplies with.
template <typename T, bool TAIL>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(const T* __restrict__ x,
                                                              const float* __restrict__ scale,
                                                              const float* __restrict__ bias,
                                                              T* __restrict__ y, int rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= rows) return;  // whole warps leave; the kernel has no barrier
  const T* xr = x + static_cast<size_t>(row) * D;
  T* yr = y + static_cast<size_t>(row) * D;
  float mean, rstd;
  row_stats(xr, D, mean, rstd);
  for (int k = lane; k < D; k += 32) {
    float v = (to_f(xr[k]) - mean) * rstd;
    v = v * scale[k] + bias[k];
    if constexpr (TAIL) v = quick_gelu(v);
    yr[k] = from_f<T>(v);
  }
}

template <typename T>
int launch_layer_norm(const T* x, const float* scale, const float* bias, T* y, int rows, int D, bool tail,
                      cudaStream_t stream) {
  constexpr int rows_per_block = kThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (tail)
    layer_norm_kernel<T, true><<<blocks, kThreads, 0, stream>>>(x, scale, bias, y, rows, D);
  else
    layer_norm_kernel<T, false><<<blocks, kThreads, 0, stream>>>(x, scale, bias, y, rows, D);
  return static_cast<int>(cudaGetLastError());
}

// -- fp32 row-tiled GEMM on the CUDA cores ----------------------------------
// out[M, N] = epilogue(A[M, K] @ W[K, N] + bias) in full fp32 (no TF32), one
// 64x128 output tile per block, K walked in 32-wide steps through shared
// memory; 8 warps as 2 x 4, each owning a 32x32 quarter (2 x 2 Tile<float>
// products). N a multiple of 64: a last tile half past N reads zeros for its
// missing columns and stores none of them (the tiny test tower's N of 64 and
// 192); every N a multiple of 128 runs as before, no column masked. The
// block halves' fp32 calls run here; their bf16 calls run on the wgmma GEMM
// of gemm_sm90.cuh.
constexpr int kGemmBM = 64, kGemmBN = 128, kGemmBK = 32;

__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return align128(sizeof(float) * kGemmBM * (kGemmBK + 8)) + align128(sizeof(float) * kGemmBK * (kGemmBN + 8)) +
         align128(sizeof(float) * kGemmBM * (kGemmBN + 4));
}

inline bool gemm_f32_takes(int M, int N, int K) {
  return M >= 1 && N >= kGemmBN / 2 && K >= kGemmBK && N % (kGemmBN / 2) == 0 && K % kGemmBK == 0 &&
         (M + kGemmBM - 1) / kGemmBM <= 65535;
}

template <int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const float* __restrict__ a,     // [M, K]
    const float* __restrict__ w,     // [K, N]
    const float* __restrict__ bias,  // [N]
    const float* __restrict__ res,   // [M, N] residual (kResidual*)
    float* __restrict__ out,         // [M, N]
    int M, int N, int K) {
  constexpr int BM = kGemmBM, BN = kGemmBN, BK = kGemmBK;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = reinterpret_cast<float*>(smem + align128(sizeof(float) * BM * LDA));
  float* sc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sb) + align128(sizeof(float) * BK * LDB));

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
      const int r = i / BK, c = i % BK, gr = row0 + r;
      sa[r * LDA + c] = gr < M ? a[static_cast<size_t>(gr) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      sb[r * LDB + c] = col0 + c < N ? w[static_cast<size_t>(k0 + r) * N + col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          Tile<float>::mma<false>(acc[i][j], sa + (wr * 32 + i * 16) * LDA + kk, LDA,
                                  sb + kk * LDB + wc * 32 + j * 16, LDB);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      Tile<float>::store(sc + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, LDC, acc[i][j]);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN, gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    const size_t o = static_cast<size_t>(gr) * N + gc;
    const float rv = epilogue_reads_residual<EPI>() ? res[o] : 0.f;
    out[o] = apply_epilogue<float, EPI>(sc[r * LDC + c] + bias[gc], rv);
  }
}

// Launch one fp32 gemm_kernel instantiation; returns -1 for a shape it does
// not take, else the CUDA error code.
template <int EPI>
int launch_gemm(const float* a, const float* w, const float* bias, const float* res, float* out, int M, int N,
                int K, cudaStream_t stream) {
  if (!gemm_f32_takes(M, N, K)) return -1;
  constexpr size_t smem = gemm_smem_bytes();
  auto kernel = gemm_kernel<EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kThreads, smem, stream>>>(a, w, bias, res, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace evr

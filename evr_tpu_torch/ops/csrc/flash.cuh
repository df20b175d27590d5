// Attention over any sequence length in 64-row tiles, head dim D = 64 or 80:
// the forward of K1 (block_attn.cu), K3a (block_quant.cu) and K9
// (block_merged.cu), and the attention part of K5a's backward
// (block_attn_bwd.cu). Inputs are the rounded qkv [B*T, 3W] of the block
// (q, k, v of head h at columns h*D, W + h*D, 2W + h*D).
//
// Replaces: the attention core of evr_tpu/ops/block_fused.py::
// fused_attn_block (_attn_block_kernel) and of its backward
// (_attn_block_bwd_kernel). Rounding points of those kernels: q times
// 1/sqrt(d) in the element type, the scale itself rounded to it first
// (jnp.asarray(scale, dtype): 0.11181640625 at d = 80 in bf16), while dq is
// scaled by the unrounded fp32 value; scores in fp32; the causal fill -1e30;
// the row max over the WHOLE row before any exponent. A running-max (online)
// softmax would round P against a partial max, so every kernel here walks
// the key blocks more than once instead:
//
// - forward: pass 1 takes the row max, pass 2 sums exp(s - m) in fp32 and
//   accumulates round(exp(s - m)) . v; the sum divides after P.V and the head
//   output is rounded. In bf16 it runs on the warp-specialised TMA + wgmma
//   kernel of attn_sm90.cuh (launch_flash_fwd routes by the element type
//   alone), which keeps the scores in registers and k in shared memory
//   between the passes; this header's flash_fwd_kernel is the fp32 forward
//   (full fp32 on the CUDA cores, the on-card parity path);
// - backward, stats: the max, then the sum l, then pn = exp(s - m) / l in
//   fp32, o = round(round(pn) . v) (the backward's own o, not the forward's
//   divide-after-P.V one; it feeds dW_out) and D = rowsum(dpn * pn) with
//   dpn = do . v^T, kept per row with m and l;
// - backward, dq: per query tile over the key blocks,
//   ds = pn (dpn - D), dq = round(ds) . k * scale in fp32;
// - backward, dk and dv: per key tile over the query tiles,
//   dv = round(pn)^T . do and dk = round(ds)^T . (scaled q).
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the forward does
// 4 T^2 D operations per (sequence, head) against the T D elements each of
// q, k, v and o, bound by bytes at CLIP's lengths (attn_sm90.cuh has the
// figures); the backward does three times the products.
//
// The fp32 forward and the backward kernels: each block owns one (64-row
// tile, head, sequence). The tile edge (64 query rows, 64 keys) is fixed and
// the head dim is a template parameter: q, k, v and do tiles are [64][D + 8],
// the probability and ds tiles [64][72]. The [64, 64] products (q k^T, do
// v^T) contract over D (4 steps of 16 at 64, 5 at 80), two 16 x 16 output
// tiles per warp; the [64, D] products (P.V, dq, dk, dv) contract over 64 and
// spread their 4 D/16 output tiles over the 8 warps (16 at D = 64, 20 at D =
// 80, where warps 0-3 own a third). Tile products run on the warp tile
// product of common.cuh (bf16 through WMMA, fp32 as FMAs); the per-row
// softmax arithmetic is one warp per 8 rows. A causal tower skips the key
// blocks (or query tiles) that its mask empties.
#pragma once

#include "attn_sm90.cuh"
#include "common.cuh"

namespace evr {

constexpr int kFT = 64;         // the tile edge: query rows and keys per tile
constexpr int kFLDP = kFT + 8;  // probability and ds tiles [64][kFLDP] (T)
constexpr int kFLDS = kFT + 4;  // fp32 score tiles [64][kFLDS]

// the head dims the kernels take
inline bool flash_head_dim(int d) { return d == 64 || d == 80; }

template <typename T, int D>
struct FlashLayout {
  static_assert(D % 16 == 0, "head dim: a multiple of the 16-deep tile product");
  static constexpr int LDT = D + 8;  // q, k, v and do tiles [64][LDT] (T)
  static constexpr int LDO = D + 4;  // fp32 output tiles [64][LDO]
  static constexpr int kOutTiles = 4 * (D / 16);  // 16 x 16 tiles of a [64, D] output
  static constexpr int kPerWarp = (kOutTiles + 7) / 8;
  static constexpr size_t tile = align128(sizeof(T) * kFT * LDT);
  static constexpr size_t ptile = align128(sizeof(T) * kFT * kFLDP);
  static constexpr size_t ftile = align128(sizeof(float) * kFT * (LDO > kFLDS ? LDO : kFLDS));
  static constexpr size_t vec = align128(sizeof(float) * kFT);
};

template <typename T, int D>
using FlashAcc = typename Tile<T>::Acc[FlashLayout<T, D>::kPerWarp];

// rows [r0, r0 + 64) of a [*, ld] matrix (of one sequence), columns
// [col, col + D), into a T tile; rows >= T_ are zero. With ``scale`` each
// value is multiplied by ``mul`` and rounded to T (the scaled q).
template <typename T, int D>
__device__ void flash_load(T* dst, const T* src, size_t ld, int r0, int T_, int col, bool scale, float mul) {
  using L = FlashLayout<T, D>;
  for (int i = threadIdx.x; i < kFT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float v = 0.f;
    if (r0 + r < T_) {
      v = to_f(src[static_cast<size_t>(r0 + r) * ld + col + c]);
      if (scale) v = v * mul;
    }
    dst[r * L::LDT + c] = from_f<T>(v);
  }
}

// dst = a . b^T, a fp32 [64, 64] tile (row stride kFLDS), contracting the
// head dim of two [64][LDT] tiles (q k^T, do v^T). Warp w owns output tiles
// w and w + 8 (of 4 x 4).
template <typename T, int D>
__device__ void flash_scores(float* dst, const T* a, const T* b) {
  using L = FlashLayout<T, D>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int t = warp + 8 * p, tr = (t >> 2) * 16, tc = (t & 3) * 16;
    typename Tile<T>::Acc acc;
    Tile<T>::zero(acc);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
      Tile<T>::template mma<true>(acc, a + tr * L::LDT + kk, L::LDT, b + tc * L::LDT + kk, L::LDT);
    Tile<T>::store(dst + tr * kFLDS + tc, kFLDS, acc);
  }
}

// acc += op(a) . b over the tile's 64 rows: a is a [64][kFLDP] probability or
// ds tile (with AT, its transpose), b a [64][LDT] tile (v, k, do or q). Warp
// w owns the [64, D] output's tiles w, w + 8, w + 16 (those that exist).
template <typename T, int D, bool AT>
__device__ void flash_out_mm(FlashAcc<T, D>& acc, const T* a, const T* b) {
  using L = FlashLayout<T, D>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < L::kPerWarp; ++p) {
    const int t = warp + 8 * p;
    if (t >= L::kOutTiles) continue;  // the same for the whole warp
    const int tr = (t / (D / 16)) * 16, tc = (t % (D / 16)) * 16;
#pragma unroll
    for (int kk = 0; kk < kFT; kk += 16) {
      const T* pa = AT ? a + kk * kFLDP + tr : a + tr * kFLDP + kk;
      Tile<T>::template mma<false, AT>(acc[p], pa, kFLDP, b + kk * L::LDT + tc, L::LDT);
    }
  }
}

template <typename T, int D>
__device__ void flash_out_zero(FlashAcc<T, D>& acc) {
#pragma unroll
  for (int p = 0; p < FlashLayout<T, D>::kPerWarp; ++p) Tile<T>::zero(acc[p]);
}

// the [64, D] accumulators into a fp32 tile of row stride LDO
template <typename T, int D>
__device__ void flash_out_store(float* dst, const FlashAcc<T, D>& acc) {
  using L = FlashLayout<T, D>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < L::kPerWarp; ++p) {
    const int t = warp + 8 * p;
    if (t >= L::kOutTiles) continue;
    const int tr = (t / (D / 16)) * 16, tc = (t % (D / 16)) * 16;
    Tile<T>::store(dst + tr * L::LDO + tc, L::LDO, acc[p]);
  }
}

// score of query row i, key column j from the fp32 tile, with the causal fill
__device__ __forceinline__ float flash_score(const float* ss, int r, int jj, int i, int j, int causal) {
  return (causal && j > i) ? -1e30f : ss[r * kFLDS + jj];
}

__host__ __device__ __forceinline__ int flash_tiles(int T_) { return (T_ + kFT - 1) / kFT; }

// key blocks a query tile can see: all, or up to its own diagonal block
__device__ __forceinline__ int flash_key_blocks(int qt, int T_, int causal) {
  return causal ? min(qt + 1, flash_tiles(T_)) : flash_tiles(T_);
}

// pass 1 of every query-tile kernel: the row max of each of the warp's 8
// rows over the whole (masked) key row, in every lane. sq holds the scaled q
// tile; sk and ss are scratch.
template <typename T, int D>
__device__ void flash_row_max(float (&m)[8], const T* sq, T* sk, float* ss, const T* base, size_t ld,
                              int i0, int T_, int W, int h, int causal, int n_kb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 8; ++q) m[q] = -INFINITY;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load<T, D>(sk, base, ld, kb * kFT, T_, W + h * D, false, 1.f);
    __syncthreads();
    flash_scores<T, D>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFT; jj += 32) {
        const int j = kb * kFT + jj;
        if (j < T_) m[q] = fmaxf(m[q], flash_score(ss, r, jj, i, j, causal));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) m[q] = warp_max(m[q]);
}

// pass 2: l = sum over the row of exp(s - m), fp32, in every lane
template <typename T, int D>
__device__ void flash_row_sum(float (&l)[8], const float (&m)[8], const T* sq, T* sk, float* ss,
                              const T* base, size_t ld, int i0, int T_, int W, int h, int causal, int n_kb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 8; ++q) l[q] = 0.f;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load<T, D>(sk, base, ld, kb * kFT, T_, W + h * D, false, 1.f);
    __syncthreads();
    flash_scores<T, D>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFT; jj += 32) {
        const int j = kb * kFT + jj;
        if (j < T_) l[q] += expf(flash_score(ss, r, jj, i, j, causal) - m[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) l[q] = warp_sum(l[q]);
}

// -- forward (K1, K3a, K9), fp32 ------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                                                             int T_, int W, int causal, float scale) {
  static_assert(std::is_same<T, float>::value, "the bf16 forward runs on attn_sm90.cuh");
  using L = FlashLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sp = reinterpret_cast<T*>(smem + 3 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 3 * L::tile + L::ptile);
  float* s_l = reinterpret_cast<float*>(smem + 3 * L::tile + L::ptile + L::ftile);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * kFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const int n_kb = flash_key_blocks(qt, T_, causal);

  flash_load<T, D>(sq, base, ld, i0, T_, h * D, true, rnd<T>(scale));
  float m[8];
  flash_row_max<T, D>(m, sq, sk, ss, base, ld, i0, T_, W, h, causal, n_kb);

  // pass 2: the fp32 sum of exp(s - m) and round(exp(s - m)) . v
  float l[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) l[q] = 0.f;
  FlashAcc<T, D> acc;
  flash_out_zero<T, D>(acc);
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load<T, D>(sk, base, ld, kb * kFT, T_, W + h * D, false, 1.f);
    flash_load<T, D>(sv, base, ld, kb * kFT, T_, 2 * W + h * D, false, 1.f);
    __syncthreads();
    flash_scores<T, D>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFT; jj += 32) {
        const int j = kb * kFT + jj;
        float p = 0.f;
        if (j < T_) p = expf(flash_score(ss, r, jj, i, j, causal) - m[q]);
        l[q] += p;
        sp[r * kFLDP + jj] = from_f<T>(p);
      }
    }
    __syncthreads();
    flash_out_mm<T, D, false>(acc, sp, sv);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float sum = warp_sum(l[q]);
    if (lane == 0) s_l[warp * 8 + q] = sum;
  }
  __syncthreads();
  flash_out_store<T, D>(ss, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kFT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (i0 + r < T_)
      o[(static_cast<size_t>(b) * T_ + i0 + r) * W + h * D + c] = from_f<T>(ss[r * L::LDO + c] / s_l[r]);
  }
}

template <typename T, int D>
int launch_flash_fwd_d(const T* qkv, T* o, int B, int T_, int W, int H, int causal, float scale,
                       cudaStream_t stream) {
  using L = FlashLayout<T, D>;
  constexpr size_t smem = 3 * L::tile + L::ptile + L::ftile + L::vec;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(flash_tiles(T_), H, B), kThreads, smem, stream>>>(qkv, o, T_, W, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The attention forward at head dim W / H: bf16 on the wgmma kernel of
// attn_sm90.cuh, fp32 on flash_fwd_kernel; -1 for a head dim not taken.
template <typename T>
int launch_flash_fwd(const T* qkv, T* o, int B, int T_, int W, int H, int causal, float scale,
                     cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_attn_sm90_packed(qkv, o, B, T_, W, H, causal, scale, stream);
  } else {
    if (H < 1 || W % H != 0) return -1;
    if (W / H == 64) return launch_flash_fwd_d<T, 64>(qkv, o, B, T_, W, H, causal, scale, stream);
    if (W / H == 80) return launch_flash_fwd_d<T, 80>(qkv, o, B, T_, W, H, causal, scale, stream);
    return -1;
  }
}

// -- backward (K5a) ----------------------------------------------------------
// Per-row statistics live in [B, H, T_] fp32 arrays: the max m, the sum l and
// D = rowsum(dpn * pn).

// o = round(round(pn) . v), and m, l, D, per (query tile, head, sequence)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_stats_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ o, float* __restrict__ st_m,
    float* __restrict__ st_l, float* __restrict__ st_d, int T_, int W, int H, int causal, float scale) {
  using L = FlashLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sdo = reinterpret_cast<T*>(smem + 3 * L::tile);
  T* sp = reinterpret_cast<T*>(smem + 4 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 4 * L::tile + L::ptile);
  float* sdp = reinterpret_cast<float*>(smem + 4 * L::tile + L::ptile + L::ftile);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * kFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const T* dbase = dout + static_cast<size_t>(b) * T_ * W;
  const int n_kb = flash_key_blocks(qt, T_, causal);

  flash_load<T, D>(sq, base, ld, i0, T_, h * D, true, rnd<T>(scale));
  flash_load<T, D>(sdo, dbase, W, i0, T_, h * D, false, 1.f);
  float m[8], l[8], d[8];
  flash_row_max<T, D>(m, sq, sk, ss, base, ld, i0, T_, W, h, causal, n_kb);
  flash_row_sum<T, D>(l, m, sq, sk, ss, base, ld, i0, T_, W, h, causal, n_kb);

  // pass 3: pn, o, D
#pragma unroll
  for (int q = 0; q < 8; ++q) d[q] = 0.f;
  FlashAcc<T, D> acc;
  flash_out_zero<T, D>(acc);
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load<T, D>(sk, base, ld, kb * kFT, T_, W + h * D, false, 1.f);
    flash_load<T, D>(sv, base, ld, kb * kFT, T_, 2 * W + h * D, false, 1.f);
    __syncthreads();
    flash_scores<T, D>(ss, sq, sk);
    flash_scores<T, D>(sdp, sdo, sv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFT; jj += 32) {
        const int j = kb * kFT + jj;
        float pn = 0.f;
        if (j < T_) pn = expf(flash_score(ss, r, jj, i, j, causal) - m[q]) / l[q];
        d[q] += sdp[r * kFLDS + jj] * pn;
        sp[r * kFLDP + jj] = from_f<T>(pn);
      }
    }
    __syncthreads();
    flash_out_mm<T, D, false>(acc, sp, sv);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float dsum = warp_sum(d[q]);
    const int i = i0 + warp * 8 + q;
    if (lane == 0 && i < T_) {
      const size_t o_st = (static_cast<size_t>(b) * H + h) * T_ + i;
      st_m[o_st] = m[q];
      st_l[o_st] = l[q];
      st_d[o_st] = dsum;
    }
  }
  __syncthreads();
  flash_out_store<T, D>(ss, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kFT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (i0 + r < T_) o[(static_cast<size_t>(b) * T_ + i0 + r) * W + h * D + c] = from_f<T>(ss[r * L::LDO + c]);
  }
}

// pn and ds of one (query row, key column) from the score and dpn tiles
__device__ __forceinline__ void flash_pn_ds(float s, float dp, float m, float l, float dsum, bool valid,
                                            float& pn, float& ds) {
  pn = valid ? expf(s - m) / l : 0.f;
  ds = pn * (dp - dsum);
}

// dq = round(ds) . k * scale (fp32), per (query tile, head, sequence), into
// the q columns of dqkv [B*T, 3W], and rounded to T into dqkv_r's where
// dqkv_r is given (the bf16 operand of dW_qkv and dy)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ st_m,
    const float* __restrict__ st_l, const float* __restrict__ st_d, float* __restrict__ dqkv,
    T* __restrict__ dqkv_r, int T_, int W, int H, int causal, float scale) {
  using L = FlashLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sdo = reinterpret_cast<T*>(smem + 3 * L::tile);
  T* sds = reinterpret_cast<T*>(smem + 4 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 4 * L::tile + L::ptile);
  float* sdp = reinterpret_cast<float*>(smem + 4 * L::tile + L::ptile + L::ftile);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * kFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const T* dbase = dout + static_cast<size_t>(b) * T_ * W;
  const int n_kb = flash_key_blocks(qt, T_, causal);

  flash_load<T, D>(sq, base, ld, i0, T_, h * D, true, rnd<T>(scale));
  flash_load<T, D>(sdo, dbase, W, i0, T_, h * D, false, 1.f);
  float m[8], l[8], d[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = i0 + warp * 8 + q;
    const size_t o_st = (static_cast<size_t>(b) * H + h) * T_ + i;
    m[q] = i < T_ ? st_m[o_st] : 0.f;
    l[q] = i < T_ ? st_l[o_st] : 1.f;
    d[q] = i < T_ ? st_d[o_st] : 0.f;
  }
  FlashAcc<T, D> acc;
  flash_out_zero<T, D>(acc);
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load<T, D>(sk, base, ld, kb * kFT, T_, W + h * D, false, 1.f);
    flash_load<T, D>(sv, base, ld, kb * kFT, T_, 2 * W + h * D, false, 1.f);
    __syncthreads();
    flash_scores<T, D>(ss, sq, sk);
    flash_scores<T, D>(sdp, sdo, sv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFT; jj += 32) {
        const int j = kb * kFT + jj;
        float pn, ds;
        flash_pn_ds(flash_score(ss, r, jj, i, j, causal), sdp[r * kFLDS + jj], m[q], l[q], d[q], j < T_,
                    pn, ds);
        sds[r * kFLDP + jj] = from_f<T>(ds);
      }
    }
    __syncthreads();
    flash_out_mm<T, D, false>(acc, sds, sk);
  }
  __syncthreads();
  flash_out_store<T, D>(ss, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kFT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (i0 + r < T_) {
      const size_t o = (static_cast<size_t>(b) * T_ + i0 + r) * ld + h * D + c;
      const float v = ss[r * L::LDO + c] * scale;
      dqkv[o] = v;
      if (dqkv_r != nullptr) dqkv_r[o] = from_f<T>(v);
    }
  }
}

// dv = round(pn)^T . do and dk = round(ds)^T . (scaled q), per (key tile,
// head, sequence), into the k and v columns of dqkv (and, rounded to T, of
// dqkv_r where it is given)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ st_m,
    const float* __restrict__ st_l, const float* __restrict__ st_d, float* __restrict__ dqkv,
    T* __restrict__ dqkv_r, int T_, int W, int H, int causal, float scale) {
  using L = FlashLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sdo = reinterpret_cast<T*>(smem + 3 * L::tile);
  T* sp = reinterpret_cast<T*>(smem + 4 * L::tile);
  T* sds = reinterpret_cast<T*>(smem + 4 * L::tile + L::ptile);
  float* ss = reinterpret_cast<float*>(smem + 4 * L::tile + 2 * L::ptile);
  float* sdp = reinterpret_cast<float*>(smem + 4 * L::tile + 2 * L::ptile + L::ftile);
  float* s_m = reinterpret_cast<float*>(smem + 4 * L::tile + 2 * L::ptile + 2 * L::ftile);
  float* s_l = s_m + kFT;
  float* s_d = s_l + kFT;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, j0 = kt * kFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const T* dbase = dout + static_cast<size_t>(b) * T_ * W;
  const int n_qt = flash_tiles(T_);

  flash_load<T, D>(sk, base, ld, j0, T_, W + h * D, false, 1.f);
  flash_load<T, D>(sv, base, ld, j0, T_, 2 * W + h * D, false, 1.f);
  FlashAcc<T, D> dk, dv;
  flash_out_zero<T, D>(dk);
  flash_out_zero<T, D>(dv);
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int i0 = qt * kFT;
    __syncthreads();
    flash_load<T, D>(sq, base, ld, i0, T_, h * D, true, rnd<T>(scale));
    flash_load<T, D>(sdo, dbase, W, i0, T_, h * D, false, 1.f);
    for (int r = threadIdx.x; r < kFT; r += kThreads) {
      const int i = i0 + r;
      const size_t o_st = (static_cast<size_t>(b) * H + h) * T_ + i;
      s_m[r] = i < T_ ? st_m[o_st] : 0.f;
      s_l[r] = i < T_ ? st_l[o_st] : 1.f;
      s_d[r] = i < T_ ? st_d[o_st] : 0.f;
    }
    __syncthreads();
    flash_scores<T, D>(ss, sq, sk);
    flash_scores<T, D>(sdp, sdo, sv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFT; jj += 32) {
        const int j = j0 + jj;
        float pn, ds;
        flash_pn_ds(flash_score(ss, r, jj, i, j, causal), sdp[r * kFLDS + jj], s_m[r], s_l[r], s_d[r],
                    i < T_ && j < T_, pn, ds);
        sp[r * kFLDP + jj] = from_f<T>(pn);
        sds[r * kFLDP + jj] = from_f<T>(ds);
      }
    }
    __syncthreads();
    flash_out_mm<T, D, true>(dv, sp, sdo);
    flash_out_mm<T, D, true>(dk, sds, sq);
  }
  __syncthreads();
  flash_out_store<T, D>(ss, dk);
  flash_out_store<T, D>(sdp, dv);
  __syncthreads();
  for (int i = threadIdx.x; i < kFT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (j0 + r < T_) {
      const size_t o = (static_cast<size_t>(b) * T_ + j0 + r) * ld + h * D + c;
      const float dk_v = ss[r * L::LDO + c], dv_v = sdp[r * L::LDO + c];
      dqkv[o + W] = dk_v;
      dqkv[o + 2 * static_cast<size_t>(W)] = dv_v;
      if (dqkv_r != nullptr) {
        dqkv_r[o + W] = from_f<T>(dk_v);
        dqkv_r[o + 2 * static_cast<size_t>(W)] = from_f<T>(dv_v);
      }
    }
  }
}

template <typename T, int D>
int flash_backward_d(const T* qkv, const T* dout, T* o, float* st, float* dqkv, T* dqkv_r, int B, int T_, int W,
                     int H, int causal, float scale, cudaStream_t stream) {
  using L = FlashLayout<T, D>;
  const size_t n = static_cast<size_t>(B) * H * T_;
  float *st_m = st, *st_l = st + n, *st_d = st + 2 * n;
  const dim3 grid(flash_tiles(T_), H, B);
  constexpr size_t smem_a = 4 * L::tile + L::ptile + 2 * L::ftile;
  constexpr size_t smem_c = 4 * L::tile + 2 * L::ptile + 2 * L::ftile + 3 * L::vec;
  cudaError_t err;
  err = cudaFuncSetAttribute(flash_bwd_stats_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_stats_kernel<T, D><<<grid, kThreads, smem_a, stream>>>(qkv, dout, o, st_m, st_l, st_d, T_, W, H,
                                                                   causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem_a, stream>>>(qkv, dout, st_m, st_l, st_d, dqkv, dqkv_r, T_,
                                                                W, H, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem_c, stream>>>(qkv, dout, st_m, st_l, st_d, dqkv, dqkv_r,
                                                                  T_, W, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The attention backward at head dim W / H: o, the row statistics, then dq
// and dk/dv into the fp32 dqkv and, where dqkv_r is not null, rounded to T
// into dqkv_r. ``st`` holds 3 * B * H * T_ floats. -1 for a head dim not
// taken.
template <typename T>
int flash_backward(const T* qkv, const T* dout, T* o, float* st, float* dqkv, T* dqkv_r, int B, int T_, int W,
                   int H, int causal, float scale, cudaStream_t stream) {
  if (H < 1 || W % H != 0) return -1;
  if (W / H == 64)
    return flash_backward_d<T, 64>(qkv, dout, o, st, dqkv, dqkv_r, B, T_, W, H, causal, scale, stream);
  if (W / H == 80)
    return flash_backward_d<T, 80>(qkv, dout, o, st, dqkv, dqkv_r, B, T_, W, H, causal, scale, stream);
  return -1;
}

}  // namespace evr

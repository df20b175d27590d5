// Attention over any sequence length in 64-row tiles, head dim 64: the
// forward of K1 (block_attn.cu) and the attention part of K5a's backward
// (block_attn_bwd.cu). Inputs are the rounded qkv [B*T, 3W] of the block
// (q, k, v of head h at columns h*64, W + h*64, 2W + h*64).
//
// Rounding points of the reference kernels (_attn_block_kernel,
// _attn_block_bwd_kernel): q times 1/sqrt(d) in the element type; scores in
// fp32; the causal fill -1e30; the row max over the WHOLE row before any
// exponent. A running-max (online) softmax would round P against a partial
// max, so every kernel here walks the key blocks more than once instead:
//
// - forward: pass 1 takes the row max, pass 2 sums exp(s - m) in fp32 and
//   accumulates round(exp(s - m)) . v; the sum divides after P.V and the head
//   output is rounded;
// - backward, stats: the max, then the sum l, then pn = exp(s - m) / l in
//   fp32, o = round(round(pn) . v) (the backward's own o, not the forward's
//   divide-after-P.V one; it feeds dW_out) and D = rowsum(dpn * pn) with
//   dpn = do . v^T, kept per row with m and l;
// - backward, dq: per query tile over the key blocks,
//   ds = pn (dpn - D), dq = round(ds) . k * scale in fp32;
// - backward, dk and dv: per key tile over the query tiles,
//   dv = round(pn)^T . do and dk = round(ds)^T . (scaled q).
//
// Each block owns one (64-row tile, head, sequence); the 64 x 64 products run
// on the warp tile product of common.cuh (8 warps, two 16 x 16 output tiles
// each), and the per-row softmax arithmetic is one warp per 8 rows. A causal
// tower skips the key blocks (or query tiles) that its mask empties.
#pragma once

#include "common.cuh"

namespace evr {

constexpr int kFD = 64;  // head dim; also the tile edge for queries and keys

template <typename T>
struct FlashLayout {
  static constexpr int LDT = kFD + 8;  // q, k, v, do and probability tiles [64][LDT] (T)
  static constexpr int LDS = kFD + 4;  // fp32 tiles [64][LDS]
  static constexpr size_t tile = align128(sizeof(T) * kFD * LDT);
  static constexpr size_t ftile = align128(sizeof(float) * kFD * LDS);
  static constexpr size_t vec = align128(sizeof(float) * kFD);
};

// rows [r0, r0 + 64) of a [*, ld] matrix (of one sequence), columns
// [col, col + 64), into a T tile; rows >= T_ are zero. With ``scale`` each
// value is multiplied by ``mul`` and rounded to T (the scaled q).
template <typename T>
__device__ void flash_load(T* dst, const T* src, size_t ld, int r0, int T_, int col, bool scale, float mul) {
  using L = FlashLayout<T>;
  for (int i = threadIdx.x; i < kFD * kFD; i += kThreads) {
    const int r = i / kFD, c = i % kFD;
    float v = 0.f;
    if (r0 + r < T_) {
      v = to_f(src[static_cast<size_t>(r0 + r) * ld + col + c]);
      if (scale) v = v * mul;
    }
    dst[r * L::LDT + c] = from_f<T>(v);
  }
}

// acc += op(A) @ op(B) over a 64-deep contraction; A and B are 64x64 tiles of
// T with row stride LDT. Warp w owns output tiles w and w + 8 (of 4 x 4).
template <typename T, bool AT, bool BT>
__device__ void flash_mm(typename Tile<T>::Acc (&acc)[2], const T* a, const T* b) {
  using L = FlashLayout<T>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int t = warp + 8 * p, tr = (t >> 2) * 16, tc = (t & 3) * 16;
#pragma unroll
    for (int kk = 0; kk < kFD; kk += 16) {
      const T* pa = AT ? a + kk * L::LDT + tr : a + tr * L::LDT + kk;
      const T* pb = BT ? b + tc * L::LDT + kk : b + kk * L::LDT + tc;
      Tile<T>::template mma<BT, AT>(acc[p], pa, L::LDT, pb, L::LDT);
    }
  }
}

template <typename T>
__device__ void flash_zero(typename Tile<T>::Acc (&acc)[2]) {
  Tile<T>::zero(acc[0]);
  Tile<T>::zero(acc[1]);
}

template <typename T>
__device__ void flash_store(float* dst, const typename Tile<T>::Acc (&acc)[2]) {
  using L = FlashLayout<T>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int t = warp + 8 * p;
    Tile<T>::store(dst + (t >> 2) * 16 * L::LDS + (t & 3) * 16, L::LDS, acc[p]);
  }
}

// dst = op(A) @ op(B) as a fp32 64x64 tile
template <typename T, bool AT, bool BT>
__device__ void flash_product(float* dst, const T* a, const T* b) {
  typename Tile<T>::Acc acc[2];
  flash_zero<T>(acc);
  flash_mm<T, AT, BT>(acc, a, b);
  flash_store<T>(dst, acc);
}

// score of query row i, key column j from the fp32 tile, with the causal fill
__device__ __forceinline__ float flash_score(const float* ss, int r, int jj, int i, int j, int causal) {
  return (causal && j > i) ? -1e30f : ss[r * FlashLayout<float>::LDS + jj];
}

__device__ __forceinline__ int flash_tiles(int T_) { return (T_ + kFD - 1) / kFD; }

// key blocks a query tile can see: all, or up to its own diagonal block
__device__ __forceinline__ int flash_key_blocks(int qt, int T_, int causal) {
  return causal ? min(qt + 1, flash_tiles(T_)) : flash_tiles(T_);
}

// pass 1 of every query-tile kernel: the row max of each of the warp's 8
// rows over the whole (masked) key row, in every lane. sq holds the scaled q
// tile; sk and ss are scratch.
template <typename T>
__device__ void flash_row_max(float (&m)[8], const T* sq, T* sk, float* ss, const T* base, size_t ld,
                              int i0, int T_, int W, int h, int causal, int n_kb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 8; ++q) m[q] = -INFINITY;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load(sk, base, ld, kb * kFD, T_, W + h * kFD, false, 1.f);
    __syncthreads();
    flash_product<T, false, true>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFD; jj += 32) {
        const int j = kb * kFD + jj;
        if (j < T_) m[q] = fmaxf(m[q], flash_score(ss, r, jj, i, j, causal));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) m[q] = warp_max(m[q]);
}

// pass 2: l = sum over the row of exp(s - m), fp32, in every lane
template <typename T>
__device__ void flash_row_sum(float (&l)[8], const float (&m)[8], const T* sq, T* sk, float* ss,
                              const T* base, size_t ld, int i0, int T_, int W, int h, int causal, int n_kb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 8; ++q) l[q] = 0.f;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load(sk, base, ld, kb * kFD, T_, W + h * kFD, false, 1.f);
    __syncthreads();
    flash_product<T, false, true>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFD; jj += 32) {
        const int j = kb * kFD + jj;
        if (j < T_) l[q] += expf(flash_score(ss, r, jj, i, j, causal) - m[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) l[q] = warp_sum(l[q]);
}

// -- forward (K1) ------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                                                             int T_, int W, int causal, float scale) {
  using L = FlashLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sp = reinterpret_cast<T*>(smem + 3 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 4 * L::tile);
  float* s_l = reinterpret_cast<float*>(smem + 4 * L::tile + L::ftile);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * kFD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const int n_kb = flash_key_blocks(qt, T_, causal);

  flash_load(sq, base, ld, i0, T_, h * kFD, true, scale);
  float m[8];
  flash_row_max<T>(m, sq, sk, ss, base, ld, i0, T_, W, h, causal, n_kb);

  // pass 2: the fp32 sum of exp(s - m) and round(exp(s - m)) . v
  float l[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) l[q] = 0.f;
  typename Tile<T>::Acc acc[2];
  flash_zero<T>(acc);
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load(sk, base, ld, kb * kFD, T_, W + h * kFD, false, 1.f);
    flash_load(sv, base, ld, kb * kFD, T_, 2 * W + h * kFD, false, 1.f);
    __syncthreads();
    flash_product<T, false, true>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFD; jj += 32) {
        const int j = kb * kFD + jj;
        float p = 0.f;
        if (j < T_) p = expf(flash_score(ss, r, jj, i, j, causal) - m[q]);
        l[q] += p;
        sp[r * L::LDT + jj] = from_f<T>(p);
      }
    }
    __syncthreads();
    flash_mm<T, false, false>(acc, sp, sv);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float sum = warp_sum(l[q]);
    if (lane == 0) s_l[warp * 8 + q] = sum;
  }
  __syncthreads();
  flash_store<T>(ss, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kFD * kFD; i += kThreads) {
    const int r = i / kFD, c = i % kFD;
    if (i0 + r < T_)
      o[(static_cast<size_t>(b) * T_ + i0 + r) * W + h * kFD + c] = from_f<T>(ss[r * L::LDS + c] / s_l[r]);
  }
}

template <typename T>
int launch_flash_fwd(const T* qkv, T* o, int B, int T_, int W, int H, int causal, float scale,
                     cudaStream_t stream) {
  using L = FlashLayout<T>;
  constexpr size_t smem = 4 * L::tile + L::ftile + L::vec;
  auto kernel = flash_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((T_ + kFD - 1) / kFD, H, B), kThreads, smem, stream>>>(qkv, o, T_, W, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- backward (K5a) ----------------------------------------------------------
// Per-row statistics live in [B, H, T_] fp32 arrays: the max m, the sum l and
// D = rowsum(dpn * pn).

// o = round(round(pn) . v), and m, l, D, per (query tile, head, sequence)
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_stats_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ o, float* __restrict__ st_m,
    float* __restrict__ st_l, float* __restrict__ st_d, int T_, int W, int H, int causal, float scale) {
  using L = FlashLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sdo = reinterpret_cast<T*>(smem + 3 * L::tile);
  T* sp = reinterpret_cast<T*>(smem + 4 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 5 * L::tile);
  float* sdp = reinterpret_cast<float*>(smem + 5 * L::tile + L::ftile);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * kFD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const T* dbase = dout + static_cast<size_t>(b) * T_ * W;
  const int n_kb = flash_key_blocks(qt, T_, causal);

  flash_load(sq, base, ld, i0, T_, h * kFD, true, scale);
  flash_load(sdo, dbase, W, i0, T_, h * kFD, false, 1.f);
  float m[8], l[8], d[8];
  flash_row_max<T>(m, sq, sk, ss, base, ld, i0, T_, W, h, causal, n_kb);
  flash_row_sum<T>(l, m, sq, sk, ss, base, ld, i0, T_, W, h, causal, n_kb);

  // pass 3: pn, o, D
#pragma unroll
  for (int q = 0; q < 8; ++q) d[q] = 0.f;
  typename Tile<T>::Acc acc[2];
  flash_zero<T>(acc);
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load(sk, base, ld, kb * kFD, T_, W + h * kFD, false, 1.f);
    flash_load(sv, base, ld, kb * kFD, T_, 2 * W + h * kFD, false, 1.f);
    __syncthreads();
    flash_product<T, false, true>(ss, sq, sk);
    flash_product<T, false, true>(sdp, sdo, sv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFD; jj += 32) {
        const int j = kb * kFD + jj;
        float pn = 0.f;
        if (j < T_) pn = expf(flash_score(ss, r, jj, i, j, causal) - m[q]) / l[q];
        d[q] += sdp[r * L::LDS + jj] * pn;
        sp[r * L::LDT + jj] = from_f<T>(pn);
      }
    }
    __syncthreads();
    flash_mm<T, false, false>(acc, sp, sv);
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
  flash_store<T>(ss, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kFD * kFD; i += kThreads) {
    const int r = i / kFD, c = i % kFD;
    if (i0 + r < T_) o[(static_cast<size_t>(b) * T_ + i0 + r) * W + h * kFD + c] = from_f<T>(ss[r * L::LDS + c]);
  }
}

// pn and ds of one (query row, key column) from the score and dpn tiles
__device__ __forceinline__ void flash_pn_ds(float s, float dp, float m, float l, float dsum, bool valid,
                                            float& pn, float& ds) {
  pn = valid ? expf(s - m) / l : 0.f;
  ds = pn * (dp - dsum);
}

// dq = round(ds) . k * scale (fp32), per (query tile, head, sequence), into
// the q columns of dqkv [B*T, 3W]
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ st_m,
    const float* __restrict__ st_l, const float* __restrict__ st_d, float* __restrict__ dqkv, int T_, int W,
    int H, int causal, float scale) {
  using L = FlashLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sdo = reinterpret_cast<T*>(smem + 3 * L::tile);
  T* sds = reinterpret_cast<T*>(smem + 4 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 5 * L::tile);
  float* sdp = reinterpret_cast<float*>(smem + 5 * L::tile + L::ftile);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * kFD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const T* dbase = dout + static_cast<size_t>(b) * T_ * W;
  const int n_kb = flash_key_blocks(qt, T_, causal);

  flash_load(sq, base, ld, i0, T_, h * kFD, true, scale);
  flash_load(sdo, dbase, W, i0, T_, h * kFD, false, 1.f);
  float m[8], l[8], d[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = i0 + warp * 8 + q;
    const size_t o_st = (static_cast<size_t>(b) * H + h) * T_ + i;
    m[q] = i < T_ ? st_m[o_st] : 0.f;
    l[q] = i < T_ ? st_l[o_st] : 1.f;
    d[q] = i < T_ ? st_d[o_st] : 0.f;
  }
  typename Tile<T>::Acc acc[2];
  flash_zero<T>(acc);
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    flash_load(sk, base, ld, kb * kFD, T_, W + h * kFD, false, 1.f);
    flash_load(sv, base, ld, kb * kFD, T_, 2 * W + h * kFD, false, 1.f);
    __syncthreads();
    flash_product<T, false, true>(ss, sq, sk);
    flash_product<T, false, true>(sdp, sdo, sv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFD; jj += 32) {
        const int j = kb * kFD + jj;
        float pn, ds;
        flash_pn_ds(flash_score(ss, r, jj, i, j, causal), sdp[r * L::LDS + jj], m[q], l[q], d[q], j < T_,
                    pn, ds);
        sds[r * L::LDT + jj] = from_f<T>(ds);
      }
    }
    __syncthreads();
    flash_mm<T, false, false>(acc, sds, sk);
  }
  __syncthreads();
  flash_store<T>(ss, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kFD * kFD; i += kThreads) {
    const int r = i / kFD, c = i % kFD;
    if (i0 + r < T_) dqkv[(static_cast<size_t>(b) * T_ + i0 + r) * ld + h * kFD + c] = ss[r * L::LDS + c] * scale;
  }
}

// dv = round(pn)^T . do and dk = round(ds)^T . (scaled q), per (key tile,
// head, sequence), into the k and v columns of dqkv
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ st_m,
    const float* __restrict__ st_l, const float* __restrict__ st_d, float* __restrict__ dqkv, int T_, int W,
    int H, int causal, float scale) {
  using L = FlashLayout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sdo = reinterpret_cast<T*>(smem + 3 * L::tile);
  T* sp = reinterpret_cast<T*>(smem + 4 * L::tile);
  T* sds = reinterpret_cast<T*>(smem + 5 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 6 * L::tile);
  float* sdp = reinterpret_cast<float*>(smem + 6 * L::tile + L::ftile);
  float* s_m = reinterpret_cast<float*>(smem + 6 * L::tile + 2 * L::ftile);
  float* s_l = s_m + kFD;
  float* s_d = s_l + kFD;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, j0 = kt * kFD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* base = qkv + static_cast<size_t>(b) * T_ * ld;
  const T* dbase = dout + static_cast<size_t>(b) * T_ * W;
  const int n_qt = flash_tiles(T_);

  flash_load(sk, base, ld, j0, T_, W + h * kFD, false, 1.f);
  flash_load(sv, base, ld, j0, T_, 2 * W + h * kFD, false, 1.f);
  typename Tile<T>::Acc dk[2], dv[2];
  flash_zero<T>(dk);
  flash_zero<T>(dv);
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int i0 = qt * kFD;
    __syncthreads();
    flash_load(sq, base, ld, i0, T_, h * kFD, true, scale);
    flash_load(sdo, dbase, W, i0, T_, h * kFD, false, 1.f);
    for (int r = threadIdx.x; r < kFD; r += kThreads) {
      const int i = i0 + r;
      const size_t o_st = (static_cast<size_t>(b) * H + h) * T_ + i;
      s_m[r] = i < T_ ? st_m[o_st] : 0.f;
      s_l[r] = i < T_ ? st_l[o_st] : 1.f;
      s_d[r] = i < T_ ? st_d[o_st] : 0.f;
    }
    __syncthreads();
    flash_product<T, false, true>(ss, sq, sk);
    flash_product<T, false, true>(sdp, sdo, sv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q, i = i0 + r;
      for (int jj = lane; jj < kFD; jj += 32) {
        const int j = j0 + jj;
        float pn, ds;
        flash_pn_ds(flash_score(ss, r, jj, i, j, causal), sdp[r * L::LDS + jj], s_m[r], s_l[r], s_d[r],
                    i < T_ && j < T_, pn, ds);
        sp[r * L::LDT + jj] = from_f<T>(pn);
        sds[r * L::LDT + jj] = from_f<T>(ds);
      }
    }
    __syncthreads();
    flash_mm<T, true, false>(dv, sp, sdo);
    flash_mm<T, true, false>(dk, sds, sq);
  }
  __syncthreads();
  flash_store<T>(ss, dk);
  flash_store<T>(sdp, dv);
  __syncthreads();
  for (int i = threadIdx.x; i < kFD * kFD; i += kThreads) {
    const int r = i / kFD, c = i % kFD;
    if (j0 + r < T_) {
      const size_t o = (static_cast<size_t>(b) * T_ + j0 + r) * ld + h * kFD + c;
      dqkv[o + W] = ss[r * L::LDS + c];
      dqkv[o + 2 * static_cast<size_t>(W)] = sdp[r * L::LDS + c];
    }
  }
}

// The attention backward: o, the row statistics, then dq and dk/dv into the
// fp32 dqkv. ``st`` holds 3 * B * H * T_ floats.
template <typename T>
int flash_backward(const T* qkv, const T* dout, T* o, float* st, float* dqkv, int B, int T_, int W, int H,
                   int causal, float scale, cudaStream_t stream) {
  using L = FlashLayout<T>;
  const size_t n = static_cast<size_t>(B) * H * T_;
  float *st_m = st, *st_l = st + n, *st_d = st + 2 * n;
  const dim3 grid((T_ + kFD - 1) / kFD, H, B);
  constexpr size_t smem_a = 5 * L::tile + 2 * L::ftile;
  constexpr size_t smem_c = 6 * L::tile + 2 * L::ftile + 3 * L::vec;
  cudaError_t err;
  err = cudaFuncSetAttribute(flash_bwd_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_stats_kernel<T><<<grid, kThreads, smem_a, stream>>>(qkv, dout, o, st_m, st_l, st_d, T_, W, H,
                                                                causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem_a, stream>>>(qkv, dout, st_m, st_l, st_d, dqkv, T_, W, H,
                                                             causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, smem_c, stream>>>(qkv, dout, st_m, st_l, st_d, dqkv, T_, W, H,
                                                               causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace evr

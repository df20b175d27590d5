// The attention of one (head, sequence) once its q, k and v are in shared
// memory, shared by K1 (block_attn.cu) and K3a (block_quant.cu).
//
// Rounding points of the reference kernels (_attn_block_kernel,
// _attn_block_kernel_q): scores q.k^T in fp32, the softmax in fp32 with the
// causal fill -1e30, P rounded to the element type for P.v, the fp32 sum
// divided after P.v and the head output rounded.
#pragma once

#include "common.cuh"

namespace evr {

// Shared-memory tiles: q, k, v [TP, D] in the element type (row stride LDQ),
// then one region for the fp32 scores, the probabilities and the P.v sums.
template <typename T, int TP, int D>
struct AttnTiles {
  static constexpr int LDQ = D + 8, LDS = TP + 4, LDP = TP + 8, LDO = D + 4;
  static constexpr size_t qkv = align128(sizeof(T) * 3 * TP * LDQ);
  static constexpr size_t scores = align128(sizeof(float) * TP * LDS);
  static constexpr size_t probs = align128(sizeof(T) * TP * LDP);
  static constexpr size_t pv = align128(sizeof(float) * TP * LDO);
  static constexpr size_t attn = scores + probs + pv;
};

// q (already scaled and rounded), k and v of rows >= T_ must be zero. Writes
// the head's T_ x D output at ob, row stride ldo. Called by the whole block;
// starts and ends at a barrier-free point after the caller's __syncthreads.
template <typename T, int TP, int D>
__device__ void attend_head(const T* sq, const T* sk, const T* sv, unsigned char* region,
                            float* s_denom, int T_, int causal, T* ob, int ldo) {
  using L = AttnTiles<T, TP, D>;
  float* ss = reinterpret_cast<float*>(region);
  T* sp = reinterpret_cast<T*>(region + L::scores);
  float* so = reinterpret_cast<float*>(region + L::scores + L::probs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kThreads / 32;

  // scores q @ k^T, fp32
  for (int t = warp; t < (TP / 16) * (TP / 16); t += kWarps) {
    const int tr = t / (TP / 16), tc = t % (TP / 16);
    typename Tile<T>::Acc a;
    Tile<T>::zero(a);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
      Tile<T>::template mma<true>(a, sq + tr * 16 * L::LDQ + kk, L::LDQ, sk + tc * 16 * L::LDQ + kk,
                                  L::LDQ);
    Tile<T>::store(ss + tr * 16 * L::LDS + tc * 16, L::LDS, a);
  }
  __syncthreads();

  // softmax numerators, one warp per row; padded keys get exactly 0
  for (int r = warp; r < TP; r += kWarps) {
    float m = -INFINITY;
    if (r < T_)
      for (int j = lane; j < T_; j += 32) {
        const float s = (causal && j > r) ? -1e30f : ss[r * L::LDS + j];
        m = fmaxf(m, s);
      }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < TP; j += 32) {
      float p = 0.f;
      if (r < T_ && j < T_) {
        const float s = (causal && j > r) ? -1e30f : ss[r * L::LDS + j];
        p = expf(s - m);
      }
      sum += p;
      sp[r * L::LDP + j] = from_f<T>(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) s_denom[r] = sum;
  }
  __syncthreads();

  // P @ v, fp32
  for (int t = warp; t < (TP / 16) * (D / 16); t += kWarps) {
    const int tr = t / (D / 16), tc = t % (D / 16);
    typename Tile<T>::Acc a;
    Tile<T>::zero(a);
#pragma unroll
    for (int kk = 0; kk < TP; kk += 16)
      Tile<T>::template mma<false>(a, sp + tr * 16 * L::LDP + kk, L::LDP, sv + kk * L::LDQ + tc * 16,
                                   L::LDQ);
    Tile<T>::store(so + tr * 16 * L::LDO + tc * 16, L::LDO, a);
  }
  __syncthreads();

  // divide after P.V, round, write the head's columns
  for (int i = tid; i < T_ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    ob[static_cast<size_t>(r) * ldo + c] = from_f<T>(so[r * L::LDO + c] / s_denom[r]);
  }
}

}  // namespace evr

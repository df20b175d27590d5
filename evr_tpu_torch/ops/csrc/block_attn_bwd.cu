// K5a: the backward of the attention half, out = x + out_proj(MHA(LN1(x))):
//     from x [B, T, W] and the output's cotangent g, dx (x's dtype) and the
//     fp32 gradients of LN1's scale and bias, W_qkv [W, 3W], b_qkv, W_out
//     [W, W] and b_out, summed over all B*T rows. Head dim 16, 64 or 80, W a
//     multiple of 64, any T.
//
// Replaces: evr_tpu/ops/block_fused.py::fused_attn_block_bwd (Pallas kernel
// body _attn_block_bwd_kernel). Like it, nothing of the forward is saved but
// x: LN1, qkv and the per-head softmax are recomputed. Rounding points
// reproduced from it: y = LN1(x) rounded; qkv rounded after the fp32 bias
// add; do = g W_out^T in fp32, rounded (per head, do_h); q scaled in the
// element type; pn = exp(s - m) / l in fp32 and rounded for o and dv; o =
// round(round(pn) v), not the forward's divide-after-P.V head output, feeds
// dW_out; ds = pn (dpn - rowsum(dpn pn)) with fp32 pn; dq = round(ds) k scale
// and dk = round(ds)^T (scaled q) in fp32; the qkv bias gradient sums the fp32
// dqkv, dW_qkv and dy use dqkv rounded; the LN backward in fp32 and dx =
// g + dx_ln rounded once.
//
// Bound on an H100 SXM (bf16, dense 989 TFLOP/s, 3.35 TB/s) at the training
// shape, ViT-L/14@336px vision, B=32 T=577 W=1024 H=16: per sequence
// 22 T W^2 (the QKV recompute, do, dW_out, dW_qkv and dy) + 12 T^2 W (scores,
// P.V, dpn, dv, dq, dk), 557 GFLOP = 0.56 ms, against 96 MB of x, g, dx,
// weights and fp32 gradients = 29 us: bound by operations.
//
// Design: a chain of launches on the shared pieces. (1) LN1 rows (y, mean,
// rstd); (2) qkv = y W_qkv + b (rounded); (3) do = g W_out^T (rounded); (4-6)
// the attention backward (flash.cuh's flash_backward: in bf16 two
// warp-specialised TMA + wgmma kernels of attn_bwd_sm90.cuh, per query tile
// the max and the sum, pn, o, D and dq, then per key tile dk and dv; in fp32
// three CUDA-core kernels), written as fp32 dqkv [B*T, 3W] and, in bf16, as
// round(dqkv) beside it; (7) b_qkv's gradient, a fixed-order column sum of
// the fp32 dqkv; (8) dW_qkv = y^T round(dqkv), over all rows; (9) dy =
// round(dqkv) W_qkv^T; (10) the LN backward and its column sums; (11) dW_out
// = o^T g; (12) b_out's gradient.
// In bf16 the five products (2, 3, 8, 9, 11) run on the wgmma + TMA kernel of
// gemm_sm90.cuh: y and g K-major; W_qkv MN-major for (2), W_out^T and W_qkv^T
// K-major from their [in, out] arrays for (3) and (9); y^T and o^T MN-major
// from their [rows, W] arrays for the weight gradients (8) and (11), whose
// ragged K (the rows) TMA pads with zeros; (11) has 32 output tiles at W
// 1,024 and is split into four slices of rows summed in order by a second
// pass. In fp32 they run on gemm_t (CUDA-core fp32, the parity path). Weight
// gradients never go through atomics. What is left: the attention backward
// (4-6) recomputes q k^T four times and do v^T three times (11 products where
// 6 would do) and is still the largest part of K5a; the intermediates (qkv,
// do, o, dqkv in fp32 and bf16, dy, about 0.6 GB at the training shape) go
// through device memory; no persistent grid.

#include "flash.cuh"
#include "grad_common.cuh"

namespace evr {

// The five products of the bf16 backward, as (M, N, K) in their layouts
// (ops/block_fused.py::attn_bwd_gemms mirrors this).
inline bool attn_bwd_gemms_take(int M, int W) {
  return gemm_takes<false, false>(M, 3 * W, W) && gemm_takes<false, true>(M, W, W) &&
         gemm_takes<true, false>(W, 3 * W, M) && gemm_takes<false, true>(M, W, 3 * W) &&
         gemm_takes<true, false>(W, W, M);
}

template <typename T>
int attn_block_bwd(const T* x, const T* g, const T* ln_s, const T* ln_b, const T* qkv_k, const T* qkv_b,
                   const T* out_k, T* dx, float* dls, float* dlb, float* dqkvk, float* dqkvb, float* doutk,
                   float* doutb, T* y, float* mean, float* rstd, T* qkv, T* dout, T* o, float* st,
                   float* dqkv, T* dqkv_r, float* dy, float* partial, float* split, int B, int T_, int W, int H,
                   int causal, float scale, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  if (H < 1 || W % H != 0 || !flash_head_dim(W / H) || T_ < 1) return -1;
  const int M = B * T_, W3 = 3 * W;
  if (kBf16 ? !attn_bwd_gemms_take(M, W) || dqkv_r == nullptr : W % (kTBN / 2) != 0) return -1;
  int rc = launch_ln_rows<T>(x, ln_s, ln_b, y, mean, rstd, M, W, stream);
  if (rc != 0) return rc;
  if constexpr (kBf16) {
    rc = launch_gemm_sm90<kRound>(y, qkv_k, GemmOut{qkv_b, nullptr, qkv, nullptr}, M, W3, W, nullptr, stream);
    if (rc != 0) return rc;
    rc = launch_gemm_sm90<kRound, false, true>(g, out_k, GemmOut{nullptr, nullptr, dout, nullptr}, M, W, W,
                                               nullptr, stream);
  } else {
    rc = launch_gemm_t<false, false>(y, W, qkv_k, W3, M, W3, W, EpiBias{qkv, qkv_b, W3}, stream);
    if (rc != 0) return rc;
    rc = launch_gemm_t<false, true>(g, W, out_k, W, M, W, W, EpiBias{dout, nullptr, W}, stream);
  }
  if (rc != 0) return rc;
  rc = flash_backward<T>(qkv, dout, o, st, dqkv, kBf16 ? dqkv_r : nullptr, B, T_, W, H, causal, scale, stream);
  if (rc != 0) return rc;
  rc = launch_colsum(ColF32{dqkv, W3}, partial, dqkvb, M, W3, stream);
  if (rc != 0) return rc;
  if constexpr (kBf16) {
    const GemmOut to_dqkvk{nullptr, nullptr, dqkvk, nullptr}, to_dy{nullptr, nullptr, dy, nullptr};
    rc = launch_gemm_sm90<kF32, true, false>(y, dqkv_r, to_dqkvk, W, W3, M, split, stream);
    if (rc != 0) return rc;
    rc = launch_gemm_sm90<kF32, false, true>(dqkv_r, qkv_k, to_dy, M, W, W3, nullptr, stream);
  } else {
    rc = launch_gemm_t<true, false>(y, W, dqkv, W3, W, W3, M, EpiF32{dqkvk, W3}, stream);
    if (rc != 0) return rc;
    rc = launch_gemm_t<false, true>(dqkv, W3, qkv_k, W3, M, W, W3, EpiF32{dy, W}, stream);
  }
  if (rc != 0) return rc;
  rc = ln_backward<T>(x, mean, rstd, dy, ln_s, g, dx, dls, dlb, partial, M, W, stream);
  if (rc != 0) return rc;
  if constexpr (kBf16)
    rc = launch_gemm_sm90<kF32, true, false>(o, g, GemmOut{nullptr, nullptr, doutk, nullptr}, W, W, M, split,
                                             stream);
  else
    rc = launch_gemm_t<true, false>(o, W, g, W, W, W, M, EpiF32{doutk, W}, stream);
  if (rc != 0) return rc;
  return launch_colsum(ColElt<T>{g, W}, partial, doutb, M, W, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16. Inputs x,
// g and the six parameters in the element type (out_b is not read: its
// gradient is g's column sum); outputs dx (element type) and six fp32
// gradients; then scratch: y [B*T, W], mean and rstd [B*T], qkv [B*T, 3W],
// do and o [B*T, W] in the element type, st [3, B, H, T], dqkv [B*T, 3W] in
// fp32, dqkv_r [B*T, 3W] in bf16 (bf16 calls; null for fp32), dy [B*T, W] in
// fp32, ``partial`` of ceil(B*T / 128) * 3W floats, and ``split``, the fp32
// partials of a split weight gradient (bf16 calls: the most of splits x M x N
// over dW_qkv and dW_out, see gemm_k_slice; null where neither splits).
// Returns 0, -1 for a shape the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_attn_block_bwd(int dtype, const void* x, const void* g, const void* ln_s,
                                        const void* ln_b, const void* qkv_k, const void* qkv_b,
                                        const void* out_k, void* dx, void* dls, void* dlb, void* dqkvk,
                                        void* dqkvb, void* doutk, void* doutb, void* y, void* mean,
                                        void* rstd, void* qkv, void* dout, void* o, void* st, void* dqkv,
                                        void* dqkv_r, void* dy, void* partial, void* split, int B, int T, int W,
                                        int H, int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0) {
    using E = float;
    return evr::attn_block_bwd<E>(
        static_cast<const E*>(x), static_cast<const E*>(g), static_cast<const E*>(ln_s),
        static_cast<const E*>(ln_b), static_cast<const E*>(qkv_k), static_cast<const E*>(qkv_b),
        static_cast<const E*>(out_k), static_cast<E*>(dx), f(dls), f(dlb), f(dqkvk), f(dqkvb), f(doutk),
        f(doutb), static_cast<E*>(y), f(mean), f(rstd), static_cast<E*>(qkv), static_cast<E*>(dout),
        static_cast<E*>(o), f(st), f(dqkv), nullptr, f(dy), f(partial), nullptr, B, T, W, H, causal, scale, s);
  }
  if (dtype == 1) {
    using E = evr::bf16;
    return evr::attn_block_bwd<E>(
        static_cast<const E*>(x), static_cast<const E*>(g), static_cast<const E*>(ln_s),
        static_cast<const E*>(ln_b), static_cast<const E*>(qkv_k), static_cast<const E*>(qkv_b),
        static_cast<const E*>(out_k), static_cast<E*>(dx), f(dls), f(dlb), f(dqkvk), f(dqkvb), f(doutk),
        f(doutb), static_cast<E*>(y), f(mean), f(rstd), static_cast<E*>(qkv), static_cast<E*>(dout),
        static_cast<E*>(o), f(st), f(dqkv), static_cast<E*>(dqkv_r), f(dy), f(partial), f(split), B, T, W, H,
        causal, scale, s);
  }
  return -1;
}

// K5a's attention backward alone (steps 4-6 above: o, the statistics st, the
// fp32 dqkv and, in bf16, dqkv_r) from qkv and do [B*T, 3W] / [B*T, W] in the
// element type, for checking and timing it apart from the GEMMs; no path
// calls it. Returns 0, -1 for a shape it does not take, or a CUDA error code.
extern "C" int evr_flash_backward(int dtype, const void* qkv, const void* dout, void* o, void* st, void* dqkv,
                                  void* dqkv_r, int B, int T, int W, int H, int causal, float scale,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1) return -1;
  if (dtype == 0)
    return evr::flash_backward<float>(static_cast<const float*>(qkv), static_cast<const float*>(dout),
                                      static_cast<float*>(o), static_cast<float*>(st), static_cast<float*>(dqkv),
                                      nullptr, B, T, W, H, causal, scale, s);
  if (dtype == 1)
    return evr::flash_backward<evr::bf16>(
        static_cast<const evr::bf16*>(qkv), static_cast<const evr::bf16*>(dout), static_cast<evr::bf16*>(o),
        static_cast<float*>(st), static_cast<float*>(dqkv), static_cast<evr::bf16*>(dqkv_r), B, T, W, H,
        causal, scale, s);
  return -1;
}

// The wgmma GEMM alone in the layouts and outputs of K5's products, for
// checking and timing it on its own; no path calls it. out[M, N] = op(a) @
// op(b) (+ bias), a stored [M, K] or, with a_t, [K, M]; b stored [K, N] or,
// with b_t, [N, K]; out_f32 0: rounded to bf16 after the optional bias (K5a's
// qkv and do), 1: fp32 as it is (the weight gradients, dy; split as in K5,
// with ``split`` its partials, or into slices of k_slice rows where k_slice
// is not 0). Taken: (a_t, b_t, out_f32) = (0, 1, 0), (1, 0, 1), (0, 1, 1);
// the forward layout is evr_gemm_bf16's (block_mlp.cu). Returns 0, -1 for a
// layout, shape or alignment not taken, or a CUDA error code.
extern "C" int evr_gemm_bf16_t(const void* a, const void* b, const void* bias, void* out, void* split, int M,
                               int N, int K, int a_t, int b_t, int out_f32, int k_slice, void* stream) {
  using evr::bf16;
  using evr::GemmOut;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const bf16*>(a);
  auto pb = static_cast<const bf16*>(b);
  const GemmOut o{static_cast<const bf16*>(bias), nullptr, out, nullptr};
  auto f = static_cast<float*>(split);
  if (!a_t && b_t && !out_f32)
    return evr::launch_gemm_sm90<evr::kRound, false, true>(pa, pb, o, M, N, K, nullptr, s, k_slice);
  if (bias != nullptr) return -1;
  if (a_t && !b_t && out_f32)
    return evr::launch_gemm_sm90<evr::kF32, true, false>(pa, pb, o, M, N, K, f, s, k_slice);
  if (!a_t && b_t && out_f32)
    return evr::launch_gemm_sm90<evr::kF32, false, true>(pa, pb, o, M, N, K, f, s, k_slice);
  return -1;
}

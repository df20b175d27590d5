// K5a: the backward of the attention half, out = x + out_proj(MHA(LN1(x))):
//     from x [B, T, W] and the output's cotangent g, dx (x's dtype) and the
//     fp32 gradients of LN1's scale and bias, W_qkv [W, 3W], b_qkv, W_out
//     [W, W] and b_out, summed over all B*T rows. Head dim 64 or 80, any T.
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
// rstd); (2) qkv = y W_qkv + b (gemm_t, rounded); (3) do = g W_out^T (gemm_t,
// rounded); (4-6) the attention backward of flash.cuh (per query tile: the
// max, the sum, then pn, o and D; per query tile dq; per key tile dk and
// dv), written as fp32 dqkv [B*T, 3W]; (7) b_qkv's gradient, a fixed-order
// column sum; (8) dW_qkv = y^T round(dqkv), one launch over all rows; (9)
// dy = round(dqkv) W_qkv^T; (10) the LN backward and its column sums; (11)
// dW_out = o^T g; (12) b_out's gradient. Weight gradients sum over rows
// inside one launch per output tile, never through atomics. The
// intermediates (qkv, do, o, fp32 dqkv and dy, about 0.5 GB at the training
// shape) go through device memory, and the attention recomputes QK^T five
// times; both are the costs of this simple version.

#include "flash.cuh"
#include "grad_common.cuh"

namespace evr {

template <typename T>
int attn_block_bwd(const T* x, const T* g, const T* ln_s, const T* ln_b, const T* qkv_k, const T* qkv_b,
                   const T* out_k, T* dx, float* dls, float* dlb, float* dqkvk, float* dqkvb, float* doutk,
                   float* doutb, T* y, float* mean, float* rstd, T* qkv, T* dout, T* o, float* st,
                   float* dqkv, float* dy, float* partial, int B, int T_, int W, int H, int causal, float scale,
                   cudaStream_t stream) {
  if (H < 1 || W % H != 0 || !flash_head_dim(W / H) || W % kTBN != 0 || T_ < 1) return -1;
  const int M = B * T_, W3 = 3 * W;
  int rc = launch_ln_rows<T>(x, ln_s, ln_b, y, mean, rstd, M, W, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, false, T, false>(y, W, qkv_k, W3, M, W3, W, EpiRound<T>{qkv, qkv_b, W3}, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, false, T, true>(g, W, out_k, W, M, W, W, EpiRound<T>{dout, nullptr, W}, stream);
  if (rc != 0) return rc;
  rc = flash_backward<T>(qkv, dout, o, st, dqkv, B, T_, W, H, causal, scale, stream);
  if (rc != 0) return rc;
  rc = launch_colsum(ColF32{dqkv, W3}, partial, dqkvb, M, W3, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, true, float, false>(y, W, dqkv, W3, W, W3, M, EpiF32{dqkvk, W3}, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, float, false, T, true>(dqkv, W3, qkv_k, W3, M, W, W3, EpiF32{dy, W}, stream);
  if (rc != 0) return rc;
  rc = ln_backward<T>(x, mean, rstd, dy, ln_s, g, dx, dls, dlb, partial, M, W, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, true, T, false>(o, W, g, W, W, W, M, EpiF32{doutk, W}, stream);
  if (rc != 0) return rc;
  return launch_colsum(ColElt<T>{g, W}, partial, doutb, M, W, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16. Inputs x,
// g and the six parameters in the element type (out_b is not read: its
// gradient is g's column sum); outputs dx (element type) and six fp32
// gradients; then scratch: y [B*T, W], mean and rstd [B*T], qkv [B*T, 3W],
// do and o [B*T, W] in the element type, st [3, B, H, T], dqkv [B*T, 3W] and
// dy [B*T, W] in fp32, and ``partial`` of ceil(B*T / 128) * 3W floats.
// Returns 0, -1 for a shape the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_attn_block_bwd(int dtype, const void* x, const void* g, const void* ln_s,
                                        const void* ln_b, const void* qkv_k, const void* qkv_b,
                                        const void* out_k, void* dx, void* dls, void* dlb, void* dqkvk,
                                        void* dqkvb, void* doutk, void* doutb, void* y, void* mean,
                                        void* rstd, void* qkv, void* dout, void* o, void* st, void* dqkv,
                                        void* dy, void* partial, int B, int T, int W, int H, int causal,
                                        float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0) {
    using E = float;
    return evr::attn_block_bwd<E>(
        static_cast<const E*>(x), static_cast<const E*>(g), static_cast<const E*>(ln_s),
        static_cast<const E*>(ln_b), static_cast<const E*>(qkv_k), static_cast<const E*>(qkv_b),
        static_cast<const E*>(out_k), static_cast<E*>(dx), f(dls), f(dlb), f(dqkvk), f(dqkvb), f(doutk),
        f(doutb), static_cast<E*>(y), f(mean), f(rstd), static_cast<E*>(qkv), static_cast<E*>(dout),
        static_cast<E*>(o), f(st), f(dqkv), f(dy), f(partial), B, T, W, H, causal, scale, s);
  }
  if (dtype == 1) {
    using E = evr::bf16;
    return evr::attn_block_bwd<E>(
        static_cast<const E*>(x), static_cast<const E*>(g), static_cast<const E*>(ln_s),
        static_cast<const E*>(ln_b), static_cast<const E*>(qkv_k), static_cast<const E*>(qkv_b),
        static_cast<const E*>(out_k), static_cast<E*>(dx), f(dls), f(dlb), f(dqkvk), f(dqkvb), f(doutk),
        f(doutb), static_cast<E*>(y), f(mean), f(rstd), static_cast<E*>(qkv), static_cast<E*>(dout),
        static_cast<E*>(o), f(st), f(dqkv), f(dy), f(partial), B, T, W, H, causal, scale, s);
  }
  return -1;
}

// K5b: the backward of the MLP half, out = x + proj(act(fc(LN2(x)))): from
//     x [rows, W] and the output's cotangent g, dx (x's dtype) and the fp32
//     gradients of LN2's scale and bias, W_fc [W, 4W], b_fc, W_proj [4W, W]
//     and b_proj, summed over all rows.
//
// Replaces: evr_tpu/ops/block_fused.py::fused_mlp_block_bwd (Pallas kernel
// body _mlp_block_bwd_kernel). Like it, nothing of the forward is saved but
// x: LN2, fc and the activation are recomputed. Rounding points reproduced
// from it: y = LN2(x) rounded; h_pre = y W_fc + b in fp32; the activation and
// its derivative in fp32 (quickGELU, or exact GELU with the A-S 7.1.26 erf);
// h rounded for dW_proj; dh_pre = (g W_proj^T) act'(h_pre) in fp32, rounded
// for dW_fc and dy; b_fc's gradient sums the fp32 dh_pre; the LN backward in
// fp32 and dx = g + dx_ln rounded once.
//
// Bound on an H100 SXM (bf16, dense 989 TFLOP/s, 3.35 TB/s) at the training
// shape, ViT-L/14@336px vision, 32 x 577 = 18,464 rows of W=1024 with a
// 4,096-wide hidden layer: per row 40 W^2 (the fc recompute, dW_proj, dh,
// dW_fc and dy), 774 GFLOP = 0.78 ms, against 159 MB of x, g, dx, weights and
// fp32 gradients = 47 us: bound by operations.
//
// Design: a chain of launches on the shared pieces of grad_common.cuh. (1)
// LN2 rows (y, mean, rstd); (2) h_pre = y W_fc + b, kept in fp32, and h =
// round(act(h_pre)) (a two-output epilogue); (3) dW_proj = h^T g, over all
// rows; (4) b_proj's gradient, a fixed-order column sum; (5) dh_pre =
// (g W_proj^T) act'(h_pre), written over h_pre in place, and, in bf16,
// round(dh_pre) beside it; (6) b_fc's gradient, from the fp32 dh_pre; (7)
// dW_fc = y^T round(dh_pre); (8) dy = round(dh_pre) W_fc^T; (9) the LN
// backward and its column sums. In bf16 the five products (2, 3, 5, 7, 8) run
// on the wgmma + TMA kernel of gemm_sm90.cuh, its activation epilogues
// writing both outputs of (2) and (5) from the accumulators: y, g and
// round(dh_pre) K-major; W_fc MN-major for (2); W_proj^T and W_fc^T K-major
// from their [in, out] arrays for (5) and (8); h^T and y^T MN-major from
// their [rows, width] arrays for the weight gradients (3) and (7), whose
// ragged K (the rows) TMA pads with zeros. In fp32 they run on gemm_t
// (CUDA-core fp32, the parity path). What is left: h_pre/dh_pre (302 MB in
// fp32 at the training shape), h and round(dh_pre) go through device memory,
// where the TPU kernel keeps them on chip; no persistent grid.

#include "grad_common.cuh"

namespace evr {

struct EpiActFwd {  // h_pre = sum + b (fp32, kept) and h = act(h_pre)
  const float* bias;
  float* pre;
  float* h;
  int ld, act;
  __device__ void operator()(int m, int n, float v) const {
    const float hp = v + bias[n];
    const size_t o = static_cast<size_t>(m) * ld + n;
    pre[o] = hp;
    h[o] = act == 0 ? quick_gelu(hp) : gelu_as(hp);
  }
};

struct EpiActGrad {  // dh_pre = sum * act'(h_pre), over h_pre in place
  float* pre;
  int ld, act;
  __device__ void operator()(int m, int n, float v) const {
    const size_t o = static_cast<size_t>(m) * ld + n;
    pre[o] = v * (act == 0 ? quick_gelu_grad(pre[o]) : gelu_grad(pre[o]));
  }
};

// The five products of the bf16 backward, as (M, N, K) in their layouts
// (ops/block_fused.py::mlp_bwd_gemms mirrors this).
inline bool mlp_bwd_gemms_take(int M, int W, int HID) {
  return gemm_takes<false, false>(M, HID, W) && gemm_takes<true, false>(HID, W, M) &&
         gemm_takes<false, true>(M, HID, W) && gemm_takes<true, false>(W, HID, M) &&
         gemm_takes<false, true>(M, W, HID);
}

// (2) and (5) in bf16, the activation chosen at compile time
int mlp_fc_act(const bf16* y, const bf16* fc_k, const bf16* fc_b, float* pre, bf16* h, int M, int W, int HID,
               int act, cudaStream_t stream) {
  const GemmOut o{fc_b, nullptr, pre, h};
  if (act == 0) return launch_gemm_sm90<kActFwdQuick>(y, fc_k, o, M, HID, W, nullptr, stream);
  return launch_gemm_sm90<kActFwdGelu>(y, fc_k, o, M, HID, W, nullptr, stream);
}

int mlp_dh_act(const bf16* g, const bf16* pr_k, float* pre, bf16* dhp, int M, int W, int HID, int act,
               cudaStream_t stream) {
  const GemmOut o{nullptr, nullptr, pre, dhp};
  if (act == 0) return launch_gemm_sm90<kActGradQuick, false, true>(g, pr_k, o, M, HID, W, nullptr, stream);
  return launch_gemm_sm90<kActGradGelu, false, true>(g, pr_k, o, M, HID, W, nullptr, stream);
}

template <typename T>
int mlp_block_bwd(const T* x, const T* g, const T* ln_s, const T* ln_b, const T* fc_k, const T* fc_b,
                  const T* pr_k, T* dx, float* dls, float* dlb, float* dfck, float* dfcb, float* dprk,
                  float* dprb, T* y, float* mean, float* rstd, float* pre, T* h, T* dhp, float* dy, float* partial,
                  float* split, int M, int W, int HID, int act, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  if (M < 1 || (act != 0 && act != 1)) return -1;
  if (kBf16 ? !mlp_bwd_gemms_take(M, W, HID) || dhp == nullptr : W % (kTBN / 2) != 0 || HID % (kTBN / 2) != 0)
    return -1;
  int rc = launch_ln_rows<T>(x, ln_s, ln_b, y, mean, rstd, M, W, stream);
  if (rc != 0) return rc;
  if constexpr (kBf16) {
    rc = mlp_fc_act(y, fc_k, fc_b, pre, h, M, W, HID, act, stream);
    if (rc != 0) return rc;
    rc = launch_gemm_sm90<kF32, true, false>(h, g, GemmOut{nullptr, nullptr, dprk, nullptr}, HID, W, M, split,
                                             stream);
  } else {
    rc = launch_gemm_t<false, false>(y, W, fc_k, HID, M, HID, W, EpiActFwd{fc_b, pre, h, HID, act}, stream);
    if (rc != 0) return rc;
    rc = launch_gemm_t<true, false>(h, HID, g, W, HID, W, M, EpiF32{dprk, W}, stream);
  }
  if (rc != 0) return rc;
  rc = launch_colsum(ColElt<T>{g, W}, partial, dprb, M, W, stream);
  if (rc != 0) return rc;
  if constexpr (kBf16)
    rc = mlp_dh_act(g, pr_k, pre, dhp, M, W, HID, act, stream);
  else
    rc = launch_gemm_t<false, true>(g, W, pr_k, W, M, HID, W, EpiActGrad{pre, HID, act}, stream);
  if (rc != 0) return rc;
  rc = launch_colsum(ColF32{pre, HID}, partial, dfcb, M, HID, stream);
  if (rc != 0) return rc;
  if constexpr (kBf16) {
    rc = launch_gemm_sm90<kF32, true, false>(y, dhp, GemmOut{nullptr, nullptr, dfck, nullptr}, W, HID, M, split,
                                             stream);
    if (rc != 0) return rc;
    rc = launch_gemm_sm90<kF32, false, true>(dhp, fc_k, GemmOut{nullptr, nullptr, dy, nullptr}, M, W, HID,
                                             nullptr, stream);
  } else {
    rc = launch_gemm_t<true, false>(y, W, pre, HID, W, HID, M, EpiF32{dfck, HID}, stream);
    if (rc != 0) return rc;
    rc = launch_gemm_t<false, true>(pre, HID, fc_k, HID, M, W, HID, EpiF32{dy, W}, stream);
  }
  if (rc != 0) return rc;
  return ln_backward<T>(x, mean, rstd, dy, ln_s, g, dx, dls, dlb, partial, M, W, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; act 0 =
// quickGELU, 1 = exact GELU. Inputs x, g and the parameters in the element
// type (proj_b is not read: its gradient is g's column sum); outputs dx
// (element type) and six fp32 gradients; then scratch: y [M, W] and h
// [M, HID] in the element type, mean and rstd [M], pre [M, HID] in fp32, dhp
// [M, HID] in bf16 (bf16 calls; null for fp32), dy [M, W] in fp32,
// ``partial`` of ceil(M / 128) * HID floats, and ``split``, the fp32 partials
// of a split weight gradient (bf16 calls: the most of splits x M x N over
// dW_proj and dW_fc, see gemm_k_slice; null where neither splits). Returns
// 0, -1 for a shape the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_mlp_block_bwd(int dtype, const void* x, const void* g, const void* ln_s,
                                       const void* ln_b, const void* fc_k, const void* fc_b, const void* pr_k,
                                       void* dx, void* dls, void* dlb, void* dfck, void* dfcb, void* dprk,
                                       void* dprb, void* y, void* mean, void* rstd, void* pre, void* h,
                                       void* dhp, void* dy, void* partial, void* split, int M, int W, int HID,
                                       int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0) {
    using E = float;
    return evr::mlp_block_bwd<E>(static_cast<const E*>(x), static_cast<const E*>(g),
                                 static_cast<const E*>(ln_s), static_cast<const E*>(ln_b),
                                 static_cast<const E*>(fc_k), static_cast<const E*>(fc_b),
                                 static_cast<const E*>(pr_k), static_cast<E*>(dx), f(dls), f(dlb), f(dfck),
                                 f(dfcb), f(dprk), f(dprb), static_cast<E*>(y), f(mean), f(rstd), f(pre),
                                 static_cast<E*>(h), nullptr, f(dy), f(partial), nullptr, M, W, HID, act, s);
  }
  if (dtype == 1) {
    using E = evr::bf16;
    return evr::mlp_block_bwd<E>(static_cast<const E*>(x), static_cast<const E*>(g),
                                 static_cast<const E*>(ln_s), static_cast<const E*>(ln_b),
                                 static_cast<const E*>(fc_k), static_cast<const E*>(fc_b),
                                 static_cast<const E*>(pr_k), static_cast<E*>(dx), f(dls), f(dlb), f(dfck),
                                 f(dfcb), f(dprk), f(dprb), static_cast<E*>(y), f(mean), f(rstd), f(pre),
                                 static_cast<E*>(h), static_cast<E*>(dhp), f(dy), f(partial), f(split), M, W,
                                 HID, act, s);
  }
  return -1;
}

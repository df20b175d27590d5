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
// round(act(h_pre)) (gemm_t with a two-output epilogue); (3) dW_proj = h^T g,
// one launch over all rows; (4) b_proj's gradient, a fixed-order column sum;
// (5) dh_pre = (g W_proj^T) act'(h_pre), written over h_pre in place; (6)
// b_fc's gradient; (7) dW_fc = y^T round(dh_pre); (8) dy = round(dh_pre)
// W_fc^T; (9) the LN backward and its column sums. h_pre and dh_pre (302 MB
// in fp32 at the training shape) and h go through device memory, the cost of
// this simple version; the TPU kernel keeps them on chip.

#include "grad_common.cuh"

namespace evr {

__device__ __forceinline__ float act_grad(float h, int act) {
  if (act == 0) {  // quickGELU
    const float sig = 1.f / (1.f + expf(-1.702f * h));
    return sig * (1.f + 1.702f * h * (1.f - sig));
  }
  // d/dh [h Phi(h)] = Phi(h) + h phi(h), Phi = 0.5 (1 + erf(h / sqrt 2))
  const float pdf = 0.3989422804014327f * expf(-0.5f * h * h);
  return 0.5f * (1.f + erf_as(h * 0.7071067811865476f)) + h * pdf;
}

template <typename T>
struct EpiActFwd {  // h_pre = sum + b (fp32, kept) and h = round(act(h_pre))
  const T* bias;
  float* pre;
  T* h;
  int ld, act;
  __device__ void operator()(int m, int n, float v) const {
    const float hp = v + to_f(bias[n]);
    const size_t o = static_cast<size_t>(m) * ld + n;
    pre[o] = hp;
    h[o] = from_f<T>(act == 0 ? quick_gelu(hp) : gelu_as(hp));
  }
};

struct EpiActGrad {  // dh_pre = sum * act'(h_pre), over h_pre in place
  float* pre;
  int ld, act;
  __device__ void operator()(int m, int n, float v) const {
    const size_t o = static_cast<size_t>(m) * ld + n;
    pre[o] = v * act_grad(pre[o], act);
  }
};

template <typename T>
int mlp_block_bwd(const T* x, const T* g, const T* ln_s, const T* ln_b, const T* fc_k, const T* fc_b,
                  const T* pr_k, T* dx, float* dls, float* dlb, float* dfck, float* dfcb, float* dprk,
                  float* dprb, T* y, float* mean, float* rstd, float* pre, T* h, float* dy, float* partial,
                  int M, int W, int HID, int act, cudaStream_t stream) {
  if (W % kTBN != 0 || HID % kTBN != 0 || M < 1 || (act != 0 && act != 1)) return -1;
  int rc = launch_ln_rows<T>(x, ln_s, ln_b, y, mean, rstd, M, W, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, false, T, false>(y, W, fc_k, HID, M, HID, W, EpiActFwd<T>{fc_b, pre, h, HID, act},
                                            stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, true, T, false>(h, HID, g, W, HID, W, M, EpiF32{dprk, W}, stream);
  if (rc != 0) return rc;
  rc = launch_colsum(ColElt<T>{g, W}, partial, dprb, M, W, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, false, T, true>(g, W, pr_k, W, M, HID, W, EpiActGrad{pre, HID, act}, stream);
  if (rc != 0) return rc;
  rc = launch_colsum(ColF32{pre, HID}, partial, dfcb, M, HID, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, T, true, float, false>(y, W, pre, HID, W, HID, M, EpiF32{dfck, HID}, stream);
  if (rc != 0) return rc;
  rc = launch_gemm_t<T, float, false, T, true>(pre, HID, fc_k, HID, M, W, HID, EpiF32{dy, W}, stream);
  if (rc != 0) return rc;
  return ln_backward<T>(x, mean, rstd, dy, ln_s, g, dx, dls, dlb, partial, M, W, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; act 0 =
// quickGELU, 1 = exact GELU. Inputs x, g and the parameters in the element
// type (proj_b is not read: its gradient is g's column sum); outputs dx
// (element type) and six fp32 gradients; then scratch: y [M, W] and h
// [M, HID] in the element type, mean and rstd [M], pre [M, HID] and dy [M, W]
// in fp32, and ``partial`` of ceil(M / 128) * HID floats. Returns 0, -1 for a
// shape the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_mlp_block_bwd(int dtype, const void* x, const void* g, const void* ln_s,
                                       const void* ln_b, const void* fc_k, const void* fc_b, const void* pr_k,
                                       void* dx, void* dls, void* dlb, void* dfck, void* dfcb, void* dprk,
                                       void* dprb, void* y, void* mean, void* rstd, void* pre, void* h,
                                       void* dy, void* partial, int M, int W, int HID, int act,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0) {
    using E = float;
    return evr::mlp_block_bwd<E>(static_cast<const E*>(x), static_cast<const E*>(g),
                                 static_cast<const E*>(ln_s), static_cast<const E*>(ln_b),
                                 static_cast<const E*>(fc_k), static_cast<const E*>(fc_b),
                                 static_cast<const E*>(pr_k), static_cast<E*>(dx), f(dls), f(dlb), f(dfck),
                                 f(dfcb), f(dprk), f(dprb), static_cast<E*>(y), f(mean), f(rstd), f(pre),
                                 static_cast<E*>(h), f(dy), f(partial), M, W, HID, act, s);
  }
  if (dtype == 1) {
    using E = evr::bf16;
    return evr::mlp_block_bwd<E>(static_cast<const E*>(x), static_cast<const E*>(g),
                                 static_cast<const E*>(ln_s), static_cast<const E*>(ln_b),
                                 static_cast<const E*>(fc_k), static_cast<const E*>(fc_b),
                                 static_cast<const E*>(pr_k), static_cast<E*>(dx), f(dls), f(dlb), f(dfck),
                                 f(dfcb), f(dprk), f(dprb), static_cast<E*>(y), f(mean), f(rstd), f(pre),
                                 static_cast<E*>(h), f(dy), f(partial), M, W, HID, act, s);
  }
  return -1;
}

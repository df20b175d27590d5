// K2: the MLP half of a pre-LN residual block,
//     out = x + proj(act(fc(LN2(x)))),  rows x W, bf16 or fp32.
//
// Replaces: evr_tpu/ops/block_fused.py::fused_mlp_block (Pallas kernel body
// _mlp_block_kernel). Rounding points reproduced from it: LN statistics in
// fp32, y rounded to the element type; fc accumulated in fp32 plus the bias;
// quickGELU, or exact GELU with erf from Abramowitz-Stegun 7.1.26, in fp32;
// h rounded; proj accumulated in fp32 plus the bias; the residual rounded
// twice, as the sum of x and the rounded projection in the element type.
//
// Bound on an H100 SXM at the main-path shapes (bf16, dense 989 TFLOP/s,
// 3.35 TB/s): ViT-B/32 vision, 12,800 rows of W=768 with a 3,072-wide hidden
// layer, does 60.4 GFLOP in fc and 60.4 in proj, 120.8 GFLOP = 122 us,
// against 48.8 MB of x, out and weights = 15 us: bound by operations. The
// text tower (1,232 rows of W=512) does 5.2 GFLOP = 5.2 us against 6.7 MB.
//
// Design: three launches. (1) the LayerNorm row pass (layer_norm_kernel,
// common.cuh, K8's device code) writes y = round(LN2(x) * s + b) into a
// scratch [rows, W]; (2) the GEMM with fc + bias + activation as its
// epilogue writes h in the element type; (3) the GEMM h @ proj + bias with
// the two-rounding residual as its epilogue. In bf16 both GEMMs run on the
// warp-specialised wgmma + TMA kernel of gemm_sm90.cuh; in fp32 on the
// CUDA-core GEMM of common.cuh (full fp32). What bounds it on this card: the
// two GEMMs are all of its operations, and the old row-tiled WMMA GEMM ran
// them at 3.6 % of the bf16 peak (scalar loads, one stage, no overlap of
// loads and products); the wgmma GEMM keeps a 4-stage TMA ring ahead of the
// tensor cores. The TPU kernel keeps h in VMEM; here y and h make a round
// trip through device memory (at ViT-H-14's vision shape 168 and 674 MB,
// about 0.5 ms at 3.35 TB/s against the GEMMs' 1.74 ms bound), the largest
// cost this version accepts.

#include "gemm_sm90.cuh"

namespace evr {

template <typename T>
int mlp_block(const T* x, const float* ln_s, const float* ln_b, const T* fc_k, const T* fc_b, const T* pr_k,
              const T* pr_b, T* y, T* h, T* out, int M, int W, int HID, int act, cudaStream_t stream) {
  if (!block_gemm_takes<T>(M, HID, W) || !block_gemm_takes<T>(M, W, HID) || (act != 0 && act != 1)) return -1;
  int rc = launch_layer_norm<T>(x, ln_s, ln_b, y, M, W, false, stream);
  if (rc != 0) return rc;
  if (act == 0)
    rc = block_gemm<kQuickGelu>(y, fc_k, fc_b, nullptr, h, M, HID, W, stream);
  else
    rc = block_gemm<kGelu>(y, fc_k, fc_b, nullptr, h, M, HID, W, stream);
  if (rc != 0) return rc;
  return block_gemm<kResidualTwice>(h, pr_k, pr_b, x, out, M, W, HID, stream);
}

template <typename T>
int mlp_block_c(const void* x, const void* ln_s, const void* ln_b, const void* const* p, void* y, void* h,
                void* out, int M, int W, int HID, int act, cudaStream_t stream) {
  auto c = [p](int i) { return static_cast<const T*>(p[i]); };
  return mlp_block<T>(static_cast<const T*>(x), static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                      c(0), c(1), c(2), c(3), static_cast<T*>(y), static_cast<T*>(h), static_cast<T*>(out), M, W,
                      HID, act, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; act 0 =
// quickGELU, 1 = exact GELU. x [rows, W] and the kernels and biases in that
// dtype; ln_s and ln_b [W] fp32 (the values of the element-type LN
// parameters); y [rows, W] and h [rows, HID] are scratch. Returns 0, -1 for a
// shape the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_mlp_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                   const void* fc_k, const void* fc_b, const void* pr_k, const void* pr_b, void* y,
                                   void* h, void* out, int M, int W, int HID, int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const void* p[4] = {fc_k, fc_b, pr_k, pr_b};
  if (dtype == 0) return evr::mlp_block_c<float>(x, ln_s, ln_b, p, y, h, out, M, W, HID, act, s);
  if (dtype == 1) return evr::mlp_block_c<evr::bf16>(x, ln_s, ln_b, p, y, h, out, M, W, HID, act, s);
  return -1;
}

// The bf16 GEMM alone, out[M, N] = round(a[M, K] @ w[K, N] + bias) (the kRound
// epilogue; bias may be null), for checking and timing it on its own;
// nothing on the serving or training path calls it. Returns 0, -1 for a
// shape or alignment the kernel does not take, or a CUDA error code.
extern "C" int evr_gemm_bf16(const void* a, const void* w, const void* bias, void* out, int M, int N, int K,
                             void* stream) {
  return evr::launch_gemm_sm90<evr::kRound>(
      static_cast<const evr::bf16*>(a), static_cast<const evr::bf16*>(w),
      evr::GemmOut{static_cast<const evr::bf16*>(bias), nullptr, out, nullptr}, M, N, K, nullptr,
      static_cast<cudaStream_t>(stream));
}

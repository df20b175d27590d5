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
// Design: two launches of the shared row-tiled GEMM (common.cuh) on the
// tensor cores, bf16 WMMA with fp32 accumulation. (1) LN2 as the A-operand
// prologue (row statistics per 64-row tile, normalisation applied while the
// tile is staged) and fc + bias + activation as the epilogue, writing h in the
// element type; (2) h @ proj + bias with the two-rounding residual as the
// epilogue. The TPU kernel keeps h in VMEM; here h makes a round trip through
// device memory (2 x 78.6 MB at the vision shape, about 47 us at the memory
// rate), the largest cost this simple first version accepts.

#include "common.cuh"

namespace evr {

template <typename T>
int mlp_block(const T* x, const T* ln_s, const T* ln_b, const T* fc_k, const T* fc_b,
              const T* pr_k, const T* pr_b, T* h, T* out, int M, int W, int HID, int act,
              cudaStream_t stream) {
  if (W % kGemmBN != 0 || HID % kGemmBN != 0 || W % kGemmBK != 0 || HID % kGemmBK != 0 || M < 1)
    return -1;
  int rc;
  if (act == 0)
    rc = launch_gemm<T, kLayerNorm, kQuickGelu>(x, ln_s, ln_b, fc_k, fc_b, nullptr, h, M, HID, W, stream);
  else if (act == 1)
    rc = launch_gemm<T, kLayerNorm, kGelu>(x, ln_s, ln_b, fc_k, fc_b, nullptr, h, M, HID, W, stream);
  else
    return -1;
  if (rc != 0) return rc;
  return launch_gemm<T, kPlain, kResidualTwice>(h, nullptr, nullptr, pr_k, pr_b, x, out, M, W, HID,
                                                stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; act 0 =
// quickGELU, 1 = exact GELU. Returns 0, -1 for a shape the kernel does not
// take, or a CUDA error code.
extern "C" int evr_fused_mlp_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                   const void* fc_k, const void* fc_b, const void* pr_k,
                                   const void* pr_b, void* h, void* out, int M, int W, int HID,
                                   int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return evr::mlp_block<float>(
        static_cast<const float*>(x), static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
        static_cast<const float*>(fc_k), static_cast<const float*>(fc_b),
        static_cast<const float*>(pr_k), static_cast<const float*>(pr_b), static_cast<float*>(h),
        static_cast<float*>(out), M, W, HID, act, s);
  if (dtype == 1)
    return evr::mlp_block<evr::bf16>(
        static_cast<const evr::bf16*>(x), static_cast<const evr::bf16*>(ln_s),
        static_cast<const evr::bf16*>(ln_b), static_cast<const evr::bf16*>(fc_k),
        static_cast<const evr::bf16*>(fc_b), static_cast<const evr::bf16*>(pr_k),
        static_cast<const evr::bf16*>(pr_b), static_cast<evr::bf16*>(h), static_cast<evr::bf16*>(out),
        M, W, HID, act, s);
  return -1;
}

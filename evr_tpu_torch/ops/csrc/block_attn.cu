// K1: the attention half of a pre-LN residual block,
//     out = x + out_proj(MHA(LN1(x))),  x [B, T, W] bf16 or fp32, head dim 64
//     or 80, any T.
//
// Replaces: evr_tpu/ops/block_fused.py::fused_attn_block (Pallas kernel body
// _attn_block_kernel). Rounding points reproduced from it: LN statistics in
// fp32, y rounded to the element type; QKV GEMM accumulated in fp32 plus the
// bias, rounded; q times 1/sqrt(d) in the element type; scores and softmax in
// fp32 with the causal fill -1e30 and the max over the whole row; P rounded
// for P.V, the fp32 sum divides after P.V and the head output is rounded;
// out-proj accumulated in fp32 plus the bias, added to x in fp32 and rounded
// once.
//
// Bound on an H100 SXM (bf16, dense 989 TFLOP/s, 3.35 TB/s), operations per
// sequence 8 T W^2 (QKV and out-proj) + 4 T^2 W (scores and P.V): ViT-B/32
// vision serving, B=256 T=50 W=768 H=12, 62.4 GFLOP = 63 us against 44 MB of
// x, out and weights = 13 us; ViT-L/14@336px training, B=32 T=577 W=1024
// H=16, 199 GFLOP = 0.20 ms against 80 MB = 24 us. Bound by operations.
//
// Design: three launches. (1) the shared row-tiled GEMM (common.cuh) with
// LN1 as its A-operand prologue and bias + rounding as its epilogue writes
// qkv [B*T, 3W]; (2) flash_fwd_kernel (flash.cuh), one block per (64-row
// query tile, head, sequence), walks the key blocks twice (the row max, then
// the sum and P.V) so that P is rounded against the row's true max, and
// writes the head output o; (3) the shared GEMM for o @ out_kernel + bias +
// x. qkv and o make a round trip through device memory (at the training
// shape 2 x 113 MB and 2 x 38 MB), and QK^T is computed twice; both are the
// costs this simple version accepts. Every product runs on the tensor cores
// in bf16 (WMMA, fp32 accumulation); fp32 calls multiply on the CUDA cores.

#include "flash.cuh"

namespace evr {

template <typename T>
int attn_block(const T* x, const T* ln_s, const T* ln_b, const T* qkv_k, const T* qkv_b, const T* out_k,
               const T* out_b, T* qkv, T* o, T* out, int B, int T_, int W, int H, int causal, float scale,
               cudaStream_t stream) {
  if (H < 1 || W % H != 0 || !flash_head_dim(W / H) || W % kGemmBN != 0 || T_ < 1) return -1;
  const int M = B * T_;
  int rc = launch_gemm<T, kLayerNorm, kRound>(x, ln_s, ln_b, qkv_k, qkv_b, nullptr, qkv, M, 3 * W, W, stream);
  if (rc != 0) return rc;
  rc = launch_flash_fwd<T>(qkv, o, B, T_, W, H, causal, scale, stream);
  if (rc != 0) return rc;
  return launch_gemm<T, kPlain, kResidualOnce>(o, nullptr, nullptr, out_k, out_b, x, out, M, W, W, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16. qkv
// [B*T, 3W] and o [B*T, W] are scratch. Returns 0, -1 for a shape the kernel
// does not take, or a CUDA error code.
extern "C" int evr_fused_attn_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                    const void* qkv_k, const void* qkv_b, const void* out_k,
                                    const void* out_b, void* qkv, void* o, void* out, int B, int T, int W,
                                    int H, int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return evr::attn_block<float>(
        static_cast<const float*>(x), static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
        static_cast<const float*>(qkv_k), static_cast<const float*>(qkv_b),
        static_cast<const float*>(out_k), static_cast<const float*>(out_b), static_cast<float*>(qkv),
        static_cast<float*>(o), static_cast<float*>(out), B, T, W, H, causal, scale, s);
  if (dtype == 1)
    return evr::attn_block<evr::bf16>(
        static_cast<const evr::bf16*>(x), static_cast<const evr::bf16*>(ln_s),
        static_cast<const evr::bf16*>(ln_b), static_cast<const evr::bf16*>(qkv_k),
        static_cast<const evr::bf16*>(qkv_b), static_cast<const evr::bf16*>(out_k),
        static_cast<const evr::bf16*>(out_b), static_cast<evr::bf16*>(qkv), static_cast<evr::bf16*>(o),
        static_cast<evr::bf16*>(out), B, T, W, H, causal, scale, s);
  return -1;
}

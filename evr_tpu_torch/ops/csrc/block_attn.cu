// K1: the attention half of a pre-LN residual block,
//     out = x + out_proj(MHA(LN1(x))),  x [B, T, W] bf16 or fp32, head dim
//     16, 64 or 80, any T, W a multiple of 64.
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
// Design: four launches. (1) the LayerNorm row pass (layer_norm_kernel,
// common.cuh, K8's device code) writes y = round(LN1(x) * s + b) into a
// scratch [B*T, W]; (2) the GEMM writes qkv = round(y @ W_qkv + b) [B*T, 3W];
// (3) the attention core (flash.cuh's launch_flash_fwd) writes the head
// outputs o; (4) the GEMM for o @ out_kernel + bias + x. In bf16 both GEMMs
// run on the warp-specialised wgmma + TMA kernel of gemm_sm90.cuh (128 x 256
// tiles, a 4-stage ring, 16-byte epilogue) and the core on the one of
// attn_sm90.cuh (a producer warp loading q, k and v tiles of the packed qkv
// by 3-D TMA, two consumer warpgroups per pair of 64-row query tiles, both
// walks over the keys on wgmma with the scores in registers, k resident in
// shared memory between them); in fp32 on the CUDA-core GEMM of common.cuh
// and flash.cuh's flash_fwd_kernel (full fp32). What bounds it on this card:
// the GEMMs are 91 % of the operations at ViT-H-14's vision shape (862 of 949
// GFLOP); the core is bound by its bytes (qkv read and o written once: 673.7
// MB = 0.20 ms there), and the two walks do 1.5 times the products of one
// pass. y, qkv and o make a round trip through device memory (at ViT-H-14's
// shape 168, 505 and 168 MB), a cost of a few hundredths of a millisecond
// each at 3.35 TB/s. ``evr_flash_forward`` runs the core alone.

#include "flash.cuh"
#include "gemm_sm90.cuh"

namespace evr {

template <typename T>
int attn_block(const T* x, const float* ln_s, const float* ln_b, const T* qkv_k, const T* qkv_b, const T* out_k,
               const T* out_b, T* y, T* qkv, T* o, T* out, int B, int T_, int W, int H, int causal, float scale,
               cudaStream_t stream) {
  if (B < 1 || T_ < 1 || H < 1 || W % H != 0 || !flash_head_dim(W / H)) return -1;
  const int M = B * T_;
  if (!block_gemm_takes<T>(M, 3 * W, W) || !block_gemm_takes<T>(M, W, W)) return -1;
  int rc = launch_layer_norm<T>(x, ln_s, ln_b, y, M, W, false, stream);
  if (rc != 0) return rc;
  rc = block_gemm<kRound>(y, qkv_k, qkv_b, nullptr, qkv, M, 3 * W, W, stream);
  if (rc != 0) return rc;
  rc = launch_flash_fwd<T>(qkv, o, B, T_, W, H, causal, scale, stream);
  if (rc != 0) return rc;
  return block_gemm<kResidualOnce>(o, out_k, out_b, x, out, M, W, W, stream);
}

template <typename T>
int attn_block_c(const void* x, const void* ln_s, const void* ln_b, const void* const* p, void* const* scratch,
                 void* out, int B, int T_, int W, int H, int causal, float scale, cudaStream_t stream) {
  auto c = [p](int i) { return static_cast<const T*>(p[i]); };
  auto m = [scratch](int i) { return static_cast<T*>(scratch[i]); };
  return attn_block<T>(static_cast<const T*>(x), static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                       c(0), c(1), c(2), c(3), m(0), m(1), m(2), static_cast<T*>(out), B, T_, W, H, causal, scale,
                       stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16. x [B*T, W]
// and the kernels and biases in that dtype; ln_s and ln_b [W] fp32 (the
// values of the element-type LN parameters). y [B*T, W], qkv [B*T, 3W] and o
// [B*T, W] are scratch. Returns 0, -1 for a shape the kernel does not take,
// or a CUDA error code.
extern "C" int evr_fused_attn_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                    const void* qkv_k, const void* qkv_b, const void* out_k,
                                    const void* out_b, void* y, void* qkv, void* o, void* out, int B, int T, int W,
                                    int H, int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const void* p[4] = {qkv_k, qkv_b, out_k, out_b};
  void* scratch[3] = {y, qkv, o};
  if (dtype == 0) return evr::attn_block_c<float>(x, ln_s, ln_b, p, scratch, out, B, T, W, H, causal, scale, s);
  if (dtype == 1) return evr::attn_block_c<evr::bf16>(x, ln_s, ln_b, p, scratch, out, B, T, W, H, causal, scale, s);
  return -1;
}

// The attention core alone (launch_flash_fwd), for checking and timing it
// apart from the GEMMs: qkv [B*T, 3W] as the QKV GEMM writes it, o [B*T, W].
// dtype 0 = float32, 1 = bfloat16; ``scale`` is 1/sqrt(d), rounded to the
// element type inside. Returns 0, -1 for a shape it does not take, or a
// CUDA error code.
extern "C" int evr_flash_forward(int dtype, const void* qkv, void* o, int B, int T, int W, int H, int causal,
                                 float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || W % H != 0 || !evr::flash_head_dim(W / H)) return -1;
  if (dtype == 0)
    return evr::launch_flash_fwd<float>(static_cast<const float*>(qkv), static_cast<float*>(o), B, T, W, H, causal,
                                        scale, s);
  if (dtype == 1)
    return evr::launch_flash_fwd<evr::bf16>(static_cast<const evr::bf16*>(qkv), static_cast<evr::bf16*>(o), B, T,
                                            W, H, causal, scale, s);
  return -1;
}

// K9: a whole pre-LN residual block in one call,
//     xc  = x + out_proj(MHA(LN1(x))),  rounded to the element type,
//     out = xc + proj(act(fc(LN2(xc)))),
//     x [B, T, W] bf16 or fp32, head dim 64 or 80, any T, quickGELU or exact
//     GELU, causal or not; forward only.
//
// Replaces: evr_tpu/ops/block_fused.py::fused_block_merged (Pallas kernel
// body _merged_block_kernel). The TPU kernel runs K1's math and then K2's in
// one dispatch and keeps the mid-block residual xc in VMEM, but casts it to
// the model dtype there so that it is bit-identical to K1 followed by K2.
// Here the same steps run from one C call on one stream, on the device code
// K1 and K2 use (common.cuh's LayerNorm row pass, gemm_sm90.cuh's GEMM in
// bf16 or common.cuh's in fp32, flash.cuh's attention), so the result is
// bit-equal to the pair on the card:
//   (1) the LN1 row pass, y = round(LN1(x) * s + b);
//   (2) the GEMM qkv = round(y @ W_qkv + b);
//   (3) the attention core (flash.cuh; attn_sm90.cuh's wgmma kernel in
//       bf16), o = the rounded head outputs;
//   (4) the GEMM with K1's residual, xc = round(x + o @ W_out + b) (fp32
//       sum, rounded once), written in the model dtype;
//   (5) the LN2 row pass into the same y scratch, y = round(LN2(xc) * s + b);
//   (6) the GEMM with the activation epilogue, h = round(act(y @ W_fc + b));
//   (7) the GEMM with K2's residual, out = xc + round(h @ W_proj + b) (the
//       sum of two element-type values, rounded).
// The TPU kernel packs G in {8, 4, 2} sequences into one tile when T < 128,
// masking the others with -1e30; that is a tile-fill device of its MXU, and
// the attention here leaves the masked keys out, so nothing is packed.
//
// Bound on an H100 SXM (bf16, dense 989 TFLOP/s, 3.35 TB/s): K1's plus K2's
// operations, 24 T W^2 + 4 T^2 W per sequence; ViT-B/32 vision, B=256 T=50
// W=768 H=12: 183 GFLOP = 0.185 ms against 54 MB of x, out and weights.
// Bound by operations.
//
// Design: seven launches, K1's four and K2's three; xc makes one
// device-memory round trip in the model dtype (as do y, qkv, o and h, exactly
// as in K1 and K2): that round trip is the rounding the TPU kernel emulates.
// What bounds it on this card is what bounds K1 and K2: the GEMMs and K1's
// attention core, all three on wgmma + TMA kernels in bf16. A single whole-block kernel
// that keeps xc and h on chip is later speed work.

#include "flash.cuh"
#include "gemm_sm90.cuh"

namespace evr {

template <typename T>
int block_merged(const T* x, const float* ln1_s, const float* ln1_b, const T* qkv_k, const T* qkv_b, const T* out_k,
                 const T* out_b, const float* ln2_s, const float* ln2_b, const T* fc_k, const T* fc_b,
                 const T* pr_k, const T* pr_b, T* y, T* qkv, T* o, T* xc, T* h, T* out, int B, int T_, int W, int H,
                 int HID, int act, int causal, float scale, cudaStream_t stream) {
  if (B < 1 || T_ < 1 || H < 1 || W % H != 0 || !flash_head_dim(W / H)) return -1;
  const int M = B * T_;
  if (!block_gemm_takes<T>(M, 3 * W, W) || !block_gemm_takes<T>(M, W, W) || !block_gemm_takes<T>(M, HID, W) ||
      !block_gemm_takes<T>(M, W, HID))
    return -1;
  if (act != 0 && act != 1) return -1;
  int rc = launch_layer_norm<T>(x, ln1_s, ln1_b, y, M, W, false, stream);
  if (rc != 0) return rc;
  rc = block_gemm<kRound>(y, qkv_k, qkv_b, nullptr, qkv, M, 3 * W, W, stream);
  if (rc != 0) return rc;
  rc = launch_flash_fwd<T>(qkv, o, B, T_, W, H, causal, scale, stream);
  if (rc != 0) return rc;
  rc = block_gemm<kResidualOnce>(o, out_k, out_b, x, xc, M, W, W, stream);
  if (rc != 0) return rc;
  rc = launch_layer_norm<T>(xc, ln2_s, ln2_b, y, M, W, false, stream);
  if (rc != 0) return rc;
  if (act == 0)
    rc = block_gemm<kQuickGelu>(y, fc_k, fc_b, nullptr, h, M, HID, W, stream);
  else
    rc = block_gemm<kGelu>(y, fc_k, fc_b, nullptr, h, M, HID, W, stream);
  if (rc != 0) return rc;
  return block_gemm<kResidualTwice>(h, pr_k, pr_b, xc, out, M, W, HID, stream);
}

template <typename T>
int block_merged_c(const void* const* p, void* const* scratch, void* out, int B, int T_, int W, int H, int HID,
                   int act, int causal, float scale, cudaStream_t stream) {
  auto c = [p](int i) { return static_cast<const T*>(p[i]); };
  auto f = [p](int i) { return static_cast<const float*>(p[i]); };
  auto m = [scratch](int i) { return static_cast<T*>(scratch[i]); };
  return block_merged<T>(c(0), f(1), f(2), c(3), c(4), c(5), c(6), f(7), f(8), c(9), c(10), c(11), c(12), m(0),
                         m(1), m(2), m(3), m(4), static_cast<T*>(out), B, T_, W, H, HID, act, causal, scale, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; act 0 =
// quickGELU, 1 = exact GELU. x [B*T, W] and the twelve parameters in block
// order (ln_1 scale and bias, qkv kernel [W, 3W] and bias, out kernel [W, W]
// and bias, ln_2 scale and bias, fc kernel [W, HID] and bias, proj kernel
// [HID, W] and bias), the LN parameters fp32 (the values of their
// element-type casts), the rest in the element type; scratch y, o and xc
// [B*T, W], qkv [B*T, 3W], h [B*T, HID]; out [B*T, W]. Returns 0, -1 for a
// shape the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_block_merged(int dtype, const void* x, const void* ln1_s, const void* ln1_b,
                                      const void* qkv_k, const void* qkv_b, const void* out_k,
                                      const void* out_b, const void* ln2_s, const void* ln2_b,
                                      const void* fc_k, const void* fc_b, const void* pr_k, const void* pr_b,
                                      void* y, void* qkv, void* o, void* xc, void* h, void* out, int B, int T,
                                      int W, int H, int HID, int act, int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const void* p[13] = {x, ln1_s, ln1_b, qkv_k, qkv_b, out_k, out_b, ln2_s, ln2_b, fc_k, fc_b, pr_k, pr_b};
  void* scratch[5] = {y, qkv, o, xc, h};
  if (dtype == 0) return evr::block_merged_c<float>(p, scratch, out, B, T, W, H, HID, act, causal, scale, s);
  if (dtype == 1) return evr::block_merged_c<evr::bf16>(p, scratch, out, B, T, W, H, HID, act, causal, scale, s);
  return -1;
}

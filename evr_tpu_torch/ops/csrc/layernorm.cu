// K8: row LayerNorm with an optional quickGELU tail,
//     y = LN(x) * scale + bias (then y * sigmoid(1.702 y)), over the last
//     axis of x [rows, D], bf16 or fp32, any D and any number of rows.
//
// Replaces: evr_tpu/ops/layernorm.py::fused_layer_norm (Pallas kernel body
// _ln_kernel). Rounding points reproduced from it: x taken to fp32; the mean,
// then the mean of the squared deviations (two passes, not Welford);
// rsqrt(var + 1e-5); scale and bias in fp32 (the wrapper passes them as
// fp32); the quickGELU tail in fp32; one cast to x's dtype at the end. The
// TPU kernel's 256-row blocks and the padding of the ragged last block are a
// VMEM tiling choice: here each row is independent and the grid covers the
// rows exactly.
//
// Bound on an H100 SXM (3.35 TB/s; fp32 outside the tensor cores 67
// TFLOP/s): x read once and y written once, about 8 fp32 operations an
// element (13 with the tail). ViT-H-14's vision rows, 65,792 x 1280 bf16:
// 336.8 MB = 0.101 ms against 0.67 GFLOP = 0.010 ms. Bound by bytes.
//
// Design (right and simple first): layer_norm_kernel of common.cuh, one warp
// per row, eight rows a block of 256 threads; the block halves K1, K2 and K9
// launch the same function as their LayerNorm row pass. The warp takes the
// row's statistics with row_stats (two passes over the row, fp32 sums by warp
// shuffles), then a third pass normalises, scales, applies the tail and
// stores. Lane l reads columns l, l + 32, ..., so loads are coalesced for
// any D. The second and third passes re-read the row from L1/L2 rather than
// device memory; keeping the row in registers or shared memory, and 16-byte
// vector loads, are left for later.

#include "common.cuh"

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; x and y
// contiguous [rows, D] in that dtype, scale and bias [D] fp32; tail 1 adds
// the quickGELU tail. Returns 0, -1 for a shape the kernel does not take, or
// a CUDA error code.
extern "C" int evr_fused_layer_norm(int dtype, const void* x, const void* scale, const void* bias, void* y,
                                    int rows, int D, int tail, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  if (rows < 1 || D < 1) return -1;
  if (dtype == 0)
    return evr::launch_layer_norm(static_cast<const float*>(x), f32(scale), f32(bias), static_cast<float*>(y),
                                  rows, D, tail != 0, s);
  if (dtype == 1)
    return evr::launch_layer_norm(static_cast<const evr::bf16*>(x), f32(scale), f32(bias),
                                  static_cast<evr::bf16*>(y), rows, D, tail != 0, s);
  return -1;
}

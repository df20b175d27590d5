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
// Design (right and simple first): one warp per row, eight rows a block of
// 256 threads. The warp takes the row's statistics with row_stats of
// common.cuh (the shared LN prologue of the block kernels: two passes over
// the row, fp32 sums by warp shuffles), then a third pass normalises, scales,
// applies the tail and stores. Lane l reads columns l, l + 32, ..., so loads
// are coalesced for any D. The second and third passes re-read the row from
// L1/L2 rather than device memory; keeping the row in registers or shared
// memory, and 16-byte vector loads, are left for later.

#include "common.cuh"

namespace evr {

template <typename T, bool TAIL>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(const T* __restrict__ x,
                                                              const float* __restrict__ scale,
                                                              const float* __restrict__ bias,
                                                              T* __restrict__ y, int rows, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= rows) return;  // whole warps leave; the kernel has no barrier
  const T* xr = x + static_cast<size_t>(row) * D;
  T* yr = y + static_cast<size_t>(row) * D;
  float mean, rstd;
  row_stats(xr, D, mean, rstd);
  for (int k = lane; k < D; k += 32) {
    float v = (to_f(xr[k]) - mean) * rstd;
    v = v * scale[k] + bias[k];
    if constexpr (TAIL) v = quick_gelu(v);
    yr[k] = from_f<T>(v);
  }
}

template <typename T>
int layer_norm(const void* x, const float* scale, const float* bias, void* y, int rows, int D, int tail,
               cudaStream_t stream) {
  constexpr int rows_per_block = kThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  auto xt = static_cast<const T*>(x);
  auto yt = static_cast<T*>(y);
  if (tail)
    layer_norm_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xt, scale, bias, yt, rows, D);
  else
    layer_norm_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xt, scale, bias, yt, rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; x and y
// contiguous [rows, D] in that dtype, scale and bias [D] fp32; tail 1 adds
// the quickGELU tail. Returns 0, -1 for a shape the kernel does not take, or
// a CUDA error code.
extern "C" int evr_fused_layer_norm(int dtype, const void* x, const void* scale, const void* bias, void* y,
                                    int rows, int D, int tail, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  if (rows < 1 || D < 1) return -1;
  if (dtype == 0) return evr::layer_norm<float>(x, f32(scale), f32(bias), y, rows, D, tail, s);
  if (dtype == 1) return evr::layer_norm<evr::bf16>(x, f32(scale), f32(bias), y, rows, D, tail, s);
  return -1;
}

// K3: the two halves of a pre-LN residual block over int8 weights,
//     K3a  out = x + out_proj(MHA(LN1(x))),   x [B, T, W] bf16 or fp32,
//     K3b  out = x + proj(act(fc(LN2(x)))),   rows x W,
// every linear int8 x int8 -> int32 with per-token activation scales and
// per-output-channel weight scales.
//
// Replaces: evr_tpu/ops/block_fused.py::fused_quant_block_apply (Pallas
// kernel bodies _attn_block_kernel_q and _mlp_block_kernel_q). Rounding
// points reproduced from them, which are not K1's and K2's:
// - the LN output stays fp32 and is quantised as it is (no rounding to the
//   element type first);
// - per-token symmetric absmax quantisation: scale = max(absmax / 127,
//   1e-12) with IEEE division, q = round-half-even(y / scale), no clipping;
// - dequantisation (acc * x_scale) * kernel_scale + bias in fp32, each step
//   rounded on its own (__fmul_rn/__fadd_rn, no contraction into FMAs);
// - qkv rounded to the element type; q scaled in it; the row max over the
//   whole row, P rounded for P.v; the head output divided after P.v and
//   rounded (K1's attention, flash.cuh); the rounded head outputs quantised
//   per token across ALL heads for the out-proj;
// - in the MLP half the hidden activation stays fp32 and is quantised per
//   token over all 4W columns;
// - one residual rounding in both halves: (x32 + proj) rounded once.
// LN scale and bias arrive in the element type, kernel scales and biases in
// fp32, as the reference wrapper casts them.
//
// Bound on an H100 SXM at the main-path vision shape (B=256 T=50 W=768 H=12;
// int8 dense 1,979 TOPS, bf16 989 TFLOP/s, 3.35 TB/s): K3a does 60.4 G int8
// operations (QKV 45.3, out-proj 15.1) = 31 us plus 2.0 GFLOP of attention
// = 2 us, against 42 MB of x, out and weights = 13 us: bound by operations.
// K3b does 120.8 G int8 operations = 61 us against 44 MB = 13 us.
//
// Design: a chain of launches per half. The int8 GEMM reads each kernel
// K-major, [out, in] (wgmma takes 8-bit operands K-major only); the params
// keep their [in, out] layout, and the wrapper (ops/block_fused.py::
// k_major) makes each copy once with transpose_s8_kernel (evr_transpose_s8)
// and keeps it beside the weight, because made per call the copies took
// 5.25 % of K3a and 2.35 % of K3b at ViT-B/32's serving shape (chip_smoke.py,
// H100 80GB HBM3, 700 W). (1) quant_rows_kernel, one warp per row: LN statistics in
// fp32 (two passes), the fp32 LN row, its absmax and its int8 row plus
// scale. (2) the int8 GEMM of gemm_s8_sm90.cuh: warp-specialised, a
// producer warp issuing TMA loads into a 4-stage ring, two consumer
// warpgroups on wgmma m64n256k32 .s32.s8.s8 (m64n64k32 where N is not a
// multiple of 256), the dequantisation and the half's epilogue fused from
// the accumulator registers. K3a then runs (3) K1's attention core
// (flash.cuh's launch_flash_fwd: in bf16 the TMA + wgmma kernel of
// attn_sm90.cuh, in fp32 flash_fwd_kernel; two passes over the key blocks,
// any T) on the rounded qkv rows; (4) quant_rows_kernel on the head
// outputs; (5) the GEMM with the residual epilogue. K3b runs (1), (2) with
// the activation epilogue writing fp32 h, quant_rows_kernel on h, and (2)
// with the residual epilogue; the fc epilogue also takes each row's max |h|
// (into h_scale), so that quant_rows_kernel reads h once. Both element types
// take the same int8 GEMM; only its epilogue's output type differs. The per-token quantisation of
// the out-proj and of proj needs a whole row (W, 4W columns) before any of
// its products, which is why qkv, o and h make a round trip through device
// memory here; h goes as fp32 and int8, never as bf16. The TPU kernel's
// sequence packing is a tile-fill device of its MXU and is not carried
// over.

#include <cstdint>
#include <type_traits>

#include "flash.cuh"
#include "gemm_s8_sm90.cuh"

namespace evr {

// -- per-token quantisation ---------------------------------------------------

// One warp per row of n values: y = LN(x) (LN) or the row as it is, then
// the row's absmax scale and its int8 values. With AMAX the row's max |y|
// arrives in scale_out[row] (the fc GEMM's epilogue took it), so the row is
// read once; the scale is written over it.
template <typename TI, bool LN, bool AMAX = false>
__global__ void __launch_bounds__(kThreads) quant_rows_kernel(
    const TI* __restrict__ in, const TI* __restrict__ ln_s, const TI* __restrict__ ln_b,
    int8_t* __restrict__ q, float* __restrict__ scale_out, int M, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= M) return;  // whole warps leave; the kernel has no barrier
  const TI* xr = in + static_cast<size_t>(row) * n;
  float mean = 0.f, rstd = 0.f;
  if constexpr (LN) row_stats(xr, n, mean, rstd);
  auto y = [&](int k) {
    float v = to_f(xr[k]);
    if constexpr (LN)
      v = __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(v, -mean), rstd), to_f(ln_s[k])), to_f(ln_b[k]));
    return v;
  };
  float amax = 0.f;
  if constexpr (AMAX) {
    amax = scale_out[row];
  } else {
    for (int k = lane; k < n; k += 32) amax = fmaxf(amax, fabsf(y(k)));
    amax = warp_max(amax);
  }
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  int8_t* qr = q + static_cast<size_t>(row) * n;
  auto qz = [s](float v) { return static_cast<signed char>(__float2int_rn(__fdiv_rn(v, s))); };
  if constexpr (!LN && std::is_same<TI, float>::value) {
    // an fp32 row (K3b's h): 16-byte loads of four values, 4-byte stores of their int8s
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      char4* q4 = reinterpret_cast<char4*>(qr);
      for (int k = lane; k < n / 4; k += 32) {
        const float4 v = x4[k];
        q4[k] = make_char4(qz(v.x), qz(v.y), qz(v.z), qz(v.w));
      }
      if (lane == 0) scale_out[row] = s;
      return;
    }
  }
  for (int k = lane; k < n; k += 32) qr[k] = qz(y(k));
  if (lane == 0) scale_out[row] = s;
}

template <typename TI, bool LN, bool AMAX = false>
int launch_quant_rows(const TI* in, const TI* ln_s, const TI* ln_b, int8_t* q, float* scale, int M,
                      int n, cudaStream_t stream) {
  constexpr int rows_per_block = kThreads / 32;
  quant_rows_kernel<TI, LN, AMAX><<<(M + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
      in, ln_s, ln_b, q, scale, M, n);
  return static_cast<int>(cudaGetLastError());
}

// -- the K-major copy of an int8 kernel ----------------------------------------

// w_t[N, K] = w[K, N]^T, int8, through 64 x 64 tiles in shared memory; K and
// N multiples of 16, so every 16-byte vector lies wholly inside or outside
// the matrix
__global__ void __launch_bounds__(256) transpose_s8_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ w_t,
                                                           int K, int N) {
  __shared__ __align__(16) int8_t tile[64][80];
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  if (k0 + r < K && n0 + c < N)
    *reinterpret_cast<uint4*>(&tile[r][c]) = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + r) * N + n0 + c);
  __syncthreads();
  if (n0 + r < N && k0 + c < K) {
    __align__(16) int8_t v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = tile[c + i][r];
    *reinterpret_cast<uint4*>(w_t + static_cast<size_t>(n0 + r) * K + k0 + c) = *reinterpret_cast<const uint4*>(v);
  }
}

inline int launch_transpose_s8(const int8_t* w, int8_t* w_t, int K, int N, cudaStream_t stream) {
  if (K % 16 != 0 || N % 16 != 0 || !aligned16(w) || !aligned16(w_t)) return -1;
  transpose_s8_kernel<<<dim3((N + 63) / 64, (K + 63) / 64), 256, 0, stream>>>(w, w_t, K, N);
  return static_cast<int>(cudaGetLastError());
}

// -- the two halves -------------------------------------------------------------

#define EVR_TRY(call)         \
  do {                        \
    const int rc_ = (call);   \
    if (rc_ != 0) return rc_; \
  } while (0)

template <typename T>
int attn_block_q(const T* x, const T* ln_s, const T* ln_b, const int8_t* qkv_kt, const float* qkv_ks,
                 const float* qkv_b, const int8_t* out_kt, const float* out_ks, const float* out_b, int8_t* a_q,
                 float* a_scale, T* qkv, T* o, T* out, int B, int T_, int W, int H, int causal, float scale,
                 cudaStream_t stream) {
  if (B < 1 || T_ < 1 || H < 1 || W % H != 0 || !flash_head_dim(W / H)) return -1;
  const int M = B * T_;
  if (!gemm_s8_takes(M, 3 * W, W) || !gemm_s8_takes(M, W, W)) return -1;
  EVR_TRY((launch_quant_rows<T, true>(x, ln_s, ln_b, a_q, a_scale, M, W, stream)));
  EVR_TRY((launch_gemm_s8<kQStore, T>(a_q, qkv_kt, QOut<T>{a_scale, qkv_ks, qkv_b, nullptr, qkv, nullptr}, M,
                                       3 * W, W, stream)));
  EVR_TRY((launch_flash_fwd<T>(qkv, o, B, T_, W, H, causal, scale, stream)));
  EVR_TRY((launch_quant_rows<T, false>(o, nullptr, nullptr, a_q, a_scale, M, W, stream)));
  return launch_gemm_s8<kQResidual, T>(a_q, out_kt, QOut<T>{a_scale, out_ks, out_b, x, out, nullptr}, M, W, W,
                                       stream);
}

template <typename T>
int mlp_block_q(const T* x, const T* ln_s, const T* ln_b, const int8_t* fc_kt, const float* fc_ks,
                const float* fc_b, const int8_t* pr_kt, const float* pr_ks, const float* pr_b, int8_t* y_q,
                float* y_scale, float* h, int8_t* h_q, float* h_scale, T* out, int M, int W, int HID, int act,
                cudaStream_t stream) {
  if (!gemm_s8_takes(M, HID, W) || !gemm_s8_takes(M, W, HID) || (act != 0 && act != 1)) return -1;
  EVR_TRY((launch_quant_rows<T, true>(x, ln_s, ln_b, y_q, y_scale, M, W, stream)));
  // h_scale first collects each row's max |h| from the fc epilogue
  EVR_TRY(static_cast<int>(cudaMemsetAsync(h_scale, 0, sizeof(float) * M, stream)));
  const QOut<T> fc{y_scale, fc_ks, fc_b, nullptr, h, h_scale};
  if (act == 0)
    EVR_TRY((launch_gemm_s8<kQQuickGelu, T>(y_q, fc_kt, fc, M, HID, W, stream)));
  else
    EVR_TRY((launch_gemm_s8<kQGelu, T>(y_q, fc_kt, fc, M, HID, W, stream)));
  EVR_TRY((launch_quant_rows<float, false, true>(h, nullptr, nullptr, h_q, h_scale, M, HID, stream)));
  return launch_gemm_s8<kQResidual, T>(h_q, pr_kt, QOut<T>{h_scale, pr_ks, pr_b, x, out, nullptr}, M, W, HID,
                                       stream);
}

}  // namespace evr

// Plain C entry points for ctypes. dtype 0 = float32, 1 = bfloat16; act 0 =
// quickGELU, 1 = exact GELU. Each int8 kernel arrives as its K-major copy
// [out, in] (evr_transpose_s8 of the params' [in, out] array), with its fp32
// per-output scales and bias. Return 0, -1 for a shape the kernels do not
// take (head dim other than 16, 64 or 80; W or the hidden width not a
// multiple of 64), or a CUDA error code.
extern "C" int evr_fused_attn_block_q(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                      const void* qkv_kt, const void* qkv_ks, const void* qkv_b,
                                      const void* out_kt, const void* out_ks, const void* out_b, void* a_q,
                                      void* a_scale, void* qkv, void* o, void* out, int B, int T, int W, int H,
                                      int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return evr::attn_block_q<float>(
        f32(x), f32(ln_s), f32(ln_b), i8(qkv_kt), f32(qkv_ks), f32(qkv_b), i8(out_kt), f32(out_ks),
        f32(out_b), static_cast<int8_t*>(a_q), static_cast<float*>(a_scale), static_cast<float*>(qkv),
        static_cast<float*>(o), static_cast<float*>(out), B, T, W, H, causal, scale, s);
  if (dtype == 1) {
    using evr::bf16;
    return evr::attn_block_q<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
        i8(qkv_kt), f32(qkv_ks), f32(qkv_b), i8(out_kt), f32(out_ks), f32(out_b), static_cast<int8_t*>(a_q),
        static_cast<float*>(a_scale), static_cast<bf16*>(qkv), static_cast<bf16*>(o), static_cast<bf16*>(out), B,
        T, W, H, causal, scale, s);
  }
  return -1;
}

extern "C" int evr_fused_mlp_block_q(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                     const void* fc_kt, const void* fc_ks, const void* fc_b,
                                     const void* pr_kt, const void* pr_ks, const void* pr_b, void* y_q,
                                     void* y_scale, void* h, void* h_q, void* h_scale, void* out, int M, int W,
                                     int HID, int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return evr::mlp_block_q<float>(
        f32(x), f32(ln_s), f32(ln_b), i8(fc_kt), f32(fc_ks), f32(fc_b), i8(pr_kt), f32(pr_ks), f32(pr_b),
        static_cast<int8_t*>(y_q), static_cast<float*>(y_scale), static_cast<float*>(h), static_cast<int8_t*>(h_q),
        static_cast<float*>(h_scale), static_cast<float*>(out), M, W, HID, act, s);
  if (dtype == 1) {
    using evr::bf16;
    return evr::mlp_block_q<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
        i8(fc_kt), f32(fc_ks), f32(fc_b), i8(pr_kt), f32(pr_ks), f32(pr_b), static_cast<int8_t*>(y_q),
        static_cast<float*>(y_scale), static_cast<float*>(h), static_cast<int8_t*>(h_q),
        static_cast<float*>(h_scale), static_cast<bf16*>(out), M, W, HID, act, s);
  }
  return -1;
}

// The int8 GEMM alone, out = epilogue(a[M, K] @ w[K, N]) with epilogue epi
// (evr::QEpilogue: 0 round to the element type, 1 quickGELU and 2 exact GELU
// into fp32, 3 the residual res added and rounded, 4 the int32 sums), for
// checking and timing it on its own; nothing on the serving path calls it.
// dtype 0 = float32, 1 = bfloat16 is the element type of res and of the
// output of epilogues 0 and 3. w arrives as its K-major copy w_t [N, K].
// Returns 0, -1 for a shape or alignment the kernel does not take, or a CUDA
// error code.
extern "C" int evr_gemm_s8(int dtype, int epi, const void* a, const void* a_scale, const void* w_t,
                           const void* w_scale, const void* bias, const void* res, void* out, int M, int N, int K,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto t) {
    using T = decltype(t);
    const auto* a8 = static_cast<const int8_t*>(a);
    const auto* wt8 = static_cast<const int8_t*>(w_t);
    const evr::QOut<T> o{static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
                         static_cast<const float*>(bias), static_cast<const T*>(res), out, nullptr};
    switch (epi) {
      case evr::kQStore:
        return evr::launch_gemm_s8<evr::kQStore, T>(a8, wt8, o, M, N, K, s);
      case evr::kQQuickGelu:
        return evr::launch_gemm_s8<evr::kQQuickGelu, T>(a8, wt8, o, M, N, K, s);
      case evr::kQGelu:
        return evr::launch_gemm_s8<evr::kQGelu, T>(a8, wt8, o, M, N, K, s);
      case evr::kQResidual:
        return evr::launch_gemm_s8<evr::kQResidual, T>(a8, wt8, o, M, N, K, s);
      case evr::kQInt32:
        return evr::launch_gemm_s8<evr::kQInt32, T>(a8, wt8, o, M, N, K, s);
      default:
        return -1;
    }
  };
  if (dtype == 0) return run(float{});
  if (dtype == 1) return run(evr::bf16{});
  return -1;
}

// The K-major copy of an int8 kernel, w_t[N, K] = w[K, N]^T
// (transpose_s8_kernel), which the int8 GEMM reads; the wrapper
// (ops/block_fused.py::k_major) makes it once per weight. Returns 0, -1 for a
// shape or alignment it does not take (K and N multiples of 16, 16-byte
// aligned bases), or a CUDA error code.
extern "C" int evr_transpose_s8(const void* w, void* w_t, int K, int N, void* stream) {
  return evr::launch_transpose_s8(static_cast<const int8_t*>(w), static_cast<int8_t*>(w_t), K, N,
                                  static_cast<cudaStream_t>(stream));
}

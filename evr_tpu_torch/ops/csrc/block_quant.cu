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
// Design: a chain of simple launches per half, each masking its own ragged
// edge. (1) quant_rows_kernel, one warp per row: LN statistics in fp32 (two
// passes), the fp32 LN row, its absmax and its int8 row plus scale.
// (2) igemm_kernel: int8 x int8 -> int32 on the tensor cores (WMMA s8
// 16x16x16), one 64x128 output tile per block, K in 64-byte steps through
// shared memory panels, dequantisation and the half's epilogue fused.
// K3a then runs (3) K1's flash_fwd_kernel (flash.cuh: 64-row query tiles,
// two passes over the key blocks, any T) on the rounded qkv rows; (4)
// quant_rows_kernel on the head outputs; (5) igemm_kernel with the residual
// epilogue. K3b runs (1), (2) with the activation epilogue writing fp32 h,
// quant_rows_kernel on h, and (2) with the residual epilogue. The per-token quantisation of the out-proj and of
// proj needs a whole row (W, 4W columns) before any of its products, which
// is why qkv, o and h make a round trip through device memory here; h goes
// as fp32 and int8, never as bf16. The TPU kernel's sequence packing is a
// tile-fill device of its MXU and is not carried over.

#include <cstdint>
#include <type_traits>

#include "flash.cuh"

namespace evr {

// -- per-token quantisation ---------------------------------------------------

// One warp per row of n values: y = LN(x) (LN) or the row as it is, then
// the row's absmax scale and its int8 values.
template <typename TI, bool LN>
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
  for (int k = lane; k < n; k += 32) amax = fmaxf(amax, fabsf(y(k)));
  amax = warp_max(amax);
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  int8_t* qr = q + static_cast<size_t>(row) * n;
  for (int k = lane; k < n; k += 32) qr[k] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(y(k), s)));
  if (lane == 0) scale_out[row] = s;
}

template <typename TI, bool LN>
int launch_quant_rows(const TI* in, const TI* ln_s, const TI* ln_b, int8_t* q, float* scale, int M,
                      int n, cudaStream_t stream) {
  constexpr int rows_per_block = kThreads / 32;
  quant_rows_kernel<TI, LN><<<(M + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
      in, ln_s, ln_b, q, scale, M, n);
  return static_cast<int>(cudaGetLastError());
}

// -- int8 GEMM with dequantisation epilogues ---------------------------------
// out[M, N] = epilogue((a[M, K] @ w[K, N]) * a_scale[M] * w_scale[N] + bias[N])
// a, w int8 row-major. Tiles are staged as 16-byte-wide panels so that every
// WMMA fragment pointer is 32-byte aligned.
enum QEpilogue { kQStore = 0, kQQuickGelu = 1, kQGelu = 2, kQResidual = 3 };

constexpr int kQBM = 64, kQBN = 128, kQBK = 64;

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads) igemm_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ a_scale, const int8_t* __restrict__ w,
    const float* __restrict__ w_scale, const float* __restrict__ bias, const T* __restrict__ res,
    void* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda::wmma;
  using TO = std::conditional_t<EPI == kQQuickGelu || EPI == kQGelu, float, T>;
  __shared__ __align__(128) signed char sa[kQBK / 16][kQBM][16];
  __shared__ __align__(128) signed char sb[kQBN / 16][kQBK][16];
  __shared__ __align__(128) int sc[kQBM][kQBN + 4];

  const int row0 = blockIdx.y * kQBM, col0 = blockIdx.x * kQBN;
  const int tid = threadIdx.x, warp = tid >> 5, wr = warp >> 2, wc = warp & 3;
  fragment<accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += kQBK) {
    for (int i = tid; i < kQBM * kQBK / 16; i += kThreads) {
      const int r = i / (kQBK / 16), p = i % (kQBK / 16);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < M)
        v = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(row0 + r) * K + k0 + p * 16);
      *reinterpret_cast<uint4*>(&sa[p][r][0]) = v;
    }
    for (int i = tid; i < kQBK * kQBN / 16; i += kThreads) {
      const int kr = i / (kQBN / 16), cg = i % (kQBN / 16);
      *reinterpret_cast<uint4*>(&sb[cg][kr][0]) =
          *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + kr) * N + col0 + cg * 16);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kQBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        fragment<matrix_a, 16, 16, 16, signed char, row_major> fa;
        load_matrix_sync(fa, &sa[kk][wr * 32 + i * 16][0], 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          fragment<matrix_b, 16, 16, 16, signed char, row_major> fb;
          load_matrix_sync(fb, &sb[wc * 2 + j][kk * 16][0], 16);
          mma_sync(acc[i][j], fa, fb, acc[i][j]);
        }
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      store_matrix_sync(&sc[wr * 32 + i * 16][wc * 32 + j * 16], acc[i][j], kQBN + 4, mem_row_major);
  __syncthreads();

  TO* o = static_cast<TO*>(out);
  for (int i = tid; i < kQBM * kQBN; i += kThreads) {
    const int r = i / kQBN, c = i % kQBN, gr = row0 + r, gc = col0 + c;
    if (gr >= M) continue;
    float v = __fmul_rn(__fmul_rn(__int2float_rn(sc[r][c]), a_scale[gr]), w_scale[gc]);
    v = __fadd_rn(v, bias[gc]);
    const size_t at = static_cast<size_t>(gr) * N + gc;
    if constexpr (EPI == kQStore) {
      o[at] = from_f<T>(v);
    } else if constexpr (EPI == kQQuickGelu) {
      o[at] = quick_gelu(v);
    } else if constexpr (EPI == kQGelu) {
      o[at] = gelu_as(v);
    } else {
      o[at] = from_f<T>(__fadd_rn(to_f(res[at]), v));  // fp32 sum, one rounding
    }
  }
}

template <typename T, int EPI>
int launch_igemm(const int8_t* a, const float* a_scale, const int8_t* w, const float* w_scale,
                 const float* bias, const T* res, void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid(N / kQBN, (M + kQBM - 1) / kQBM);
  igemm_kernel<T, EPI><<<grid, kThreads, 0, stream>>>(a, a_scale, w, w_scale, bias, res, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// -- the two halves -------------------------------------------------------------

#define EVR_TRY(call)         \
  do {                        \
    const int rc_ = (call);   \
    if (rc_ != 0) return rc_; \
  } while (0)

template <typename T>
int attn_block_q(const T* x, const T* ln_s, const T* ln_b, const int8_t* qkv_kq, const float* qkv_ks,
                 const float* qkv_b, const int8_t* out_kq, const float* out_ks, const float* out_b,
                 int8_t* a_q, float* a_scale, T* qkv, T* o, T* out, int B, int T_, int W, int H,
                 int causal, float scale, cudaStream_t stream) {
  if (B < 1 || T_ < 1 || H < 1 || W % H != 0 || !flash_head_dim(W / H) || W % kQBN != 0 || W % kQBK != 0)
    return -1;
  const int M = B * T_;
  EVR_TRY((launch_quant_rows<T, true>(x, ln_s, ln_b, a_q, a_scale, M, W, stream)));
  EVR_TRY((launch_igemm<T, kQStore>(a_q, a_scale, qkv_kq, qkv_ks, qkv_b, nullptr, qkv, M, 3 * W, W,
                                    stream)));
  EVR_TRY((launch_flash_fwd<T>(qkv, o, B, T_, W, H, causal, scale, stream)));
  EVR_TRY((launch_quant_rows<T, false>(o, nullptr, nullptr, a_q, a_scale, M, W, stream)));
  return launch_igemm<T, kQResidual>(a_q, a_scale, out_kq, out_ks, out_b, x, out, M, W, W, stream);
}

template <typename T>
int mlp_block_q(const T* x, const T* ln_s, const T* ln_b, const int8_t* fc_kq, const float* fc_ks,
                const float* fc_b, const int8_t* pr_kq, const float* pr_ks, const float* pr_b,
                int8_t* y_q, float* y_scale, float* h, int8_t* h_q, float* h_scale, T* out, int M,
                int W, int HID, int act, cudaStream_t stream) {
  if (M < 1 || W % kQBN != 0 || W % kQBK != 0 || HID % kQBN != 0 || HID % kQBK != 0) return -1;
  EVR_TRY((launch_quant_rows<T, true>(x, ln_s, ln_b, y_q, y_scale, M, W, stream)));
  if (act == 0)
    EVR_TRY((launch_igemm<T, kQQuickGelu>(y_q, y_scale, fc_kq, fc_ks, fc_b, nullptr, h, M, HID, W,
                                          stream)));
  else if (act == 1)
    EVR_TRY((launch_igemm<T, kQGelu>(y_q, y_scale, fc_kq, fc_ks, fc_b, nullptr, h, M, HID, W, stream)));
  else
    return -1;
  EVR_TRY((launch_quant_rows<float, false>(h, nullptr, nullptr, h_q, h_scale, M, HID, stream)));
  return launch_igemm<T, kQResidual>(h_q, h_scale, pr_kq, pr_ks, pr_b, x, out, M, W, HID, stream);
}

}  // namespace evr

// Plain C entry points for ctypes. dtype 0 = float32, 1 = bfloat16; act 0 =
// quickGELU, 1 = exact GELU. Return 0, -1 for a shape the kernels do not
// take (head dim other than 64 or 80, W not a multiple of 128), or a CUDA error
// code.
extern "C" int evr_fused_attn_block_q(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                      const void* qkv_kq, const void* qkv_ks, const void* qkv_b,
                                      const void* out_kq, const void* out_ks, const void* out_b,
                                      void* a_q, void* a_scale, void* qkv, void* o, void* out, int B,
                                      int T, int W, int H, int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return evr::attn_block_q<float>(
        f32(x), f32(ln_s), f32(ln_b), i8(qkv_kq), f32(qkv_ks), f32(qkv_b), i8(out_kq), f32(out_ks),
        f32(out_b), static_cast<int8_t*>(a_q), static_cast<float*>(a_scale), static_cast<float*>(qkv),
        static_cast<float*>(o), static_cast<float*>(out), B, T, W, H, causal, scale, s);
  if (dtype == 1) {
    using evr::bf16;
    return evr::attn_block_q<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
        i8(qkv_kq), f32(qkv_ks), f32(qkv_b), i8(out_kq), f32(out_ks), f32(out_b),
        static_cast<int8_t*>(a_q), static_cast<float*>(a_scale), static_cast<bf16*>(qkv),
        static_cast<bf16*>(o), static_cast<bf16*>(out), B, T, W, H, causal, scale, s);
  }
  return -1;
}

extern "C" int evr_fused_mlp_block_q(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                     const void* fc_kq, const void* fc_ks, const void* fc_b,
                                     const void* pr_kq, const void* pr_ks, const void* pr_b, void* y_q,
                                     void* y_scale, void* h, void* h_q, void* h_scale, void* out,
                                     int M, int W, int HID, int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return evr::mlp_block_q<float>(
        f32(x), f32(ln_s), f32(ln_b), i8(fc_kq), f32(fc_ks), f32(fc_b), i8(pr_kq), f32(pr_ks),
        f32(pr_b), static_cast<int8_t*>(y_q), static_cast<float*>(y_scale), static_cast<float*>(h),
        static_cast<int8_t*>(h_q), static_cast<float*>(h_scale), static_cast<float*>(out), M, W, HID,
        act, s);
  if (dtype == 1) {
    using evr::bf16;
    return evr::mlp_block_q<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
        i8(fc_kq), f32(fc_ks), f32(fc_b), i8(pr_kq), f32(pr_ks), f32(pr_b),
        static_cast<int8_t*>(y_q), static_cast<float*>(y_scale), static_cast<float*>(h),
        static_cast<int8_t*>(h_q), static_cast<float*>(h_scale), static_cast<bf16*>(out), M, W, HID,
        act, s);
  }
  return -1;
}

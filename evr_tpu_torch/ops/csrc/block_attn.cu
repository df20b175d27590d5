// K1: the attention half of a pre-LN residual block,
//     out = x + out_proj(MHA(LN1(x))),  x [B, T, W] bf16 or fp32.
//
// Replaces: evr_tpu/ops/block_fused.py::fused_attn_block (Pallas kernel body
// _attn_block_kernel). Rounding points reproduced from it: LN statistics in
// fp32, y rounded to the element type; QKV GEMM accumulated in fp32 plus the
// bias, rounded; q times 1/sqrt(d) in the element type; scores and softmax in
// fp32 with the causal fill -1e30; P rounded for P.V, the fp32 sum divides
// after P.V and the head output is rounded; out-proj accumulated in fp32 plus
// the bias, added to x in fp32 and rounded once.
//
// Bound on an H100 SXM at the main-path shapes (bf16, dense 989 TFLOP/s,
// 3.35 TB/s): ViT-B/32 vision, B=256 T=50 W=768 H=12, does 45.3 GFLOP of QKV,
// 2.0 of scores and P.V and 15.1 of out-proj, 62.4 GFLOP = 63 us, against
// 44 MB of x, out and weights = 13 us: bound by operations. The text tower
// (B=16 T=77 W=512 H=8, causal) does 2.8 GFLOP = 2.8 us against 4.6 MB.
//
// Design: two launches. (1) attn_core_kernel, one block per (head, sequence):
// the LN statistics of the sequence, then the head's 3d QKV columns as a
// shared-memory tiled GEMM whose A operand is normalised on the fly from x,
// then the whole T x T score tile, the softmax and P.V in shared memory
// (attn_core.cuh, shared with K3a; the TPU kernel's sequence packing is a
// tile-fill device of its 128-wide MXU and is not carried over). Writes the
// head output o [B, T, W] in the element type. (2) the shared row-tiled GEMM
// for o @ out_kernel + bias + x. Every product runs on the tensor cores (bf16
// WMMA, fp32 accumulation), which is what an operation-bound half needs; the
// o round trip through device memory (2 x 19.7 MB at the vision shape) and x
// being read once per head are the costs this simple first version accepts.

#include "attn_core.cuh"

namespace evr {

constexpr int kAttnKC = 32;  // K step of the QKV GEMM

template <typename T, int TP, int D>
struct AttnLayout {
  using A = AttnTiles<T, TP, D>;
  static constexpr int N3 = 3 * D;
  static constexpr int LDA = kAttnKC + 8, LDB = N3 + 8, LDC = N3 + 4;
  static constexpr size_t stats = align128(sizeof(float) * 3 * TP);
  static constexpr size_t stage = align128(sizeof(T) * TP * LDA) + align128(sizeof(T) * kAttnKC * LDB);
  static constexpr size_t accum = align128(sizeof(float) * TP * LDC);
  // the staging tiles, the QKV accumulator and the attention tiles are live
  // one after another, so they share one region
  static constexpr size_t shared_region =
      stage > accum ? (stage > A::attn ? stage : A::attn) : (accum > A::attn ? accum : A::attn);
  static constexpr size_t bytes = stats + A::qkv + shared_region;
};

template <typename T, int TP, int D>
__global__ void __launch_bounds__(kThreads) attn_core_kernel(
    const T* __restrict__ x, const T* __restrict__ ln_s, const T* __restrict__ ln_b,
    const T* __restrict__ qkv_k, const T* __restrict__ qkv_b, T* __restrict__ o,
    int T_, int W, int causal, float scale) {
  using L = AttnLayout<T, TP, D>;
  constexpr int N3 = L::N3, KC = kAttnKC, LDQ = L::A::LDQ;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_mean = reinterpret_cast<float*>(smem);
  float* s_rstd = s_mean + TP;
  float* s_denom = s_rstd + TP;
  T* sq = reinterpret_cast<T*>(smem + L::stats);
  T* sk = sq + TP * LDQ;
  T* sv = sk + TP * LDQ;
  unsigned char* region = smem + L::stats + L::A::qkv;
  T* sa = reinterpret_cast<T*>(region);
  T* sb = reinterpret_cast<T*>(region + align128(sizeof(T) * TP * L::LDA));
  float* sc = reinterpret_cast<float*>(region);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kThreads / 32;
  const T* xb = x + static_cast<size_t>(b) * T_ * W;

  // 1. LN statistics of the sequence's rows
  for (int r = warp; r < TP; r += kWarps) {
    float mean = 0.f, rstd = 0.f;
    if (r < T_) row_stats(xb + static_cast<size_t>(r) * W, W, mean, rstd);
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
  __syncthreads();

  // 2. this head's q, k, v columns: [TP, W] @ [W, 3D]
  constexpr int NT = (TP / 16) * (N3 / 16);
  constexpr int PER = (NT + kWarps - 1) / kWarps;
  typename Tile<T>::Acc acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) Tile<T>::zero(acc[p]);
  for (int k0 = 0; k0 < W; k0 += KC) {
    for (int i = tid; i < TP * KC; i += kThreads) {
      const int r = i / KC, c = i % KC;
      float v = 0.f;
      if (r < T_) {
        v = to_f(xb[static_cast<size_t>(r) * W + k0 + c]);
        v = rnd<T>((v - s_mean[r]) * s_rstd[r] * to_f(ln_s[k0 + c]) + to_f(ln_b[k0 + c]));
      }
      sa[r * L::LDA + c] = from_f<T>(v);
    }
    for (int i = tid; i < KC * N3; i += kThreads) {
      const int r = i / N3, j = i % N3, s = j / D, c = j % D;
      sb[r * L::LDB + j] = qkv_k[static_cast<size_t>(k0 + r) * 3 * W + s * W + h * D + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16)
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int t = warp + kWarps * p;
        if (t < NT) {
          const int tr = t / (N3 / 16), tc = t % (N3 / 16);
          Tile<T>::template mma<false>(acc[p], sa + tr * 16 * L::LDA + kk, L::LDA,
                                       sb + kk * L::LDB + tc * 16, L::LDB);
        }
      }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int t = warp + kWarps * p;
    if (t < NT) {
      const int tr = t / (N3 / 16), tc = t % (N3 / 16);
      Tile<T>::store(sc + tr * 16 * L::LDC + tc * 16, L::LDC, acc[p]);
    }
  }
  __syncthreads();
  for (int i = tid; i < TP * N3; i += kThreads) {
    const int r = i / N3, j = i % N3, s = j / D, c = j % D;
    float v = 0.f;
    if (r < T_) {
      v = rnd<T>(sc[r * L::LDC + j] + to_f(qkv_b[s * W + h * D + c]));
      if (s == 0) v = v * scale;  // rounded to T by the store below
    }
    T* dst = s == 0 ? sq : (s == 1 ? sk : sv);
    dst[r * LDQ + c] = from_f<T>(v);
  }
  __syncthreads();

  // 3-6. scores, softmax, P.v, the head output
  attend_head<T, TP, D>(sq, sk, sv, region, s_denom, T_, causal,
                        o + static_cast<size_t>(b) * T_ * W + h * D, W);
}

template <typename T, int TP, int D>
int launch_attn_core(const T* x, const T* ln_s, const T* ln_b, const T* qkv_k, const T* qkv_b, T* o,
                     int B, int T_, int W, int H, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = AttnLayout<T, TP, D>::bytes;
  if (smem > 227 * 1024) return -2;
  auto kernel = attn_core_kernel<T, TP, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(x, ln_s, ln_b, qkv_k, qkv_b, o, T_, W, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attn_block(const T* x, const T* ln_s, const T* ln_b, const T* qkv_k, const T* qkv_b,
               const T* out_k, const T* out_b, T* o, T* out, int B, int T_, int W, int H, int causal,
               float scale, cudaStream_t stream) {
  if (W % H != 0 || W / H != 64 || W % kGemmBN != 0 || T_ < 1 || T_ > 128) return -1;
  int rc;
  if (T_ <= 32)
    rc = launch_attn_core<T, 32, 64>(x, ln_s, ln_b, qkv_k, qkv_b, o, B, T_, W, H, causal, scale, stream);
  else if (T_ <= 64)
    rc = launch_attn_core<T, 64, 64>(x, ln_s, ln_b, qkv_k, qkv_b, o, B, T_, W, H, causal, scale, stream);
  else if (T_ <= 80)
    rc = launch_attn_core<T, 80, 64>(x, ln_s, ln_b, qkv_k, qkv_b, o, B, T_, W, H, causal, scale, stream);
  else
    rc = launch_attn_core<T, 128, 64>(x, ln_s, ln_b, qkv_k, qkv_b, o, B, T_, W, H, causal, scale, stream);
  if (rc != 0) return rc;
  return launch_gemm<T, kPlain, kResidualOnce>(o, nullptr, nullptr, out_k, out_b, x, out, B * T_, W, W,
                                               stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16. Returns 0,
// -1 for a shape the kernel does not take, -2 when the shape needs more shared
// memory than a block has, or a CUDA error code.
extern "C" int evr_fused_attn_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                                    const void* qkv_k, const void* qkv_b, const void* out_k,
                                    const void* out_b, void* o, void* out, int B, int T, int W, int H,
                                    int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return evr::attn_block<float>(
        static_cast<const float*>(x), static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
        static_cast<const float*>(qkv_k), static_cast<const float*>(qkv_b),
        static_cast<const float*>(out_k), static_cast<const float*>(out_b), static_cast<float*>(o),
        static_cast<float*>(out), B, T, W, H, causal, scale, s);
  if (dtype == 1)
    return evr::attn_block<evr::bf16>(
        static_cast<const evr::bf16*>(x), static_cast<const evr::bf16*>(ln_s),
        static_cast<const evr::bf16*>(ln_b), static_cast<const evr::bf16*>(qkv_k),
        static_cast<const evr::bf16*>(qkv_b), static_cast<const evr::bf16*>(out_k),
        static_cast<const evr::bf16*>(out_b), static_cast<evr::bf16*>(o), static_cast<evr::bf16*>(out),
        B, T, W, H, causal, scale, s);
  return -1;
}

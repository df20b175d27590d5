// K6: multi-head attention over q, k, v [B, H, T, D] (bf16 or fp32, D = 64
//     or 80, any T, optional causal mask), o = softmax(q k^T / sqrt(D)) v in
//     the layout and dtype of q.
//
// Replaces: evr_tpu/ops/attention.py::_flash_forward_impl, both of its Pallas
// kernels: K6a, the whole-sequence route (_attention_kernel_full: no
// padding, up to 4 sequences packed into one tile when T < 128, the other
// sequences masked with -1e30), and K6b, the blocked route
// (_attention_kernel: T padded to a multiple of 128, a -1e30 bias on the
// padded key columns, the causal fill -1e30, block_q query rows per cell).
// The two compute the same function of each row and differ only in how the
// TPU tiles it, so one kernel serves both; the wrapper (ops/attention.py)
// picks and counts the route by the JAX rule. Every masked score of the TPU
// kernels gives exp(s - m) = 0 exactly in fp32, so here keys past T and past
// the diagonal are left out of the row and nothing is packed or padded in
// device memory.
//
// Rounding points reproduced from the TPU kernels: q times 1/sqrt(D) in the
// element type (the wrapper passes the scale already rounded to it, as
// jnp.asarray(1/sqrt(d), q.dtype) is); scores q.k in fp32; the row max m over
// the WHOLE row before any exponent; p = exp(s - m) in fp32; the denominator
// is the fp32 sum of the unrounded p; o = sum round(p) . v in fp32, divided
// by the denominator after the product, rounded to the element type.
//
// Bound on an H100 SXM (bf16, dense 989 TFLOP/s, 3.35 TB/s): per (sequence,
// head) 4 T^2 D operations against 4 T D elements of q, k, v and o. ViT-H-14
// vision serving, B=256 H=16 T=257 D=80: 673.7 MB = 0.201 ms against
// 86.6 GFLOP = 0.088 ms; ViT-H-14 text, B=16 H=16 T=77 D=64 causal: 10.1 MB
// = 3.0 us. Bound by bytes at CLIP's lengths.
//
// Design: bf16 runs on the warp-specialised TMA + wgmma kernel of
// attn_sm90.cuh (launch_attn_sm90_heads), the same device code as K1's
// attention core: one block per (pair of 64-row query tiles, head,
// sequence), a producer warp issuing 3-D TMA loads over the [B*H, T, D]
// arrays, two consumer warpgroups that walk the key blocks twice (the row
// max, then exp(s - m), its fp32 sum and round(p) . v) with the scores in
// registers, k resident in shared memory between the walks while T <= 768,
// and p fed to wgmma as its register A operand. The route is chosen by the
// element type alone. fp32 keeps the kernel below (full fp32 FMAs on the
// CUDA cores, the on-card parity path; wgmma has no full-fp32 input): one
// block of 256 threads per (64-row query tile, head, sequence), the scaled q
// tile in shared memory, the same two walks over key blocks of 64 through
// common.cuh's warp tile product, one warp per 8 rows for the softmax, and
// 16-byte vector loads (q, k, v contiguous and 16-byte aligned, which the
// wrapper checks).

#include "attn_sm90.cuh"
#include "common.cuh"

#include <cstdint>

namespace evr {
namespace {

constexpr int kBR = 64;  // query rows per block; keys per step of the walk

template <typename T, int D>
struct AttnLayout {
  static constexpr int LDT = D + 8;    // q, k, v tiles [64][LDT] (T)
  static constexpr int LDP = kBR + 8;  // probability tile [64][LDP] (T)
  static constexpr int LDS = kBR + 4;  // score tile [64][LDS] (fp32)
  static constexpr int LDO = D + 4;    // output tile [64][LDO] (fp32), laid over k and v at the end
  static constexpr int kOutTiles = 4 * (D / 16);     // 16 x 16 tiles of the [64, D] output
  static constexpr int kPerWarp = (kOutTiles + 7) / 8;
  static constexpr size_t tile = align128(sizeof(T) * kBR * LDT);
  static constexpr size_t ptile = align128(sizeof(T) * kBR * LDP);
  static constexpr size_t stile = align128(sizeof(float) * kBR * LDS);
  static constexpr size_t smem = 3 * tile + ptile + stile + align128(sizeof(float) * kBR);
  static_assert(D % 16 == 0, "head dim must be a multiple of the 16-deep tile product");
  static_assert(2 * tile >= sizeof(float) * kBR * LDO, "the output tile must fit over k and v");
};

// rows [r0, r0 + 64) of one sequence's [T_, D] matrix into a tile; rows past
// T_ are zero
template <typename T, int D>
__device__ void load_rows(T* dst, const T* __restrict__ src, int r0, int T_) {
  using L = AttnLayout<T, D>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRow = D / kVec;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kBR * kRow; i += kThreads) {
    const int r = i / kRow, c = (i % kRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T_) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * L::LDT + c) = val;
  }
}

// ss = sq . sk^T, a [64, 64] fp32 tile; warp w owns output tiles w and w + 8
template <typename T, int D>
__device__ void scores(float* ss, const T* sq, const T* sk) {
  using L = AttnLayout<T, D>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int t = warp + 8 * p, tr = (t >> 2) * 16, tc = (t & 3) * 16;
    typename Tile<T>::Acc acc;
    Tile<T>::zero(acc);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
      Tile<T>::template mma<true>(acc, sq + tr * L::LDT + kk, L::LDT, sk + tc * L::LDT + kk, L::LDT);
    Tile<T>::store(ss + tr * L::LDS + tc, L::LDS, acc);
  }
}

// acc += sp . sv over 64 keys; warp w owns output tiles w, w + 8, w + 16 of
// the [64, D] output (those that exist)
template <typename T, int D>
__device__ void accumulate_pv(typename Tile<T>::Acc (&acc)[AttnLayout<T, D>::kPerWarp], const T* sp,
                              const T* sv) {
  using L = AttnLayout<T, D>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < L::kPerWarp; ++p) {
    const int t = warp + 8 * p;
    if (t >= L::kOutTiles) continue;  // the same for the whole warp
    const int tr = (t / (D / 16)) * 16, tc = (t % (D / 16)) * 16;
#pragma unroll
    for (int kk = 0; kk < kBR; kk += 16)
      Tile<T>::template mma<false>(acc[p], sp + tr * L::LDP + kk, L::LDP, sv + kk * L::LDT + tc, L::LDT);
  }
}

// key j is in query row i's softmax
__device__ __forceinline__ bool visible(int i, int j, int T_, int causal) {
  return j < T_ && !(causal && j > i);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                            const T* __restrict__ v, T* __restrict__ o, int T_,
                                                            int causal, float scale) {
  static_assert(std::is_same<T, float>::value, "the bf16 forward runs on attn_sm90.cuh");
  using L = AttnLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L::tile);
  T* sv = reinterpret_cast<T*>(smem + 2 * L::tile);
  T* sp = reinterpret_cast<T*>(smem + 3 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 3 * L::tile + L::ptile);
  float* s_l = reinterpret_cast<float*>(smem + 3 * L::tile + L::ptile + L::stile);
  float* so = reinterpret_cast<float*>(sk);  // once the walk is over

  const size_t base = static_cast<size_t>(blockIdx.x) * T_ * D;  // this (sequence, head)
  const int qt = blockIdx.y, i0 = qt * kBR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (T_ + kBR - 1) / kBR;
  const int n_kb = causal ? min(qt + 1, n_tiles) : n_tiles;

  load_rows<T, D>(sq, q + base, i0, T_);
  __syncthreads();
  for (int i = threadIdx.x; i < kBR * D; i += kThreads) {
    T* e = sq + (i / D) * L::LDT + i % D;
    *e = from_f<T>(to_f(*e) * scale);
  }

  // walk 1: the max of each of the warp's 8 rows over the whole row
  float m[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) m[r] = -INFINITY;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    load_rows<T, D>(sk, k + base, kb * kBR, T_);
    __syncthreads();
    scores<T, D>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = warp * 8 + r;
      for (int jj = lane; jj < kBR; jj += 32)
        if (visible(i0 + row, kb * kBR + jj, T_, causal)) m[r] = fmaxf(m[r], ss[row * L::LDS + jj]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) m[r] = warp_max(m[r]);

  // walk 2: p = exp(s - m), its fp32 sum, and round(p) . v
  float l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) l[r] = 0.f;
  typename Tile<T>::Acc acc[L::kPerWarp];
#pragma unroll
  for (int p = 0; p < L::kPerWarp; ++p) Tile<T>::zero(acc[p]);
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    load_rows<T, D>(sk, k + base, kb * kBR, T_);
    load_rows<T, D>(sv, v + base, kb * kBR, T_);
    __syncthreads();
    scores<T, D>(ss, sq, sk);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = warp * 8 + r;
      for (int jj = lane; jj < kBR; jj += 32) {
        const float p =
            visible(i0 + row, kb * kBR + jj, T_, causal) ? expf(ss[row * L::LDS + jj] - m[r]) : 0.f;
        l[r] += p;
        sp[row * L::LDP + jj] = from_f<T>(p);
      }
    }
    __syncthreads();
    accumulate_pv<T, D>(acc, sp, sv);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float sum = warp_sum(l[r]);
    if (lane == 0) s_l[warp * 8 + r] = sum;
  }
  __syncthreads();  // every warp is done with k and v: the output tile goes over them
#pragma unroll
  for (int p = 0; p < L::kPerWarp; ++p) {
    const int t = warp + 8 * p;
    if (t >= L::kOutTiles) continue;
    const int tr = (t / (D / 16)) * 16, tc = (t % (D / 16)) * 16;
    Tile<T>::store(so + tr * L::LDO + tc, L::LDO, acc[p]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBR * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (i0 + r < T_) o[base + static_cast<size_t>(i0 + r) * D + c] = from_f<T>(so[r * L::LDO + c] / s_l[r]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int T_, int causal, float scale,
           cudaStream_t stream) {
  using L = AttnLayout<T, D>;
  auto kernel = attn_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(BH, (T_ + kBR - 1) / kBR), kThreads, L::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), T_,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; q, k, v
// and o are contiguous [BH, T, d] with BH = B * H; ``scale`` is 1/sqrt(d)
// already rounded to the element type. Returns 0, -1 for a shape the kernel
// does not take, or a CUDA error code.
extern "C" int evr_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int BH,
                                   int T, int d, int causal, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || T < 1 || (T + evr::kBR - 1) / evr::kBR > 65535) return -1;
  if (dtype == 0 && d == 64) return evr::launch<float, 64>(q, k, v, o, BH, T, causal, scale, s);
  if (dtype == 0 && d == 80) return evr::launch<float, 80>(q, k, v, o, BH, T, causal, scale, s);
  if (dtype == 1)
    return evr::launch_attn_sm90_heads(static_cast<const evr::bf16*>(q), static_cast<const evr::bf16*>(k),
                                       static_cast<const evr::bf16*>(v), static_cast<evr::bf16*>(o), BH, T, d,
                                       causal, scale, s);
  return -1;
}

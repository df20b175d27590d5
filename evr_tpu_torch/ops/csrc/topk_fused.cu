// K4: fused streaming score + top-k over a row-range of the frame index,
//     per tile of kTopkTile rows: scores [Q, rows] = (q . row) * row_scale,
//     rows outside [start, end) at -inf, and the tile's top kc by (score
//     descending, row ascending). ops/retrieval.py merges the tiles' lists.
//
// Replaces: evr_tpu/ops/retrieval_pallas.py::fused_topk (Pallas kernel body
// _topk_tile_kernel). What it reproduces: int8 and bf16 rows are scored
// against the queries rounded to bf16 and fp32 rows against fp32 queries,
// products and sums in fp32 (no TF32), the per-row dequantisation scale
// applied after the sum, the [start, end) mask, and ties to the lower row
// (the TPU kernel's first-argmax). Each score is summed over the embedding
// dimension in order, one product and one rounded sum per element
// (__fmul_rn/__fadd_rn: for bf16 and int8 rows the product is exact), so the
// plain PyTorch version in ops/retrieval.py gives the same bits.
//
// Bound on an H100 SXM: memory. At the main-path shape of the chip smoke
// run, 1,048,576 int8 rows of 512 with Q = 1, the kernel must read 512 MiB
// of rows and 4 MiB of scales: 161 us at 3.35 TB/s. Its operations (1 G
// multiply-adds on the CUDA cores) take a fraction of that.
//
// Design: one block of 256 threads per tile of 1,024 rows, 4 rows per thread,
// each row read once per pass in 16-byte vector loads and dotted with up to
// QC queries held in shared memory (QC = 1, 4 or 8, so one query costs one
// pass and no wasted products); the tile's scores stay in shared memory and
// are sorted per query by a bitonic sort of 64-bit keys (descending score,
// ascending row), and only the first kc candidates are written. More than QC
// queries take more passes over the tile, which then re-reads it (mostly
// from L2). The ragged last tile is masked: absent rows sort last and are
// emitted as (-inf, -1), which the merge never reaches since kc <= k <= N.

#include <cstdint>

#include "common.cuh"

namespace evr {

constexpr int kTopkTile = 1024;  // ops/retrieval.py TILE_ROWS
constexpr int kTopkRowsPerThread = kTopkTile / kThreads;
constexpr unsigned long long kAbsent = ~0ull;

__device__ __forceinline__ float elt_f(float v) { return v; }
__device__ __forceinline__ float elt_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float elt_f(int8_t v) { return static_cast<float>(v); }

// Ascending keys give descending scores, then ascending rows.
__device__ __forceinline__ unsigned long long sort_key(float s, int row) {
  const unsigned u = __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending with s
  return (static_cast<unsigned long long>(~ord) << 32) | static_cast<unsigned>(row);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned ord = ~static_cast<unsigned>(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

template <int QC>
constexpr size_t topk_smem(int D) {
  return sizeof(unsigned long long) * kTopkTile + sizeof(float) * QC * (kTopkTile + D);
}

template <typename T, int QC>
__global__ void __launch_bounds__(kThreads) topk_tile_kernel(
    const T* __restrict__ index, const float* __restrict__ q, const float* __restrict__ scales,
    int N, int D, int Q, int start, int end, int kc, float* __restrict__ cand_s,
    int* __restrict__ cand_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* ss = reinterpret_cast<float*>(keys + kTopkTile);  // [QC][kTopkTile]
  float* sq = ss + QC * kTopkTile;                           // [QC][D]
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int tile = blockIdx.x, n_tiles = gridDim.x, row0 = tile * kTopkTile;
  const int rows_here = min(kTopkTile, N - row0);
  const int tid = threadIdx.x;

  for (int q0 = 0; q0 < Q; q0 += QC) {
    const int nq = min(QC, Q - q0);
    for (int i = tid; i < QC * D; i += kThreads)
      sq[i] = i / D < nq ? q[static_cast<size_t>(q0) * D + i] : 0.f;
    __syncthreads();

    for (int rr = 0; rr < kTopkRowsPerThread; ++rr) {
      const int r = tid + rr * kThreads;
      if (r >= rows_here) continue;
      const int grow = row0 + r;
      const T* row = index + static_cast<size_t>(grow) * D;
      float acc[QC];
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) acc[qi] = 0.f;
      for (int d0 = 0; d0 < D; d0 += V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float v = elt_f(e[j]);
#pragma unroll
          for (int qi = 0; qi < QC; ++qi)
            acc[qi] = __fadd_rn(acc[qi], __fmul_rn(sq[qi * D + d0 + j], v));
        }
      }
      const bool valid = grow >= start && grow < end;
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) {
        float s = scales ? __fmul_rn(acc[qi], scales[grow]) : acc[qi];
        s = __fadd_rn(s, 0.f);  // -0 -> +0: the two zeros sort as equal, as in PyTorch
        ss[qi * kTopkTile + r] = valid ? s : -INFINITY;
      }
    }
    __syncthreads();

    for (int qi = 0; qi < nq; ++qi) {
      for (int i = tid; i < kTopkTile; i += kThreads)
        keys[i] = i < rows_here ? sort_key(ss[qi * kTopkTile + i], row0 + i) : kAbsent;
      __syncthreads();
      for (int k = 2; k <= kTopkTile; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = tid; i < kTopkTile; i += kThreads) {
            const int ixj = i ^ j;
            if (ixj > i) {
              const unsigned long long a = keys[i], b = keys[ixj];
              if ((a > b) == ((i & k) == 0)) {
                keys[i] = b;
                keys[ixj] = a;
              }
            }
          }
          __syncthreads();
        }
      const size_t at = (static_cast<size_t>(q0 + qi) * n_tiles + tile) * kc;
      for (int i = tid; i < kc; i += kThreads) {
        const unsigned long long key = keys[i];
        cand_s[at + i] = key == kAbsent ? -INFINITY : key_score(key);
        cand_r[at + i] = key == kAbsent ? -1 : static_cast<int>(key & 0xffffffffu);
      }
      __syncthreads();
    }
  }
}

template <typename T, int QC>
int launch_topk(const T* index, const float* q, const float* scales, int N, int D, int Q, int start,
                int end, int kc, float* cand_s, int* cand_r, cudaStream_t stream) {
  const size_t smem = topk_smem<QC>(D);
  auto kernel = topk_tile_kernel<T, QC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (N + kTopkTile - 1) / kTopkTile;
  kernel<<<n_tiles, kThreads, smem, stream>>>(index, q, scales, N, D, Q, start, end, kc, cand_s, cand_r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int topk(const void* index, const float* q, const float* scales, int N, int D, int Q, int start,
         int end, int kc, float* cand_s, int* cand_r, cudaStream_t stream) {
  const T* idx = static_cast<const T*>(index);
  if (Q == 1) return launch_topk<T, 1>(idx, q, scales, N, D, Q, start, end, kc, cand_s, cand_r, stream);
  if (Q <= 4) return launch_topk<T, 4>(idx, q, scales, N, D, Q, start, end, kc, cand_s, cand_r, stream);
  return launch_topk<T, 8>(idx, q, scales, N, D, Q, start, end, kc, cand_s, cand_r, stream);
}

}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16, 2 = int8
// rows; q [Q, D] fp32 (already normalised, and rounded to bf16 for dtypes 1
// and 2); scales [N] fp32 or null; cand_s / cand_r [Q, n_tiles, kc]. Returns
// 0, -1 for a shape the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_topk(int dtype, const void* index, const void* q, const void* scales, int N,
                              int D, int Q, int start, int end, int kc, void* cand_s, void* cand_r,
                              void* stream) {
  if (N < 1 || D < 16 || D % 16 != 0 || D > 2048 || Q < 1 || kc < 1 || kc > evr::kTopkTile) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto sc = static_cast<const float*>(scales);
  auto cs = static_cast<float*>(cand_s);
  auto cr = static_cast<int*>(cand_r);
  if (dtype == 0) return evr::topk<float>(index, qf, sc, N, D, Q, start, end, kc, cs, cr, s);
  if (dtype == 1) return evr::topk<evr::bf16>(index, qf, sc, N, D, Q, start, end, kc, cs, cr, s);
  if (dtype == 2) return evr::topk<int8_t>(index, qf, sc, N, D, Q, start, end, kc, cs, cr, s);
  return -1;
}

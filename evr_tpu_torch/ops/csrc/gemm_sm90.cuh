// The bf16 GEMM under the block halves K1, K2 and K9, written for Hopper:
//     out[M, N] = epilogue(A[M, K] @ W[K, N] + bias),
// A row-major (K-contiguous, the activations), W in the params' [in, out]
// layout (N-contiguous, never transposed per call), bf16 in and out, fp32
// accumulation, the epilogues of common.cuh at the reference's rounding
// points.
//
// Bound on an H100 SXM: at the block halves' shapes the product does 2 M N K
// operations on (M K + K N + M N) elements, e.g. ViT-H-14's fc, 65,792 x
// 5,120 x 1,280: 862 GFLOP = 0.87 ms at the dense bf16 peak (989 TFLOP/s)
// against 855 MB = 0.26 ms at 3.35 TB/s. Bound by operations, so the design
// is about keeping the tensor cores fed:
//   - a 128 x 256 output tile, K walked in 64-wide steps (each 64-element row
//     of a tile is one 128-byte swizzle line);
//   - a ring of kStages = 4 stages (48 KB each: A 128 x 64, W 64 x 256) in
//     dynamic shared memory, with a full and an empty mbarrier a stage;
//   - one producer warp (warpgroup 2, registers cut to 40 by setmaxnreg)
//     whose one thread issues the TMA loads (cp.async.bulk.tensor.2d): A as
//     one box of 128 rows x 64, W as four of 64 x 64, all with the 128-byte
//     swizzle; TMA fills rows past M with zeros, so a ragged M needs no
//     masking on load;
//   - two consumer warpgroups (registers raised to 232), each owning 64 x 256
//     of the tile as 128 fp32 accumulators a thread, through wgmma.mma_async
//     m64n256k16 with A from shared memory K-major and W MN-major (the
//     transpose bit); one wgmma group stays in flight while the next stage's
//     is issued, and a stage is released to the producer once its products
//     are done;
//   - the epilogue from the accumulator registers: bias in fp32, then the
//     epilogue, staged through the freed ring so that the residual is read
//     and the output written with 16-byte accesses; rows past M are not
//     stored.
// Grid: one block per output tile, N tiles fastest, so the blocks in flight
// share A's rows and walk W (at most 13 MB) in L2. Not done here: a
// persistent grid whose epilogue overlaps the next tile's loads, clusters
// with TMA multicast, and feeding A to wgmma from registers (which would let
// the LayerNorm row pass fold into the GEMM).
//
// Tensor maps are encoded on the host for each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda; each map is passed as a __grid_constant__ kernel
// parameter.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <cstdint>

#include "common.cuh"

namespace evr {
namespace sm90 {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                       // warpgroups of 128 threads, 64 rows each
constexpr int kGemmThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kWBox = 64;                           // W's TMA box: 64 columns (128 B) x kBK rows
constexpr uint32_t kABytes = kBM * kBK * 2;         // 16 KB
constexpr uint32_t kWBoxBytes = kWBox * kBK * 2;    // 8 KB
constexpr uint32_t kStageBytes = kABytes + (kBN / kWBox) * kWBoxBytes;  // 48 KB
constexpr int kEpiLd = kBN + 8;                     // staged output row (elements), 16-byte multiple
constexpr size_t kSmemBytes = 1024 + size_t(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t);
static_assert(kConsumers * 64 * kEpiLd * 2 <= kStages * kStageBytes, "epilogue staging fits in the ring");

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// 2-D TMA load of the box at (c0 innermost, c1) into shared memory; completion
// is counted in bytes on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// A: a 64-row slice of the K-major [128][64] tile; 8-row groups 1,024 B apart
// (SBO), the leading offset unused under the swizzle. The k16 step k moves the
// start 32 B along the 128-byte line.
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int k) { return smem_desc(tile + 32 * k, 16, 1024); }

// W: MN-major, four [64 K rows][64 N columns] boxes 8 KB apart. In the MN-major
// canonical form the leading byte offset steps between 64-column blocks along
// N (8 KB), the stride byte offset between 8-row groups along K (1,024 B).
// The k16 step k starts 16 rows (2,048 B) further down every box.
__device__ __forceinline__ uint64_t desc_w(uint32_t tile, int k) {
  return smem_desc(tile + 2048 * k, kWBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
// fence or wait
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] = A[64 x 16] . W[16 x 256] (+ d when accumulate): bf16 in, fp32
// accumulators; A K-major (transpose bit 0), W MN-major (transpose bit 1)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t dw, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(dw), "r"(static_cast<int>(accumulate)));
}

// -- the kernel -----------------------------------------------------------------

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,  // A [M, K], box 128 rows x 64
                     const __grid_constant__ CUtensorMap map_w,  // W [K, N], box 64 x 64
                     const bf16* __restrict__ bias,              // [N]
                     const bf16* __restrict__ res,               // [M, N] residual (kResidual*)
                     bf16* __restrict__ out,                     // [M, N]
                     int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 B: stage tiles start on that grid
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kStages * kStageBytes;  // kStages full, then kStages empty barriers
  auto full = [full0](int s) { return full0 + 8u * s; };
  auto empty = [full0](int s) { return full0 + 8u * (kStages + s); };
  auto tile_a = [base](int s) { return base + s * kStageBytes; };
  auto tile_w = [base](int s) { return base + s * kStageBytes + kABytes; };

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = K / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps up to kStages stages of TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kStageBytes);
        tma_load_2d(tile_a(s), &map_a, full(s), kt * kBK, m0);
#pragma unroll
        for (int j = 0; j < kBN / kWBox; ++j)
          tma_load_2d(tile_w(s) + j * kWBoxBytes, &map_w, full(s), n0 + j * kWBox, kt * kBK);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // the first product of the first stage overwrites d (scale-d 0), so the
    // accumulators need no zeroing: only wgmma defines them while a group is
    // in flight, and ptxas keeps the products pipelined
    float d[128];
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        wgmma_m64n256k16(d, desc_a(tile_a(s) + wg * 64 * 128, k), desc_w(tile_w(s), k), kt > 0 || k > 0);
      wgmma_commit();
      // one group in flight: the previous stage's products are done, so the
      // producer may refill it
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty((kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(d);
    // every stage has been read by both warpgroups before the ring is reused
    named_bar_sync(1, kConsumers * 128);

    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = m0 + wg * 64;
    bf16* stage = reinterpret_cast<bf16*>(smem) + wg * 64 * kEpiLd;
    constexpr int kVecs = kBN / 8;  // 16-byte vectors a row
    if constexpr (epilogue_reads_residual<EPI>()) {
      for (int i = t; i < 64 * kVecs; i += 128) {
        const int r = i / kVecs, c = (i % kVecs) * 8;
        if (row0 + r < M)
          *reinterpret_cast<uint4*>(stage + r * kEpiLd + c) =
              *reinterpret_cast<const uint4*>(res + static_cast<size_t>(row0 + r) * N + n0 + c);
      }
      named_bar_sync(2 + wg, 128);
    }
    // accumulator i of this thread: column 8 (i / 4) + 2 (lane % 4) + i % 2,
    // row 16 warp + lane / 4 + 8 ((i / 2) % 2) of the warpgroup's 64 rows
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n0 + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(stage + (16 * warp + lane / 4 + 8 * h) * kEpiLd + col);
        float2 r = make_float2(0.f, 0.f);
        if constexpr (epilogue_reads_residual<EPI>()) r = __bfloat1622float2(*p);
        __nv_bfloat162 o;
        o.x = apply_epilogue<bf16, EPI>(d[4 * j + 2 * h] + b.x, r.x);
        o.y = apply_epilogue<bf16, EPI>(d[4 * j + 2 * h + 1] + b.y, r.y);
        *p = o;
      }
    }
    named_bar_sync(2 + wg, 128);
    for (int i = t; i < 64 * kVecs; i += 128) {
      const int r = i / kVecs, c = (i % kVecs) * 8;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * N + n0 + c) =
            *reinterpret_cast<const uint4*>(stage + r * kEpiLd + c);
    }
  }
}

// -- host side --------------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled as the CUDA runtime resolves it; null if it cannot
// be found
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// a row-major bf16 [rows, cols] matrix read in boxes of box_rows x box_cols,
// 128-byte swizzle, zeros past its edges
inline bool encode_map(EncodeTiled encode, CUtensorMap* map, const bf16* ptr, int rows, int cols, int box_rows,
                       int box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90

// The shapes the wgmma GEMM takes (ops/block_fused.py::gemm_takes mirrors
// this): N a multiple of the 256-wide tile, K of the 64-wide step, M any
// positive row count up to the grid's 65,535 row tiles.
inline bool gemm_takes(int M, int N, int K) {
  return M >= 1 && N >= sm90::kBN && K >= sm90::kBK && N % sm90::kBN == 0 && K % sm90::kBK == 0 &&
         (M + sm90::kBM - 1) / sm90::kBM <= 65535;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launch gemm_sm90_kernel; returns -1 for a shape or alignment it does not
// take (TMA and the 16-byte epilogue need 16-byte aligned bases), else a
// CUDA error code (cudaErrorNotSupported when cuTensorMapEncodeTiled cannot
// be resolved, cudaErrorInvalidValue when a map cannot be encoded).
template <int EPI>
int launch_gemm_sm90(const bf16* a, const bf16* w, const bf16* bias, const bf16* res, bf16* out, int M, int N,
                     int K, cudaStream_t stream) {
  if (!gemm_takes(M, N, K)) return -1;
  if (!aligned16(a) || !aligned16(w) || !aligned16(out) || reinterpret_cast<uintptr_t>(bias) % 4 != 0) return -1;
  if (epilogue_reads_residual<EPI>() && !aligned16(res)) return -1;
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_w;
  if (!sm90::encode_map(encode, &map_a, a, M, K, sm90::kBM, sm90::kBK) ||
      !sm90::encode_map(encode, &map_w, w, K, N, sm90::kBK, sm90::kWBox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sm90::gemm_sm90_kernel<EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sm90::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / sm90::kBN, (M + sm90::kBM - 1) / sm90::kBM);
  kernel<<<grid, sm90::kGemmThreads, sm90::kSmemBytes, stream>>>(map_a, map_w, bias, res, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The block halves' GEMM: bf16 on the wgmma kernel above, fp32 on the
// CUDA-core gemm_kernel of common.cuh (full fp32, the on-card parity path).
template <typename T>
bool block_gemm_takes(int M, int N, int K) {
  if constexpr (std::is_same<T, bf16>::value)
    return gemm_takes(M, N, K);
  else
    return gemm_f32_takes(M, N, K);
}

template <int EPI>
int block_gemm(const bf16* a, const bf16* w, const bf16* bias, const bf16* res, bf16* out, int M, int N, int K,
               cudaStream_t stream) {
  return launch_gemm_sm90<EPI>(a, w, bias, res, out, M, N, K, stream);
}

template <int EPI>
int block_gemm(const float* a, const float* w, const float* bias, const float* res, float* out, int M, int N,
               int K, cudaStream_t stream) {
  return launch_gemm<EPI>(a, w, bias, res, out, M, N, K, stream);
}

}  // namespace evr

// Hopper building blocks shared by the warp-specialised kernels, the bf16
// GEMM (gemm_sm90.cuh), the int8 GEMM (gemm_s8_sm90.cuh), the bf16 attention
// forward (attn_sm90.cuh) and backward (attn_bwd_sm90.cuh), the index scan
// (topk_fused.cu) and the PQ lookup scorer (adc_list.cu):
// PTX wrappers for mbarriers, TMA and bulk loads, named barriers and wgmma, the
// wgmma shared-memory matrix descriptors of the layouts those kernels read,
// and the host-side encoding of TMA tensor maps.
//
// Tensor maps are encoded on the host for each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so no
// library needs -lcuda; each map is passed as a __grid_constant__ kernel
// parameter.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <cstdint>

#include "common.cuh"

namespace evr {
namespace sm90 {

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

// 3-D TMA load of the box at (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, counted in bytes on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma operands)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, all in 16-byte units, and the swizzle (1: 128 bytes, 3: 32
// bytes)
constexpr uint64_t kSwizzle128 = 1, kSwizzle32 = 3;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle = kSwizzle128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (swizzle << 62);
}

// An MN-major TMA box under the 128-byte swizzle: 64 K rows x 64 MN columns
constexpr uint32_t kBoxBytes = 64 * 64 * 2;  // 8 KB

// K-major operand tile, 128-byte swizzle: rows of 64 K elements (one
// 128-byte swizzle line each), 8-row groups 1,024 B apart (SBO), the leading
// offset unused under the swizzle. The k16 step k moves the start 32 B along
// the line. 64 rows of such a tile are 8 KB.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int k) { return smem_desc(tile + 32 * k, 16, 1024); }

// MN-major operand tile, 128-byte swizzle: [64 K rows][64 MN columns] boxes
// 8 KB apart. In the MN-major canonical form the leading byte offset steps
// between 64-column blocks along M or N (8 KB), the stride byte offset
// between 8-row groups along K (1,024 B). The k16 step k starts 16 rows
// (2,048 B) further down every box.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int k) {
  return smem_desc(tile + 2048 * k, kBoxBytes, 1024);
}

// K-major operand tile, 32-byte swizzle: rows of 16 K elements (32 B, one
// k16 step), 8-row groups 256 B apart (SBO)
__device__ __forceinline__ uint64_t desc_kmajor32(uint32_t tile) { return smem_desc(tile, 16, 256, kSwizzle32); }

// MN-major operand tile, 32-byte swizzle: [K rows][16 MN columns], rows of 32
// B, 8-row groups along K 256 B apart (SBO); one 16-column block, so the
// leading offset (between such blocks) is unused. The k16 step k starts 16
// rows (512 B) further down.
__device__ __forceinline__ uint64_t desc_mnmajor32(uint32_t tile, int k) {
  return smem_desc(tile + 512 * k, 2048, 256, kSwizzle32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
// fence or wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// -- wgmma at the attention kernels' tile edge (attn_sm90.cuh, attn_bwd_sm90.cuh) --

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers (four bf16
// pairs a thread), B MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(static_cast<int>(accumulate)));
}

// d[64 x 16] (+)= A[64 x 16] . B[16 x 16], A from registers, B MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(static_cast<int>(accumulate)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// a row-major [rows, cols] matrix of bf16 or int8 read in boxes of box_rows
// x box_cols, 128-byte swizzle, zeros past its edges
template <typename E>
inline bool encode_map(EncodeTiled encode, CUtensorMap* map, const E* ptr, int rows, int cols, int box_rows,
                       int box_cols) {
  static_assert(sizeof(E) == 2 || sizeof(E) == 1, "bf16 or int8 elements");
  const CUtensorMapDataType type = sizeof(E) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(E)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<E*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major bf16 [mats, rows, cols] array read in boxes of one matrix's
// box_rows x box_cols, under the given swizzle; zeros past the edges of each
// matrix, so a box never reads the next matrix's rows
inline bool encode_map3(EncodeTiled encode, CUtensorMap* map, const bf16* ptr, int mats, int rows, int cols,
                        int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * sizeof(bf16),
                                 static_cast<cuuint64_t>(rows) * cols * sizeof(bf16)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace evr

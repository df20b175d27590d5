// The int8 GEMM of K3a and K3b (block_quant.cu), written for Hopper:
//     out[M, N] = epilogue((a[M, K] @ w[K, N]) * a_scale[M] * w_scale[N] + bias[N]),
// int8 operands, int32 sums, and the dequantising epilogues of the
// reference at its rounding points: v = (float(sum) * a_scale) * w_scale +
// bias in fp32, each step rounded on its own (__fmul_rn/__fadd_rn, no
// contraction), then v rounded to the element type (kQStore), quickGELU or
// exact GELU of v in fp32 (kQQuickGelu, kQGelu: K3b's fp32 h), or the
// residual added in fp32 and rounded once (kQResidual); kQInt32 stores the
// sums themselves (ops.block_fused.gemm_s8 only, to hold them to an exact
// integer product). Integer sums are exact in any order, so this kernel's
// outputs are those of any other int8 GEMM with the same epilogue, bit for
// bit.
//
// wgmma takes 8-bit operands K-major only (its transpose bits are for 16-bit
// types), so B is W^T, read from an [N, K] copy of the params' [in, out]
// array that block_quant.cu's transpose_s8_kernel makes once per weight
// (ops/block_fused.py::k_major keeps it beside the weight); the params
// themselves keep their layout.
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): 2 M N K
// operations on M K + K N bytes in and M N outputs, e.g. K3b's fc at
// ViT-H-14's vision serving shape, 65,792 x 5,120 x 1,280: 862 G operations
// = 0.44 ms against 91 MB of int8 in and 1,347 MB of fp32 h out = 0.43 ms:
// at the ridge, so the design keeps the tensor cores fed and writes every
// output once, with 16-byte stores.
// Design, the bf16 GEMM's (gemm_sm90.cuh) at int8 widths:
//   - a 128 x 256 output tile, or 128 x 64 where N is not a multiple of 256
//     (the tiny test tower); K walked in 128-byte steps (128 int8: one
//     128-byte swizzle line a row, so the k32 steps sit 32 bytes apart along
//     it, as the bf16 kernel's k16 steps do);
//   - a ring of kStages = 4 stages (48 KB each: A 128 x 128, B 256 x 128; 24
//     KB narrow), a full and an empty mbarrier a stage, filled by one
//     producer warp (registers cut to 40 by setmaxnreg) whose one thread
//     issues 2-D TMA loads of both K-major boxes under the 128-byte swizzle;
//     TMA's zero fill covers a ragged M and a K that is not a multiple of
//     128 (zeros add nothing to an integer sum);
//   - two consumer warpgroups (registers raised to 232), each owning 64 rows
//     of the tile as 128 int32 accumulators a thread (32 narrow), through
//     wgmma.mma_async m64n256k32 (m64n64k32) .s32.s8.s8; one group stays in
//     flight while the next stage's is issued;
//   - the epilogue from the accumulator registers: the row scales of a
//     thread's two rows and the column scales and biases of its column
//     pairs, the output staged through the freed ring so that the residual
//     is read and every output written with 16-byte accesses; rows past M
//     are not stored;
//   - K3b's fc epilogue also takes each row's max |h| (over the thread's
//     values, then the four lanes that share its rows, then one atomicMax a
//     row and warp on the float's bits, which order as the floats do since
//     none is negative; max is exact in any order), so that the row pass
//     that quantises h reads it once instead of twice.
// Not done here: a persistent grid whose epilogue overlaps the next tile's
// products (the activation epilogues' arithmetic is what holds K3b's fc
// above the same product's int32 time).
#pragma once

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace evr {

// the epilogues of the int8 GEMM
enum QEpilogue { kQStore = 0, kQQuickGelu = 1, kQGelu = 2, kQResidual = 3, kQInt32 = 4 };

// What the int8 GEMM reads besides its operands and where it writes
template <typename T>
struct QOut {
  const float* a_scale;  // [M] per-token activation scales
  const float* w_scale;  // [N] per-output-channel weight scales
  const float* bias;     // [N]
  const T* res;          // [M, N] residual of kQResidual
  void* out;             // [M, N]: T (kQStore, kQResidual), fp32 (kQ*Gelu) or int32 (kQInt32)
  float* row_amax;       // [M] or null: kQ*Gelu also take each row's max |out| into it (zeroed first)
};

// the output element type of an epilogue over element type T
template <int EPI, typename T>
using QOutType =
    std::conditional_t<EPI == kQInt32, int, std::conditional_t<EPI == kQQuickGelu || EPI == kQGelu, float, T>>;

namespace s8 {

using namespace sm90;

constexpr int kBM = 128, kBK = 128, kStages = 4;      // K steps of 128 int8: one 128-byte swizzle line
constexpr int kBWide = 256, kBNarrow = 64;            // the output tile's N
constexpr int kConsumers = 2;                         // warpgroups of 128 threads, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);      // + the producer warpgroup
constexpr uint32_t kABytes = kBM * kBK;               // 16 KB
constexpr uint32_t kAWgBytes = 64 * kBK;              // a consumer warpgroup's 64 rows: 8 KB
template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() { return kABytes + BN * kBK; }
template <int BN>
__host__ __device__ constexpr size_t smem_bytes() { return 1024 + size_t(kStages) * stage_bytes<BN>() + 2 * kStages * sizeof(uint64_t); }
// a staged output row of BN elements of type TO, padded to keep 16-byte rows
template <int BN, typename TO>
__host__ __device__ constexpr int epi_ld() { return BN + 16 / static_cast<int>(sizeof(TO)); }
static_assert(kConsumers * 64 * epi_ld<kBWide, float>() * 4 <= kStages * stage_bytes<kBWide>(),
              "fp32 epilogue staging fits in the ring");
static_assert(kConsumers * 64 * epi_ld<kBNarrow, float>() * 4 <= kStages * stage_bytes<kBNarrow>(),
              "fp32 epilogue staging fits in the narrow ring");

// d[64 x 256] (+)= A[64 x 32] . B[32 x 256]: int8 in, int32 accumulators, both
// operands K-major from shared memory (the only layout wgmma takes for 8-bit
// types: its transpose bits are for 16-bit ones)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}

// d[64 x 64] (+)= A[64 x 32] . B[32 x 64], the narrow tile's product
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db, bool accumulate) {
  if constexpr (BN == kBWide)
    wgmma_s8_n256(d, da, db, accumulate);
  else
    wgmma_s8_n64(d, da, db, accumulate);
}

// -- the kernel -------------------------------------------------------------------

// Accumulator element i of a thread (lane, warp w of its warpgroup): row 16 w
// + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2 of
// the warpgroup's 64 x BN, as for fp32 accumulators.
template <int EPI, typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,  // A int8 [M, K], box 128 x 128
                   const __grid_constant__ CUtensorMap map_b,  // W^T int8 [N, K], box BN x 128
                   const QOut<T> o, int M, int N, int K) {
  using TO = QOutType<EPI, T>;
  constexpr uint32_t kStage = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 B: stage tiles start on that grid
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kStages * kStage;  // kStages full, then kStages empty barriers
  auto full = [full0](int s) { return full0 + 8u * s; };
  auto empty = [full0](int s) { return full0 + 8u * (kStages + s); };
  auto tile_a = [base](int s) { return base + s * kStage; };
  auto tile_b = [base](int s) { return base + s * kStage + kABytes; };

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;

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
        mbar_expect_tx(full(s), kStage);
        tma_load_2d(tile_a(s), &map_a, full(s), kt * kBK, m0);
        tma_load_2d(tile_b(s), &map_b, full(s), kt * kBK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // the first product of the first stage overwrites d (scale-d 0), so the
  // accumulators need no zeroing
  int d[BN / 2];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full(s), (kt / kStages) & 1);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 32; ++k)
      wgmma_s8<BN>(d, desc_kmajor(tile_a(s) + wg * kAWgBytes, k), desc_kmajor(tile_b(s), k), kt > 0 || k > 0);
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
  constexpr int kLd = epi_ld<BN, TO>();
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(TO));
  constexpr int kVecs = BN / kPerVec;  // 16-byte vectors a row
  TO* stage = reinterpret_cast<TO*>(smem) + wg * 64 * kLd;
  TO* out = static_cast<TO*>(o.out);
  if constexpr (EPI == kQResidual) {
    for (int i = t; i < 64 * kVecs; i += 128) {
      const int r = i / kVecs, c = (i % kVecs) * kPerVec;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(stage + r * kLd + c) =
            *reinterpret_cast<const uint4*>(o.res + static_cast<size_t>(row0 + r) * N + n0 + c);
    }
    named_bar_sync(2 + wg, 128);
  }
  constexpr bool kAct = EPI == kQQuickGelu || EPI == kQGelu;
  float amax[2] = {0.f, 0.f};  // the activation epilogues: max |out| of the thread's two rows
  float as[2] = {0.f, 0.f};
  if constexpr (EPI != kQInt32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + 16 * warp + lane / 4 + 8 * h;
      if (gr < M) as[h] = o.a_scale[gr];
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    float ws[2] = {0.f, 0.f}, bs[2] = {0.f, 0.f};
    if constexpr (EPI != kQInt32) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ws[e] = o.w_scale[n0 + col + e];
        bs[e] = o.bias[n0 + col + e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      TO* p = stage + (16 * warp + lane / 4 + 8 * h) * kLd + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int acc = d[4 * j + 2 * h + e];
        if constexpr (EPI == kQInt32) {
          p[e] = acc;
        } else {
          float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), as[h]), ws[e]);
          v = __fadd_rn(v, bs[e]);
          if constexpr (EPI == kQStore)
            p[e] = from_f<T>(v);
          else if constexpr (kAct) {
            const float act = EPI == kQQuickGelu ? quick_gelu(v) : gelu_as(v);
            p[e] = act;
            amax[h] = fmaxf(amax[h], fabsf(act));
          } else {
            p[e] = from_f<T>(__fadd_rn(to_f(p[e]), v));  // fp32 sum, one rounding
          }
        }
      }
    }
  }
  if constexpr (kAct) {
    if (o.row_amax != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const int gr = row0 + 16 * warp + lane / 4 + 8 * h;
        if (lane % 4 == 0 && gr < M) atomicMax(reinterpret_cast<int*>(o.row_amax + gr), __float_as_int(m));
      }
    }
  }
  named_bar_sync(2 + wg, 128);
  for (int i = t; i < 64 * kVecs; i += 128) {
    const int r = i / kVecs, c = (i % kVecs) * kPerVec;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c);
  }
}

}  // namespace s8

// The shapes the int8 GEMM takes (ops/block_fused.py::gemm_s8_takes mirrors
// this): N a multiple of the 64-wide narrow tile (of 256 for the wide one),
// K a multiple of 16 (the 16-byte rows TMA needs; TMA zero-fills the rest of
// the last 128-wide step), M any positive row count up to the grid's 65,535
// row tiles.
inline bool gemm_s8_takes(int M, int N, int K) {
  return M >= 1 && N >= s8::kBNarrow && N % s8::kBNarrow == 0 && K >= 16 && K % 16 == 0 &&
         (M + s8::kBM - 1) / s8::kBM <= 65535;
}

// Launch gemm_s8_kernel: out = epilogue(a @ w), a int8 [M, K], w_t the
// K-major copy [N, K] of w [K, N]. Returns -1 for a shape or alignment it
// does not take (TMA and the 16-byte epilogue need 16-byte aligned bases),
// else a CUDA error code (cudaErrorNotSupported when cuTensorMapEncodeTiled
// cannot be resolved, cudaErrorInvalidValue when a map cannot be encoded).
template <int EPI, typename T>
int launch_gemm_s8(const int8_t* a, const int8_t* w_t, QOut<T> o, int M, int N, int K, cudaStream_t stream) {
  if (!gemm_s8_takes(M, N, K)) return -1;
  if (!aligned16(a) || !aligned16(w_t) || !aligned16(o.out)) return -1;
  if (EPI == kQResidual && !aligned16(o.res)) return -1;
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto run = [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    CUtensorMap map_a, map_b;
    if (!sm90::encode_map(encode, &map_a, a, M, K, s8::kBM, s8::kBK) ||
        !sm90::encode_map(encode, &map_b, w_t, N, K, BN, s8::kBK))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = s8::gemm_s8_kernel<EPI, T, BN>;
    constexpr size_t smem = s8::smem_bytes<BN>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(N / BN, (M + s8::kBM - 1) / s8::kBM), s8::kThreads, smem, stream>>>(map_a, map_b, o, M, N, K);
    return static_cast<int>(cudaGetLastError());
  };
  if (N % s8::kBWide == 0) return run(std::integral_constant<int, s8::kBWide>{});
  return run(std::integral_constant<int, s8::kBNarrow>{});
}

}  // namespace evr

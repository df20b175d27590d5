// The bf16 GEMM of the block halves, written for Hopper:
//     out[M, N] = epilogue(op(A)[M, K] @ op(B)[K, N] + bias),
// bf16 operands, fp32 accumulation, and the epilogues at the reference's
// rounding points. Each operand comes in one of two layouts, a compile-time
// choice (the transpose bits of wgmma):
//   - A K-major: A stored [M, K] row-major (the activations: K1, K2, K9, and
//     K5's recomputed forwards and input gradients); or A MN-major: Aᵀ read
//     from an array stored [K, M] (a weight gradient yᵀ·g, whose sum runs
//     over the rows of y and g);
//   - B MN-major: W in the params' [in, out] layout, stored [K, N]; or B
//     K-major: Wᵀ read from W stored [N, K] (an input gradient g·Wᵀ).
// Epilogues: common.cuh's five, bf16 out (forwards; K5a's qkv and do); fp32
// out as it is (K5's weight gradients and dy); and K5b's two activation
// epilogues, each writing an fp32 and a bf16 output (kActFwd*: h_pre = sum +
// b and h = round(act(h_pre)); kActGrad*: dh_pre = sum * act'(h_pre), read
// from and written over the fp32 array, and round(dh_pre)).
//
// Bound on an H100 SXM: at the block halves' shapes the product does 2 M N K
// operations on (M K + K N + M N) elements, e.g. ViT-H-14's fc, 65,792 x
// 5,120 x 1,280: 862 GFLOP = 0.87 ms at the dense bf16 peak (989 TFLOP/s)
// against 855 MB = 0.26 ms at 3.35 TB/s; K5b's weight gradient dW_fc at
// ViT-L/14@336px, 1,024 x 4,096 x 18,464: 155 GFLOP = 0.16 ms against 207
// MB = 62 us. Bound by operations, so the design is about keeping the
// tensor cores fed:
//   - a 128 x 256 output tile, K walked in 64-wide steps (each 64-element row
//     of a K-major tile is one 128-byte swizzle line);
//   - a ring of kStages = 4 stages (48 KB each: A 128 x 64, B 64 x 256) in
//     dynamic shared memory, with a full and an empty mbarrier a stage;
//   - one producer warp (warpgroup 2, registers cut to 40 by setmaxnreg)
//     whose one thread issues the TMA loads (cp.async.bulk.tensor.2d), all
//     with the 128-byte swizzle: a K-major A as one box of 128 rows x 64, an
//     MN-major A as two of 64 K rows x 64 M columns, an MN-major B as four
//     of 64 K rows x 64 N columns, a K-major B as one of 256 N rows x 64.
//     TMA fills what lies past an edge with zeros, so a ragged M needs no
//     masking on load, and neither does a ragged K where both operands hold
//     K as their outer dimension (the weight gradients: K = the rows);
//   - two consumer warpgroups (registers raised to 232), each owning 64 x 256
//     of the tile as 128 fp32 accumulators a thread, through wgmma.mma_async
//     m64n256k16 with both operands from shared memory; one wgmma group stays
//     in flight while the next stage's is issued, and a stage is released to
//     the producer once its products are done;
//   - the epilogue from the accumulator registers, staged through the freed
//     ring so that the residual or h_pre is read and every output written
//     with 16-byte accesses; rows past M are not stored;
//   - a weight gradient with fewer output tiles than half the SMs (K5a's
//     dW_out: 32 tiles at W 1,024) splits its rows into up to kSplitMax
//     slices of at least 16 K steps, one grid layer each, writing fp32
//     partials that a second pass sums in slice order: no atomics, so a call
//     repeats bit for bit. (On an H100 80GB HBM3 at ViT-L/14@336px's 18,464
//     rows the split ran dW_out 2.7-2.9x faster than one pass; at 1,232
//     rows, 20 steps, four slices ran 0.77-0.86x as fast, hence the floor on
//     a slice.)
// Grid: one block per output tile (and K slice), N tiles fastest, so the
// blocks in flight share A's rows and walk B in L2. Not done here: a
// persistent grid whose epilogue overlaps the next tile's loads, clusters
// with TMA multicast, and feeding A to wgmma from registers (which would let
// the LayerNorm row pass fold into the GEMM).
//
// The PTX wrappers, descriptors and tensor-map encoding live in sm90.cuh,
// shared with the attention forward (attn_sm90.cuh).
#pragma once

#include <algorithm>
#include <cstdint>

#include "sm90.cuh"

namespace evr {

// The fp32-staged epilogues, beside common.cuh's bf16 ones: kF32 stores the
// sum as it is; kActFwd* (quickGELU, exact GELU) store h_pre = sum + bias and
// h = round(act(h_pre)); kActGrad* read h_pre and store dh_pre = sum *
// act'(h_pre) over it, and round(dh_pre).
enum GradEpilogue { kF32 = 16, kActFwdQuick = 17, kActFwdGelu = 18, kActGradQuick = 19, kActGradGelu = 20 };

// What a GEMM writes: the output (bf16 under common.cuh's epilogues, fp32
// under GradEpilogue's), a second bf16 output (kActFwd*: h; kActGrad*:
// round(dh_pre)), and what the epilogue reads besides the sum.
struct GemmOut {
  const bf16* bias;  // [N], or null: no bias
  const bf16* res;   // [M, N] residual of kResidual*
  void* out;         // [M, N]; kActGrad* read h_pre from it first
  bf16* out2;        // [M, N], kActFwd* and kActGrad* only
};

namespace sm90 {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2;                       // warpgroups of 128 threads, 64 rows each
constexpr int kGemmThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kBox = 64;                            // an MN-major TMA box: 64 columns (128 B) x kBK rows
constexpr uint32_t kABytes = kBM * kBK * 2;         // 16 KB
static_assert(kBoxBytes == kBox * kBK * 2, "an MN-major box: 64 x 64 (sm90.cuh)");
constexpr uint32_t kStageBytes = kABytes + kBN * kBK * 2;  // 48 KB
constexpr int kEpiLd = kBN + 8;                     // staged bf16 output row (elements), 16-byte multiple
constexpr int kEpiLd32 = kBN + 4;                   // staged fp32 output row (floats), 16-byte multiple
constexpr size_t kSmemBytes = 1024 + size_t(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t);
static_assert(kConsumers * 64 * kEpiLd32 * 4 <= kStages * kStageBytes, "epilogue staging fits in the ring");
constexpr int kSplitMax = 4;          // K slices of a weight gradient on a small grid
constexpr int kSplitBelowTiles = 66;  // half of an H100's 132 SMs
constexpr int kSplitMinSteps = 16;    // K steps a slice walks at least

// d[64 x 256] = A[64 x 16] . B[16 x 256] (+ d when accumulate): bf16 in, fp32
// accumulators; the transpose bit of A is 1 for MN-major (TA), of B 1 for
// MN-major (TB)
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db, bool accumulate) {
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
      " %128, %129, p, 1, 1, %131, %132;\n"
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
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)), "n"(TA ? 1 : 0), "n"(TB ? 1 : 0));
}

// -- the kernel -----------------------------------------------------------------

// d(act)/dh at h_pre, fp32: quickGELU or exact GELU (the A-S erf)
template <int EPI>
__device__ __forceinline__ float act_grad_of(float h) {
  if constexpr (EPI == kActGradQuick)
    return quick_gelu_grad(h);
  else
    return gelu_grad(h);
}

// one 16-byte vector of four fp32 sums of a GradEpilogue, at out and out2
template <int EPI>
__device__ __forceinline__ void store_grad_epilogue(float4 v, float* out, bf16* out2) {
  if constexpr (EPI == kF32) {
    *reinterpret_cast<float4*>(out) = v;
  } else {
    float a[4] = {v.x, v.y, v.z, v.w};
    if constexpr (EPI == kActGradQuick || EPI == kActGradGelu) {
      const float4 p = *reinterpret_cast<const float4*>(out);
      a[0] *= act_grad_of<EPI>(p.x);
      a[1] *= act_grad_of<EPI>(p.y);
      a[2] *= act_grad_of<EPI>(p.z);
      a[3] *= act_grad_of<EPI>(p.w);
      *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      *reinterpret_cast<float4*>(out) = v;
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = EPI == kActFwdQuick ? quick_gelu(a[i]) : gelu_as(a[i]);
    }
    __nv_bfloat162 r[2] = {__floats2bfloat162_rn(a[0], a[1]), __floats2bfloat162_rn(a[2], a[3])};
    *reinterpret_cast<uint2*>(out2) = *reinterpret_cast<const uint2*>(r);
  }
}

template <int EPI, bool A_MN, bool B_K>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,  // A [M, K] box 128 x 64, or [K, M] box 64 x 64
                     const __grid_constant__ CUtensorMap map_b,  // B [K, N] box 64 x 64, or [N, K] box 256 x 64
                     const GemmOut o, int M, int N, int K, int k_slice) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 B: stage tiles start on that grid
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kStages * kStageBytes;  // kStages full, then kStages empty barriers
  auto full = [full0](int s) { return full0 + 8u * s; };
  auto empty = [full0](int s) { return full0 + 8u * (kStages + s); };
  auto tile_a = [base](int s) { return base + s * kStageBytes; };
  auto tile_b = [base](int s) { return base + s * kStageBytes + kABytes; };

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // this block's K slice: all of K, or slice blockIdx.z of a split weight gradient
  const int k0 = blockIdx.z * k_slice;
  const int nk = (min(K - k0, k_slice) + kBK - 1) / kBK;

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
        const int s = kt % kStages, k = k0 + kt * kBK;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kStageBytes);
        if constexpr (A_MN) {
#pragma unroll
          for (int j = 0; j < kBM / kBox; ++j)
            tma_load_2d(tile_a(s) + j * kBoxBytes, &map_a, full(s), m0 + j * kBox, k);
        } else {
          tma_load_2d(tile_a(s), &map_a, full(s), k, m0);
        }
        if constexpr (B_K) {
          tma_load_2d(tile_b(s), &map_b, full(s), k, n0);
        } else {
#pragma unroll
          for (int j = 0; j < kBN / kBox; ++j)
            tma_load_2d(tile_b(s) + j * kBoxBytes, &map_b, full(s), n0 + j * kBox, k);
        }
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
      // both layouts of A put warpgroup wg's 64 rows 8 KB into the tile
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        const uint32_t a = tile_a(s) + wg * kBoxBytes;
        const uint64_t da = A_MN ? desc_mnmajor(a, k) : desc_kmajor(a, k);
        const uint64_t db = B_K ? desc_kmajor(tile_b(s), k) : desc_mnmajor(tile_b(s), k);
        wgmma_m64n256k16<A_MN, !B_K>(d, da, db, kt > 0 || k > 0);
      }
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
    // accumulator i of this thread: column 8 (i / 4) + 2 (lane % 4) + i % 2,
    // row 16 warp + lane / 4 + 8 ((i / 2) % 2) of the warpgroup's 64 rows
    if constexpr (EPI >= kF32) {
      float* stage = reinterpret_cast<float*>(smem) + wg * 64 * kEpiLd32;
      constexpr bool kBias = EPI == kActFwdQuick || EPI == kActFwdGelu;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        float2 b = make_float2(0.f, 0.f);
        if constexpr (kBias) b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o.bias + n0 + col));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(stage + (16 * warp + lane / 4 + 8 * h) * kEpiLd32 + col) =
              kBias ? make_float2(d[4 * j + 2 * h] + b.x, d[4 * j + 2 * h + 1] + b.y)
                    : make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
      named_bar_sync(2 + wg, 128);
      // a split weight gradient writes its slice's partial sums to layer z
      float* out = static_cast<float*>(o.out) + static_cast<size_t>(blockIdx.z) * M * N;
      constexpr int kVecs = kBN / 4;  // 16-byte vectors a row
      for (int i = t; i < 64 * kVecs; i += 128) {
        const int r = i / kVecs, c = (i % kVecs) * 4;
        if (row0 + r >= M) continue;
        const size_t off = static_cast<size_t>(row0 + r) * N + n0 + c;
        store_grad_epilogue<EPI>(*reinterpret_cast<const float4*>(stage + r * kEpiLd32 + c), out + off,
                                 o.out2 + off);
      }
    } else {
      bf16* out = static_cast<bf16*>(o.out);
      bf16* stage = reinterpret_cast<bf16*>(smem) + wg * 64 * kEpiLd;
      constexpr int kVecs = kBN / 8;  // 16-byte vectors a row
      if constexpr (epilogue_reads_residual<EPI>()) {
        for (int i = t; i < 64 * kVecs; i += 128) {
          const int r = i / kVecs, c = (i % kVecs) * 8;
          if (row0 + r < M)
            *reinterpret_cast<uint4*>(stage + r * kEpiLd + c) =
                *reinterpret_cast<const uint4*>(o.res + static_cast<size_t>(row0 + r) * N + n0 + c);
        }
        named_bar_sync(2 + wg, 128);
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        float2 b = make_float2(0.f, 0.f);
        if (o.bias != nullptr) b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o.bias + n0 + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* p =
              reinterpret_cast<__nv_bfloat162*>(stage + (16 * warp + lane / 4 + 8 * h) * kEpiLd + col);
          float2 r = make_float2(0.f, 0.f);
          if constexpr (epilogue_reads_residual<EPI>()) r = __bfloat1622float2(*p);
          __nv_bfloat162 v;
          v.x = apply_epilogue<bf16, EPI>(d[4 * j + 2 * h] + b.x, r.x);
          v.y = apply_epilogue<bf16, EPI>(d[4 * j + 2 * h + 1] + b.y, r.y);
          *p = v;
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
}

// out = the sum of the split partials part[z] (z = 0, 1, ..., splits - 1 in
// that order), n4 16-byte vectors each
__global__ void __launch_bounds__(256) split_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                                        size_t n4, int splits) {
  for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < n4; i += size_t(gridDim.x) * 256) {
    float4 s = part[i];
    for (int z = 1; z < splits; ++z) {
      const float4 p = part[z * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    out[i] = s;
  }
}

}  // namespace sm90

// The shapes the wgmma GEMM takes in each layout (ops/block_fused.py::
// gemm_takes mirrors this): N a multiple of the 256-wide tile; K a multiple
// of the 64-wide step where it is an operand's contiguous dimension (a
// K-major A or B), else any K (both operands hold K as their outer
// dimension, and TMA zero-fills past it); M any positive row count up to the
// grid's 65,535 row tiles, and with an MN-major A a multiple of 8 (the
// [K, M] array's rows must be 16-byte multiples for TMA).
template <bool A_MN = false, bool B_K = false>
inline bool gemm_takes(int M, int N, int K) {
  const bool k_contiguous = !A_MN || B_K;
  return M >= 1 && N >= sm90::kBN && N % sm90::kBN == 0 && K >= 1 && (!k_contiguous || K % sm90::kBK == 0) &&
         (!A_MN || M % 8 == 0) && (M + sm90::kBM - 1) / sm90::kBM <= 65535;
}

// Rows of K a slice walks: K itself, or, for a weight gradient (A and B
// MN-major) with fewer output tiles than kSplitBelowTiles, whole 64-row steps
// cut into at most kSplitMax slices of at least kSplitMinSteps steps each
// (ops/block_fused.py::gemm_k_slice mirrors this). The call then runs
// ceil(K / slice) slices.
template <bool A_MN, bool B_K>
inline int gemm_k_slice(int M, int N, int K) {
  using namespace sm90;
  const int steps = (K + kBK - 1) / kBK;
  const int slices = std::min(kSplitMax, steps / kSplitMinSteps);
  if (!A_MN || B_K || ((M + kBM - 1) / kBM) * (N / kBN) >= kSplitBelowTiles || slices < 2) return K;
  return (steps + slices - 1) / slices * kBK;
}

// Launch gemm_sm90_kernel: out = epilogue(op(a) @ op(b)), a stored [M, K]
// (or [K, M] with A_MN), b stored [K, N] (or [N, K] with B_K). ``split``
// holds the fp32 partials of a split weight gradient (splits x M x N floats,
// where splits = ceil(K / gemm_k_slice)); it is read only then. ``k_slice``
// other than 0 replaces gemm_k_slice's choice for a kF32 call (a multiple of
// 64, or K: no split), for timing the split against one pass. Returns -1
// for a shape or alignment it does not take (TMA and the 16-byte epilogue
// need 16-byte aligned bases), else a CUDA error code
// (cudaErrorNotSupported when cuTensorMapEncodeTiled cannot be resolved,
// cudaErrorInvalidValue when a map cannot be encoded).
template <int EPI, bool A_MN = false, bool B_K = false>
int launch_gemm_sm90(const bf16* a, const bf16* b, GemmOut o, int M, int N, int K, float* split,
                     cudaStream_t stream, int k_slice = 0) {
  using namespace sm90;
  if (!gemm_takes<A_MN, B_K>(M, N, K)) return -1;
  if (k_slice == 0)
    k_slice = EPI == kF32 ? gemm_k_slice<A_MN, B_K>(M, N, K) : K;
  else if (EPI != kF32 || k_slice < 1 || (k_slice < K && k_slice % kBK != 0))
    return -1;
  k_slice = std::min(k_slice, K);
  const int splits = (K + k_slice - 1) / k_slice;
  if (!aligned16(a) || !aligned16(b) || !aligned16(o.out)) return -1;
  if (o.bias != nullptr && reinterpret_cast<uintptr_t>(o.bias) % 4 != 0) return -1;
  if constexpr (EPI == kActFwdQuick || EPI == kActFwdGelu) {
    if (o.bias == nullptr) return -1;
  }
  if (epilogue_reads_residual<EPI>() && !aligned16(o.res)) return -1;
  if (EPI > kF32 && !aligned16(o.out2)) return -1;
  if (splits > 1 && !aligned16(split)) return -1;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b;
  const bool ok_a =
      A_MN ? encode_map(encode, &map_a, a, K, M, kBK, kBox) : encode_map(encode, &map_a, a, M, K, kBM, kBK);
  const bool ok_b =
      B_K ? encode_map(encode, &map_b, b, N, K, kBN, kBK) : encode_map(encode, &map_b, b, K, N, kBK, kBox);
  if (!ok_a || !ok_b) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_sm90_kernel<EPI, A_MN, B_K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmOut to = o;
  if (splits > 1) to.out = split;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM, splits);
  kernel<<<grid, kGemmThreads, kSmemBytes, stream>>>(map_a, map_b, to, M, N, K, k_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(std::min<size_t>((n4 + 255) / 256, 4096));
  split_sum_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(split),
                                               reinterpret_cast<float4*>(o.out), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

// The forward block halves' GEMM (K1, K2, K9): bf16 on the wgmma kernel
// above, fp32 on the CUDA-core gemm_kernel of common.cuh (full fp32, the
// on-card parity path).
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
  return launch_gemm_sm90<EPI>(a, w, GemmOut{bias, res, out, nullptr}, M, N, K, nullptr, stream);
}

template <int EPI>
int block_gemm(const float* a, const float* w, const float* bias, const float* res, float* out, int M, int N,
               int K, cudaStream_t stream) {
  return launch_gemm<EPI>(a, w, bias, res, out, M, N, K, stream);
}

}  // namespace evr

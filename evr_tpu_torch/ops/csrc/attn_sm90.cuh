// The bf16 attention forward, written for Hopper: per (sequence, head),
//     o = softmax(round(q * scale) k^T) v,
// q, k and v [T, d] in bf16, head dim d = 64 or 80, any T, causal or not.
// The forward of K1, K3a and K9 (flash.cuh's launch_flash_fwd, on the packed
// qkv [B*T, 3W] of the block) and of K6a and K6b (flash_attn.cu, on
// contiguous [B*H, T, d] arrays) in bf16; their fp32 calls keep the
// CUDA-core kernels of flash.cuh and flash_attn.cu (wgmma has no full-fp32
// input).
//
// Replaces: the attention core of evr_tpu/ops/block_fused.py::
// fused_attn_block (_attn_block_kernel, and so of fused_quant_block_apply's
// and fused_block_merged's attention) and evr_tpu/ops/attention.py::
// _flash_forward_impl (_attention_kernel_full, _attention_kernel). Rounding
// points of those kernels, kept exactly: q times the scale in bf16, the
// scale itself rounded to bf16 first (the launchers round it); scores in
// fp32; the row max over the WHOLE row before any exponent; p = exp(s - m)
// in fp32, the denominator the fp32 sum of the unrounded p; round(p) . v
// summed in fp32, divided by the denominator after the product, rounded.
// Keys past T, and past the diagonal in a causal tower, are left out by
// index (each masked score of the TPU kernels gives exp(s - m) = 0 in fp32);
// the zeros TMA fills past T are never read as scores.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): per (sequence,
// head) 4 T^2 d operations against q, k, v and o of T d elements each.
// ViT-H-14's vision serving, B 256, H 16, T 257, d 80: 673.7 MB = 0.201 ms
// against 86.6 GFLOP = 0.088 ms; ViT-L/14@336px training, B 32, H 16, T
// 577, d 64: 151 MB = 45 us against 43.6 GFLOP = 44 us. Bound by bytes at
// CLIP's lengths, so the design keeps every intermediate on chip and reads
// q, k and v from device memory about once:
//   - one block per (pair of 64-row query tiles, head, sequence): two
//     consumer warpgroups, each owning one 64-row tile, share every k and v
//     tile a producer warp loads;
//   - one producer warp whose first thread issues 3-D TMA loads over
//     [sequences, T, columns] maps (K1: the packed qkv, head h's q, k, v at
//     columns h d, W + h d, 2W + h d; K6: the [B*H, T, d] arrays), so TMA
//     zero-fills past T inside each sequence: the q tiles once, then the k
//     tiles, then (k,) v tiles, with a full and an empty mbarrier a slot. A
//     row of d 80 is two boxes: columns [0, 64) under the 128-byte swizzle
//     and [64, 80) under the 32-byte swizzle (a 128-byte-swizzled box is at
//     most 128 bytes wide);
//   - two blocks on an SM (the consumers wait on their own products, so a
//     second block's warpgroups fill the gaps): shared memory is sized to
//     the key row, each block under half of the SM's 228 KB;
//   - the softmax needs the row's true max before any exponent (an online
//     softmax would round p against a partial max), so each warpgroup walks
//     the key blocks twice: walk 1 for the max, walk 2 for p, l and p . v.
//     While the key row fits in the k slots of such a block (T <= 320 at d
//     80, T <= 448 at d 64), k stays resident in shared memory after walk 1
//     and walk 2 reads it again from there; longer rows stream k twice
//     through the same slots;
//   - S = q k^T by wgmma m64n64k16 with both operands K-major from shared
//     memory (a fifth, 32-byte-swizzled k16 step at d 80), S in registers:
//     each thread holds two rows' 16 columns of a key block, so the row max
//     takes two quad shuffles and no score reaches shared memory; walk 1
//     keeps the next block's product in flight (two score buffers) while it
//     takes the max of the last;
//   - walk 2 recomputes S, forms p = exp(s - m) and l in registers, packs
//     round(p) into bf16 pairs (the f32 accumulator layout of a 64 x 16 key
//     chunk is the register layout of wgmma's A operand) and runs p . v by
//     wgmma with A from registers and v as an MN-major B through the
//     transpose bit (m64n64k16, plus m64n16k16 on the 32-byte-swizzled box
//     at d 80); o stays in registers (32 or 40 floats a thread), and the
//     next block's scores are issued behind p . v, one wait for both;
//   - the epilogue divides by l, rounds, stages the tile over its own q tile
//     and writes rows below T with 16-byte stores.
// What holds it above its bound (measured with tools/attn_bench.py on an
// H100 80GB HBM3, 700 W): not the bytes and not the tensor cores' rate but
// the chain each warpgroup walks, wait for the scores, exponentials, issue
// p . v and the next scores, wait; the four warpgroups of an SM run in step,
// so the tensor cores idle while they exponentiate, and a block waits on its
// loads at its start. Tried and slower there: one block an SM (no register
// cap), a persistent grid prefetching the next tile pair's q and k, and
// turns between a block's two warpgroups on the tensor cores. Not done
// here: packing several short sequences into one tile (T = 257 leaves a
// one-row tail tile: 20 % more products than needed), and overlapping a
// warpgroup's exponentials with its own next scores (a second score buffer
// in registers, which two blocks an SM cannot spare).
#pragma once

#include <cstring>

#include "sm90.cuh"

namespace evr {
namespace attn90 {

using namespace sm90;

constexpr int kTile = 64;                        // query rows per consumer warpgroup; keys per block
constexpr int kConsumers = 2;                    // consumer warpgroups: query tiles per block
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kVSlots = 4;                       // the v ring
constexpr size_t kSmemPerSm = 233472;            // an H100 SM's 228 KB
constexpr size_t kSmemPerBlock = kSmemPerSm / 2 - 1024;  // two blocks an SM, 1 KB each kept by the runtime

// the head dims the kernel takes
__host__ __device__ constexpr bool takes_head_dim(int d) { return d == 64 || d == 80; }

__host__ __device__ constexpr int key_blocks(int T) { return (T + kTile - 1) / kTile; }

// Shared memory at head dim D: the consumers' q tiles, k_slots k tiles,
// kVSlots v tiles, then the mbarriers (q full; k full and empty; v full and
// empty). A tile is 64 rows of D, stored as a 128-byte-swizzled box of
// columns [0, 64) and, at D = 80, a 32-byte-swizzled box of [64, 80) right
// after it; every tile starts on the swizzle's 1,024-byte period.
template <int D>
struct Plan {
  static_assert(takes_head_dim(D), "head dim 64 or 80");
  static constexpr bool kSplit = D == 80;
  static constexpr uint32_t kBox0 = kTile * 64 * 2;  // 8 KB
  static constexpr uint32_t kTileBytes = kTile * D * 2;
  static_assert(kTileBytes % 1024 == 0, "tiles on the 128-byte swizzle's period");
  static constexpr size_t smem(int k_slots) {
    return 1024 + static_cast<size_t>(kConsumers + k_slots + kVSlots) * kTileBytes + 8 * (1 + 2 * k_slots + 2 * kVSlots);
  }
  // k slots of a block over rows of T keys (ops/block_fused.py::attn_k_slots
  // mirrors this): the whole row, resident, where that fits two blocks on an
  // SM; else as many as fit, streamed twice
  static int k_slots(int T) {
    if (smem(key_blocks(T)) <= kSmemPerBlock) return key_blocks(T);
    int n = 2;
    while (smem(n + 1) <= kSmemPerBlock) ++n;
    return n;
  }
  static_assert(smem(2) <= kSmemPerBlock, "two k slots fit");
};

// Where the kernel reads and writes: q, k and v through tensor maps over
// [seqs, T, cols] arrays, head h's at columns h D, col_k + h D, col_v + h D;
// o at o[(seq T + i) ld_o + h D + c].
struct Args {
  bf16* o;
  int ld_o, T, H, n_pairs, col_k, col_v, causal, k_slots;
  float scale;  // already rounded to bf16
};

// -- wgmma of the two products ------------------------------------------------------

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

// -- the kernel -----------------------------------------------------------------

// Accumulator element e of a thread (lane, warp w of its warpgroup) in an
// m64nN product: row 16 w + lane / 4 + 8 ((e / 2) % 2), column 8 (e / 4) +
// 2 (lane % 4) + e % 2. A thread so holds rows r0 = 16 w + lane / 4 and r0
// + 8, and the four lanes of a quad hold a row's columns between them.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    attn_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mq2,
                     const __grid_constant__ CUtensorMap mk2, const __grid_constant__ CUtensorMap mv2,
                     const Args a) {
  using P = Plan<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int ks = a.k_slots;
  const uint32_t bars = base + (kConsumers + ks + kVSlots) * P::kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [bars](int s) { return bars + 8u * (1 + s); };
  auto k_empty = [bars, ks](int s) { return bars + 8u * (1 + ks + s); };
  auto v_full = [bars, ks](int s) { return bars + 8u * (1 + 2 * ks + s); };
  auto v_empty = [bars, ks](int s) { return bars + 8u * (1 + 2 * ks + kVSlots + s); };
  auto q_tile = [base](int w) { return base + w * P::kTileBytes; };
  auto k_tile = [base](int s) { return base + (kConsumers + s) * P::kTileBytes; };
  auto v_tile = [base, ks](int s) { return base + (kConsumers + ks + s) * P::kTileBytes; };

  // this block: query tiles 2 pair and 2 pair + 1 of head h of sequence seq
  const int pair = blockIdx.x % a.n_pairs, rest = blockIdx.x / a.n_pairs;
  const int h = rest % a.H, seq = rest / a.H;
  const int T = a.T, causal = a.causal, n_tiles = key_blocks(T), qt0 = kConsumers * pair;
  const int n_active = min(kConsumers, n_tiles - qt0);  // the second tile may lie past T
  const int n_kb = causal ? min(qt0 + n_active, n_tiles) : n_tiles;  // key blocks the block reads
  const bool resident = n_kb <= ks;  // k loaded once and read by both walks
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ks; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), n_active);
    }
    for (int s = 0; s < kVSlots; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), n_active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // k use u (walk 0: u = kb; walk 1, streaming: u = n_kb + kb) sits in slot
  // u % ks, its (u / ks)-th fill; resident, walk 1 reads walk 0's fills again
  auto k_slot = [resident, n_kb, ks](int kb, int walk) { return resident ? kb : (walk * n_kb + kb) % ks; };
  auto k_fill = [resident, n_kb, ks](int kb, int walk) { return resident ? 0 : (walk * n_kb + kb) / ks; };

  if (wg == kConsumers) {
    // producer: one thread keeps the k and v slots filled ahead of the walks
    if (threadIdx.x != kConsumers * 128) return;
    const int cq = h * D, ck = a.col_k + h * D, cv = a.col_v + h * D;
    auto load = [seq](uint32_t dst, const CUtensorMap* m, const CUtensorMap* m2, int col, int row, uint32_t bar) {
      tma_load_3d(dst, m, bar, col, row, seq);
      if constexpr (P::kSplit) tma_load_3d(dst + P::kBox0, m2, bar, col + 64, row, seq);
    };
    mbar_expect_tx(q_full, n_active * P::kTileBytes);
    for (int w = 0; w < n_active; ++w) load(q_tile(w), &mq, &mq2, cq, (qt0 + w) * kTile, q_full);
    for (int walk = 0; walk < 2; ++walk) {
      for (int kb = 0; kb < n_kb; ++kb) {
        if (walk == 0 || !resident) {
          const int s = k_slot(kb, walk), fill = k_fill(kb, walk);
          if (fill > 0) mbar_wait(k_empty(s), (fill - 1) & 1);
          mbar_expect_tx(k_full(s), P::kTileBytes);
          load(k_tile(s), &mk, &mk2, ck, kb * kTile, k_full(s));
        }
        if (walk == 1) {
          const int s = kb % kVSlots, fill = kb / kVSlots;
          if (fill > 0) mbar_wait(v_empty(s), (fill - 1) & 1);
          mbar_expect_tx(v_full(s), P::kTileBytes);
          load(v_tile(s), &mv, &mv2, cv, kb * kTile, v_full(s));
        }
      }
    }
    return;
  }
  if (wg >= n_active) return;  // a tile past T

  // consumer: warpgroup wg owns query rows [i0, i0 + 64)
  const int qt = qt0 + wg, i0 = qt * kTile;
  const int my_kb = causal ? qt + 1 : n_tiles;  // key blocks this tile sees
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t q = q_tile(wg);

  // q times the scale, rounded: elementwise, so the swizzle does not matter
  mbar_wait(q_full, 0);
  {
    const float scale = a.scale;
    uint4* qv = reinterpret_cast<uint4*>(smem + wg * P::kTileBytes);
    for (int i = t; i < static_cast<int>(P::kTileBytes / 16); i += 128) {
      uint4 v = qv[i];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      qv[i] = v;
    }
    fence_async_shared();
    named_bar_sync(1 + wg, 128);
  }

  // key j is in row i's softmax; a key block needs the test past T and on
  // the causal diagonal
  auto visible = [causal, T](int i, int j) { return j < T && !(causal && j > i); };
  auto edge = [causal, T, qt](int kb) { return (kb + 1) * kTile > T || (causal && kb == qt); };

  // s = q . k^T for key block kb (of walk 0 or 1): issued and committed, not
  // waited for; four 128-byte-swizzled k16 steps over the head dim, and at D
  // = 80 a fifth on the 32-byte-swizzled box
  auto issue_scores = [&](float (&s)[32], int kb, int walk) {
    const int slot = k_slot(kb, walk);
    mbar_wait(k_full(slot), k_fill(kb, walk) & 1);
    const uint32_t k = k_tile(slot);
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64(s, desc_kmajor(q, kk), desc_kmajor(k, kk), kk > 0);
    if constexpr (P::kSplit) wgmma_ss_n64(s, desc_kmajor32(q + P::kBox0), desc_kmajor32(k + P::kBox0), true);
    wgmma_commit();
  };
  // a k tile read by this warpgroup's products for the last time in a walk
  auto release_k = [&](int kb, int walk) {
    if (!resident && t == 0) mbar_arrive(k_empty(k_slot(kb, walk)));
  };

  // walk 0: the max of rows r0 and r0 + 8 over the whole row, block kb + 1's
  // scores in flight while block kb's are reduced
  float m[2] = {-INFINITY, -INFINITY};
  auto row_max = [&](const float (&s)[32], int kb) {
    if (edge(kb)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hr = (e / 2) % 2, j = kb * kTile + 8 * (e / 4) + c0 + e % 2;
        if (visible(i0 + r0 + 8 * hr, j)) m[hr] = fmaxf(m[hr], s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) m[(e / 2) % 2] = fmaxf(m[(e / 2) % 2], s[e]);
    }
  };
  float sa[32], sb[32];
  issue_scores(sa, 0, 0);
  for (int kb = 0; kb < my_kb; kb += 2) {
    if (kb + 1 < my_kb) {
      issue_scores(sb, kb + 1, 0);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(sa);
    row_max(sa, kb);
    release_k(kb, 0);
    if (kb + 1 < my_kb) {
      if (kb + 2 < my_kb) {
        issue_scores(sa, kb + 2, 0);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_acc(sb);
      row_max(sb, kb + 1);
      release_k(kb + 1, 0);
    }
  }
  for (int kb = my_kb; kb < n_kb; ++kb) {  // past the causal diagonal: the slots' turns only
    mbar_wait(k_full(k_slot(kb, 0)), k_fill(kb, 0) & 1);
    release_k(kb, 0);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
    m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
  }

  // walk 1: p = exp(s - m), its fp32 sum l, and round(p) . v; block kb + 1's
  // scores are issued behind block kb's p . v
  float o[32], o2[8];
  float l[2] = {0.f, 0.f};
  uint32_t pa[16];
  issue_scores(sa, 0, 1);
  wgmma_wait<0>();
  fence_acc(sa);
  for (int kb = 0; kb < my_kb; ++kb) {
    release_k(kb, 1);
    const bool masked = edge(kb);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hr = (e / 2) % 2;
      float p = expf(sa[e] - m[hr]);
      if (masked && !visible(i0 + r0 + 8 * hr, kb * kTile + 8 * (e / 4) + c0 + e % 2)) p = 0.f;
      l[hr] += p;
      sa[e] = p;
    }
    // key chunk c (keys 16 c .. 16 c + 15) as wgmma's A fragment: rows r0
    // and r0 + 8, keys 16 c + c0 (+1) and 16 c + 8 + c0 (+1)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[4 * c + 0] = pack_bf16(sa[8 * c + 0], sa[8 * c + 1]);
      pa[4 * c + 1] = pack_bf16(sa[8 * c + 2], sa[8 * c + 3]);
      pa[4 * c + 2] = pack_bf16(sa[8 * c + 4], sa[8 * c + 5]);
      pa[4 * c + 3] = pack_bf16(sa[8 * c + 6], sa[8 * c + 7]);
    }
    const int vs = kb % kVSlots;
    mbar_wait(v_full(vs), (kb / kVSlots) & 1);
    const uint32_t v = v_tile(vs);
    fence_acc(o);
    if constexpr (P::kSplit) fence_acc(o2);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs_n64(o, pa + 4 * c, desc_mnmajor(v, c), kb > 0 || c > 0);
      if constexpr (P::kSplit) wgmma_rs_n16(o2, pa + 4 * c, desc_mnmajor32(v + P::kBox0, c), kb > 0 || c > 0);
    }
    wgmma_commit();
    if (kb + 1 < my_kb) issue_scores(sa, kb + 1, 1);
    wgmma_wait<0>();
    fence_acc(o);
    if constexpr (P::kSplit) fence_acc(o2);
    fence_acc(sa);
    if (t == 0) mbar_arrive(v_empty(vs));
  }
  for (int kb = my_kb; kb < n_kb; ++kb) {  // past the causal diagonal: the slots' turns only
    mbar_wait(k_full(k_slot(kb, 1)), k_fill(kb, 1) & 1);
    release_k(kb, 1);
    const int vs = kb % kVSlots;
    mbar_wait(v_full(vs), (kb / kVSlots) & 1);
    if (t == 0) mbar_arrive(v_empty(vs));
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }

  // epilogue: round(o / l), staged row-major over the q tile (free once every
  // product of the warpgroup is done), then 16-byte stores of rows below T
  named_bar_sync(1 + wg, 128);
  bf16* stage = reinterpret_cast<bf16*>(smem + wg * P::kTileBytes);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int hr = (e / 2) % 2;
    *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * hr) * D + 8 * (e / 4) + c0) =
        __floats2bfloat162_rn(o[e] / l[hr], o[e + 1] / l[hr]);
  }
  if constexpr (P::kSplit) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int hr = (e / 2) % 2;
      *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * hr) * D + 64 + 8 * (e / 4) + c0) =
          __floats2bfloat162_rn(o2[e] / l[hr], o2[e + 1] / l[hr]);
    }
  }
  named_bar_sync(1 + wg, 128);
  constexpr int kVecs = D / 8;  // 16-byte vectors a row
  for (int i = t; i < kTile * kVecs; i += 128) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    if (i0 + r < T)
      *reinterpret_cast<uint4*>(a.o + (static_cast<size_t>(seq) * T + i0 + r) * a.ld_o + h * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * D + c);
  }
}

// v rounded to bf16 (nearest, ties to even) on the host
inline float round_bf16(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&v, &u, 4);
  return v;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, int cols, int col_k, int col_v, bf16* o, int ld_o,
           int seqs, int T, int H, int causal, float scale, cudaStream_t stream) {
  using P = Plan<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[6];
  const bf16* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const bool ok = encode_map3(encode, &maps[i], src[i], seqs, T, cols, kTile, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
                    (!P::kSplit ||
                     encode_map3(encode, &maps[3 + i], src[i], seqs, T, cols, kTile, 16, CU_TENSOR_MAP_SWIZZLE_32B));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!P::kSplit)
    for (int i = 0; i < 3; ++i) maps[3 + i] = maps[i];  // not read
  const int n_pairs = (key_blocks(T) + kConsumers - 1) / kConsumers, k_slots = P::k_slots(T);
  const Args args{o, ld_o, T, H, n_pairs, col_k, col_v, causal, k_slots, round_bf16(scale)};
  const size_t smem = P::smem(k_slots);
  auto kernel = attn_sm90_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemPerBlock));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(n_pairs) * H * seqs;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                                    maps[5], args);
  return static_cast<int>(cudaGetLastError());
}

// the shapes the kernel takes (ops/block_fused.py::attn_takes mirrors this):
// head dim 64 or 80, any T, a grid of at most 2^31 - 1 blocks
inline bool takes(int seqs, int T, int H, int d) {
  if (!takes_head_dim(d) || seqs < 1 || T < 1 || H < 1) return false;
  const long long pairs = (key_blocks(T) + kConsumers - 1) / kConsumers;
  return pairs * H * seqs <= 0x7FFFFFFFll;
}

template <typename F>
int dispatch(int d, F&& f) {
  if (d == 64) return f(std::integral_constant<int, 64>{});
  if (d == 80) return f(std::integral_constant<int, 80>{});
  return -1;
}

}  // namespace attn90

// The attention forward of K1, K3a and K9 on the packed qkv [B*T, 3W] of the
// block (head h's q, k, v at columns h d, W + h d, 2W + h d), o [B*T, W].
// -1 for a shape the kernel does not take, else a CUDA error code.
inline int launch_attn_sm90_packed(const bf16* qkv, bf16* o, int B, int T, int W, int H, int causal, float scale,
                                   cudaStream_t stream) {
  if (H < 1 || W % H != 0 || !attn90::takes(B, T, H, W / H) || !aligned16(qkv) || !aligned16(o) || W % 8 != 0)
    return -1;
  return attn90::dispatch(W / H, [&](auto d) {
    return attn90::launch<decltype(d)::value>(qkv, qkv, qkv, 3 * W, W, 2 * W, o, W, B, T, H, causal, scale, stream);
  });
}

// The attention forward of K6a and K6b on contiguous q, k, v and o [BH, T, d].
inline int launch_attn_sm90_heads(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int T, int d,
                                  int causal, float scale, cudaStream_t stream) {
  if (!attn90::takes(BH, T, 1, d) || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) return -1;
  return attn90::dispatch(d, [&](auto dd) {
    return attn90::launch<decltype(dd)::value>(q, k, v, dd.value, 0, 0, o, dd.value, BH, T, 1, causal, scale,
                                               stream);
  });
}

}  // namespace evr

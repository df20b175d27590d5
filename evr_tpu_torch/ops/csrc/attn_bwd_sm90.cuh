// The bf16 attention backward of K5a, written for Hopper: per (sequence,
// head), from the rounded packed qkv [B*T, 3W] (head h's q, k, v at columns
// h d, W + h d, 2W + h d) and do [B*T, W] in bf16, head dim d = 16, 64 or
// 80, any T, causal or not:
//     s = round(q * scale) k^T in fp32 (keys past T, and past the diagonal
//       when causal, left out by index), m = the row's true max,
//     pn = exp(s - m) / l in fp32, l = sum exp(s - m),
//     o = round(round(pn) v), dpn = do v^T, D = rowsum(dpn * pn),
//     ds = pn (dpn - D), dq = round(ds) k * scale, dk = round(ds)^T q_scaled,
//     dv = round(pn)^T do,
// written into the q, k and v columns of the fp32 dqkv [B*T, 3W] and of
// dqkv_r, the same rounded to bf16, with o [B*T, W] and the row statistics
// st = (m, l, D) [3, B, H, T]. flash.cuh's flash_backward routes bf16 here
// by the element type alone; fp32 keeps its CUDA-core kernels (wgmma has no
// full-fp32 input).
//
// Replaces: the attention part of evr_tpu/ops/block_fused.py:618 →
// fused_attn_block_bwd (its Pallas body _attn_block_bwd_kernel), at that
// kernel's rounding points, kept exactly: q times the scale in bf16 (the
// scale rounded to bf16 first), dq scaled by the unrounded fp32 value; pn
// rounded for o and dv, the fp32 pn in D and ds; ds rounded for dq and dk.
// D is rowsum(dpn * pn) with the fp32 pn, not FlashAttention-2's rowsum(do *
// o): o is built from round(pn), so that identity is not the reference's
// rounding point. What differs is fp32 arithmetic only: exp(x) is taken as
// exp2(x log2 e) and the divide by l as a product with 1 / l (a few ulp,
// and fewer instructions for the exponentials both kernels take of every
// score), and l and D are summed online (below).
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at ViT-L/14@336px
// training (B 32, T 577, W 1,024, H 16, d 64): 12 T^2 d operations per
// (sequence, head) (s, round(pn) v, dpn, dv, dq, dk) = 130.9 GFLOP = 0.132
// ms; qkv and do read, o, the fp32 dqkv and the bf16 dqkv_r written, 28 T W
// bytes a sequence = 529 MB = 0.158 ms. Bound by bytes, so every
// intermediate (s, pn, dpn, ds) stays in registers and each output is
// written once; the price is recomputing q k^T and do v^T three times each
// (10 products where the minimum is 6). Two launches, because D must be
// complete for a row before any dk takes it:
//
// 1. attn_bwd_q_kernel, per (pair of 64-row query tiles, head, sequence):
//    one thread of the producer warpgroup issues 3-D TMA loads (the q and do
//    tiles once, then each key block's k and v tiles through a ring of
//    slots, zero-filled past T in each sequence); two consumer warpgroups
//    each own one query tile, q scaled in bf16 in shared memory, and walk
//    the key blocks twice with s and dpn = do v^T in registers (wgmma
//    m64n64k16, both operands K-major):
//    - walk 1: the row max m, with l = sum exp(s - m) and the unnormalised
//      D, sum dpn exp(s - m), online beside it: each thread keeps them over
//      its own columns, rescaling both sums when its max rises; the four
//      lanes of a quad combine theirs at the end, and D is the second sum
//      over l. Only fp32 arithmetic in l and D differs from the reference's
//      extra walks (neither is rounded there); the max, and so every
//      rounding point, is the true one;
//    - walk 2: s and dpn again → pn → ds; o += round(pn) v and dq +=
//      round(ds) k with pn and ds as wgmma's register A operand and v and k
//      MN-major through the transpose bit (m64n64k16, plus m64n16k16 on the
//      32-byte-swizzled box at d 80; at d 16 that box alone, s and dpn one
//      k16 step and every d-wide product m64n16k16), the next block's s and
//      dpn issued behind them, one wait for all; then o, dq * scale (fp32
//      and bf16) and (m, l, D) written.
//    While the key row fits (T <= 768 at d 64, T <= 576 at d 80, T <= 3,456
//    at d 16) k and v stay resident after their first load; longer rows
//    stream through the same slots once a walk.
// 2. attn_bwd_kv_kernel, per (pair of 64-key tiles, head, sequence), after
//    FlashAttention-3's backward: each consumer warpgroup keeps its k and v
//    tiles resident and walks the query tiles (causal: from the diagonal's),
//    computing the transposes s^T = k q^T and dpn^T = v do^T so that the
//    accumulator's rows are keys; then dv += round(pn^T) do and dk +=
//    round(ds^T) q_scaled take pn^T and ds^T straight from registers as the
//    A operand, with do and q MN-major. The producer warpgroup's first warp
//    streams q and do tiles through a ring of kStages stages, with each
//    tile's (m, l, D) rows, and scales q in bf16 in shared memory (so the
//    two consumers share one scaled copy), its loads kStages / 2 tiles ahead
//    of the scaling.
// Both kernels run one block an SM with a producer warpgroup whose
// registers setmaxnreg cuts to 40, so that each consumer thread has 232:
// walk 2 holds o and dq (16, 64 or 80 floats) beside s, dpn and their packed
// bf16 copies, the key-tile kernel dk and dv beside s^T and dpn^T. Every
// wait is for all of a warpgroup's products (wgmma_wait<0>): reading one
// accumulator while another product is in flight, as a double-buffered walk
// does, made ptxas serialise every wgmma of the kernel (its note C7514, a
// WARPGROUP.DEPBAR after each HGMMA).
// No atomics: each output element is written once by the one warpgroup
// that owns its row, every sum in a fixed order, so a call repeats bit for
// bit. The pieces shared with the forward (tile layout, TMA tile loads, the
// q scaling, the product sequences, the register A operand) are in
// attn_sm90.cuh and sm90.cuh.
#pragma once

#include "attn_sm90.cuh"

namespace evr {
namespace attn_bwd90 {

using namespace sm90;
using attn90::HeadTile;
using attn90::issue_rs;
using attn90::issue_ss;
using attn90::key_blocks;
using attn90::kTile;
using attn90::load_tile;
using attn90::pack_a;
using attn90::scale_tile;

constexpr int kConsumers = 2;                       // consumer warpgroups: tiles per block
// the forward's grid of tile pairs, so the forward's shape rule (attn90::takes) is the backward's too,
// at the head dims the backward takes
static_assert(kConsumers == attn90::kConsumers, "pairs of 64-row tiles, as the forward");

// the head dims the backward takes: the forward's, 16 (the tiny test
// tower's: one 16-column, 32-byte-swizzled box a tile), 64 and 80
__host__ __device__ constexpr bool takes_head_dim(int d) { return d == 16 || d == 64 || d == 80; }
constexpr int kThreads = 128 * (kConsumers + 1);    // and the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr size_t kSmemPerBlock = 232448;         // the most one block of an H100 may take (227 KB)
constexpr int kStages = 4;                       // the q / do ring of the key-tile kernel
constexpr uint32_t kStatBytes = 3 * kTile * 4;   // (m, l, D) of a query tile's 64 rows
constexpr float kLog2e = 1.4426950408889634f;

// exp(x) in fp32 as the kernels take it: exp2(x log2 e), within a few ulp of
// expf (x = s - m is formed first, so the error stays small where exp(x) is
// not); pn = ex(s - m) times the reciprocal of l, the fp32 arithmetic that
// differs from the reference's exp and divide (no rounding point does)
__device__ __forceinline__ float ex(float x) { return exp2f(x * kLog2e); }

// Shared memory of the query-tile kernel at head dim D with ``slots`` slots
// of a k and a v tile: the consumers' q and do tiles, the k and v tiles of
// the slots, then the mbarriers (q full; per slot full and empty)
template <int D>
struct QPlan {
  static_assert(takes_head_dim(D), "the backward takes head dims 16, 64 and 80");
  static constexpr uint32_t kTileBytes = HeadTile<D>::kTileBytes;
  static constexpr size_t smem(int slots) {
    return 1024 + static_cast<size_t>(2 * kConsumers + 2 * slots) * kTileBytes + 8 * (1 + 2 * slots);
  }
  // k and v slots over rows of T keys (ops/block_fused.py::attn_bwd_slots
  // mirrors this): the whole row, resident, where it fits; else as many as
  // fit, each walk streaming the row through them
  static int slots(int T) {
    if (smem(key_blocks(T)) <= kSmemPerBlock) return key_blocks(T);
    int n = 2;
    while (smem(n + 1) <= kSmemPerBlock) ++n;
    return n;
  }
  static_assert(smem(2) <= kSmemPerBlock, "two slots fit");
};

// Shared memory of the key-tile kernel: the consumers' k and v tiles,
// kStages q and do tiles, kStages (m, l, D) rows, then the mbarriers (k/v
// full; per stage loaded, ready and empty)
template <int D>
struct KvPlan {
  static constexpr size_t smem() {
    return 1024 + static_cast<size_t>(2 * kConsumers + 2 * kStages) * HeadTile<D>::kTileBytes +
           kStages * kStatBytes + 8 * (1 + 3 * kStages);
  }
  static_assert(smem() <= kSmemPerBlock, "the ring fits");
};

// What both kernels read and write besides the tensor maps: o [B*T, W]
// (bf16); the statistics m, l, D [B, H, T] (fp32); dqkv and dqkv_r [B*T,
// 3W] (fp32, bf16)
struct Args {
  bf16* o;
  float *st_m, *st_l, *st_d;
  float* dqkv;
  bf16* dqkv_r;
  int W, T, H, n_pairs, causal, slots;
  float scale_q;  // the scale rounded to bf16: q's
  float scale;    // the fp32 scale: dq's
};

// Accumulator element e of a thread (lane, warp w of its warpgroup) in an
// m64nN product: row 16 w + lane / 4 + 8 ((e / 2) % 2), column 8 (e / 4) +
// 2 (lane % 4) + e % 2 (attn_sm90.cuh).
__device__ __forceinline__ int acc_row(int r0, int e) { return r0 + 8 * ((e / 2) % 2); }
__device__ __forceinline__ int acc_col(int c0, int e) { return 8 * (e / 4) + c0 + e % 2; }

// fence_acc over an m64n(D) accumulator pair: columns [0, 64) (none at D =
// 16), and at D = 80 and 16 the m64n16 of the 16 columns after them
template <int D>
__device__ __forceinline__ void fence_out(float (&o)[32], float (&o2)[8]) {
  if constexpr (HeadTile<D>::kWide > 0) fence_acc(o);
  if constexpr (HeadTile<D>::kSplit) fence_acc(o2);
}

// rows [0, 64) of an m64n(D) accumulator pair (o: columns [0, 64); o2: the
// 16 after them, all of them at D = 16) below ``rows`` into out[row * ld +
// c], c over the head's D columns: fp32 pairs (times ``mul``)
// and, where out_r is given, the same rounded to bf16 pairs at the same
// offsets of out_r; or bf16 pairs only (out == nullptr)
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[32], const float (&o2)[8], float mul, int r0, int c0,
                                           int rows, size_t ld, float* out, bf16* out_r) {
  using HT = HeadTile<D>;
  auto put = [=](int e, int col0, float x, float y) {
    const int r = acc_row(r0, e);
    if (r >= rows) return;
    const size_t off = static_cast<size_t>(r) * ld + col0 + acc_col(c0, e);
    if (out != nullptr) *reinterpret_cast<float2*>(out + off) = make_float2(x * mul, y * mul);
    if (out_r != nullptr) *reinterpret_cast<__nv_bfloat162*>(out_r + off) = __floats2bfloat162_rn(x * mul, y * mul);
  };
  if constexpr (HT::kWide > 0) {
#pragma unroll
    for (int e = 0; e < 32; e += 2) put(e, 0, o[e], o[e + 1]);
  }
  if constexpr (HT::kSplit) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) put(e, HT::kWide, o2[e], o2[e + 1]);
  }
}

// -- 1. per query tile: the statistics, o and dq ------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_q_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mx2,
                      const __grid_constant__ CUtensorMap mdo, const __grid_constant__ CUtensorMap mdo2,
                      const Args a) {
  constexpr uint32_t kTB = HeadTile<D>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int ns = a.slots;
  auto q_tile = [base](int w) { return base + w * kTB; };
  auto do_tile = [base](int w) { return base + (kConsumers + w) * kTB; };
  auto k_tile = [base](int s) { return base + (2 * kConsumers + s) * kTB; };
  auto v_tile = [base, ns](int s) { return base + (2 * kConsumers + ns + s) * kTB; };
  const uint32_t bars = base + (2 * kConsumers + 2 * ns) * kTB;
  const uint32_t q_full = bars;
  auto full = [bars](int s) { return bars + 8u * (1 + s); };
  auto empty = [bars, ns](int s) { return bars + 8u * (1 + ns + s); };

  // this block: query tiles 2 pair and 2 pair + 1 of head h of sequence seq
  const int pair = blockIdx.x % a.n_pairs, rest = blockIdx.x / a.n_pairs;
  const int h = rest % a.H, seq = rest / a.H;
  const int T = a.T, W = a.W, causal = a.causal, n_tiles = key_blocks(T), qt0 = kConsumers * pair;
  const int n_active = min(kConsumers, n_tiles - qt0);  // the second tile may lie past T
  const int n_kb = causal ? min(qt0 + n_active, n_tiles) : n_tiles;  // key blocks the block reads
  const bool resident = n_kb <= ns;  // k and v loaded once and read by both walks
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ns; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), n_active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // both walks read k and v of every key block. Streaming, use u = walk n_kb
  // + kb of a ring sits in slot u % ns, its (u / ns)-th fill; resident, the
  // second walk reads the first's fills again
  auto slot = [resident, n_kb, ns](int kb, int walk) { return resident ? kb : (walk * n_kb + kb) % ns; };
  auto fill = [resident, n_kb, ns](int kb, int walk) { return resident ? 0 : (walk * n_kb + kb) / ns; };

  if (wg == kConsumers) {
    // producer: one thread keeps the k and v slots filled ahead of the walks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers * 128) return;
    const int cq = h * D, ck = W + h * D, cv = 2 * W + h * D;
    mbar_expect_tx(q_full, 2 * n_active * kTB);
    for (int w = 0; w < n_active; ++w) {
      load_tile<D>(q_tile(w), &mx, &mx2, cq, (qt0 + w) * kTile, seq, q_full);
      load_tile<D>(do_tile(w), &mdo, &mdo2, cq, (qt0 + w) * kTile, seq, q_full);
    }
    for (int walk = 0; walk < (resident ? 1 : 2); ++walk) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = slot(kb, walk), f = fill(kb, walk);
        if (f > 0) mbar_wait(empty(s), (f - 1) & 1);
        mbar_expect_tx(full(s), 2 * kTB);
        load_tile<D>(k_tile(s), &mx, &mx2, ck, kb * kTile, seq, full(s));
        load_tile<D>(v_tile(s), &mx, &mx2, cv, kb * kTile, seq, full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  if (wg >= n_active) return;  // a tile past T

  // consumer: warpgroup wg owns query rows [i0, i0 + 64)
  const int qt = qt0 + wg, i0 = qt * kTile;
  const int my_kb = causal ? qt + 1 : n_tiles;  // key blocks this tile sees
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t q = q_tile(wg), dO = do_tile(wg);

  mbar_wait(q_full, 0);
  scale_tile<D>(smem + wg * kTB, a.scale_q, t, 128);
  fence_async_shared();
  named_bar_sync(1 + wg, 128);

  // key j is in row i's softmax; a key block needs the test past T and on
  // the causal diagonal
  auto visible = [causal, T](int i, int j) { return j < T && !(causal && j > i); };
  auto edge = [causal, T, qt](int kb) { return (kb + 1) * kTile > T || (causal && kb == qt); };
  auto shown = [&](int kb, int e) { return visible(i0 + acc_row(r0, e), kb * kTile + acc_col(c0, e)); };
  // k and v of key block kb read for the last time in a walk
  auto release = [&](int kb, int walk) {
    if (!resident && t == 0) mbar_arrive(empty(slot(kb, walk)));
  };
  // s = q k^T and dp = do v^T for key block kb, issued and committed
  auto issue_s_dp = [&](float (&s)[32], float (&dp)[32], int kb, int walk) {
    const int sl = slot(kb, walk);
    mbar_wait(full(sl), fill(kb, walk) & 1);
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    issue_ss<D>(s, q, k_tile(sl));
    issue_ss<D>(dp, dO, v_tile(sl));
    wgmma_commit();
  };
  // key blocks past the causal diagonal: the slots' turns only
  auto skip = [&](int walk) {
    for (int kb = my_kb; kb < n_kb; ++kb) {
      mbar_wait(full(slot(kb, walk)), fill(kb, walk) & 1);
      release(kb, walk);
    }
  };

  // walk 0: the max m, the sum l and D = rowsum(dpn pn) of rows r0 and r0 +
  // 8 over this thread's columns, online: l and the unnormalised sum of dpn
  // exp(s - m) are rescaled when m rises; then combined over the quad, D =
  // sum / l.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  auto online = [&](const float (&s)[32], const float (&dp)[32], int kb) {
    const bool masked = edge(kb);
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (!masked || shown(kb, e)) bm[(e / 2) % 2] = fmaxf(bm[(e / 2) % 2], s[e]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float mn = fmaxf(m[hr], bm[hr]);
      if (mn != m[hr]) {  // from m = -inf: l = dsum = 0 stay 0
        const float c = ex(m[hr] - mn);
        l[hr] *= c;
        dsum[hr] *= c;
        m[hr] = mn;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (masked && !shown(kb, e)) continue;
      const int hr = (e / 2) % 2;
      const float p = ex(s[e] - m[hr]);
      l[hr] += p;
      dsum[hr] += dp[e] * p;
    }
  };
  float sa[32], da[32];
  for (int kb = 0; kb < my_kb; ++kb) {
    issue_s_dp(sa, da, kb, 0);
    wgmma_wait<0>();
    fence_acc(sa);
    fence_acc(da);
    online(sa, da, kb);
    release(kb, 0);
  }
  skip(0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mq = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    const float c = m[hr] == mq ? 1.f : ex(m[hr] - mq);
    float lq = l[hr] * c, dq_ = dsum[hr] * c;
    lq += __shfl_xor_sync(0xffffffffu, lq, 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    dq_ += __shfl_xor_sync(0xffffffffu, dq_, 1);
    dq_ += __shfl_xor_sync(0xffffffffu, dq_, 2);
    m[hr] = mq;
    l[hr] = lq;
    dsum[hr] = dq_ / lq;
  }

  // walk 1: pn = exp(s - m) / l and ds = pn (dpn - D), then o += round(pn) . v
  // and dq += round(ds) . k; block kb + 1's s and dpn are issued behind block
  // kb's two register-A products
  float o[32], o2[8], dq[32], dq2[8];
  uint32_t pp[16], pds[16];
  const float rl[2] = {1.f / l[0], 1.f / l[1]};
  issue_s_dp(sa, da, 0, 1);
  wgmma_wait<0>();
  fence_acc(sa);
  fence_acc(da);
  for (int kb = 0; kb < my_kb; ++kb) {
    const bool masked = edge(kb);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hr = (e / 2) % 2;
      float p = ex(sa[e] - m[hr]) * rl[hr];
      if (masked && !shown(kb, e)) p = 0.f;
      da[e] = p * (da[e] - dsum[hr]);
      sa[e] = p;
    }
    pack_a(pp, sa);
    pack_a(pds, da);
    const int sl = slot(kb, 1);
    fence_out<D>(o, o2);
    fence_out<D>(dq, dq2);
    wgmma_fence();
    issue_rs<D>(o, o2, pp, v_tile(sl), kb > 0);
    issue_rs<D>(dq, dq2, pds, k_tile(sl), kb > 0);
    wgmma_commit();
    if (kb + 1 < my_kb) issue_s_dp(sa, da, kb + 1, 1);
    wgmma_wait<0>();
    fence_out<D>(o, o2);
    fence_out<D>(dq, dq2);
    fence_acc(sa);
    fence_acc(da);
    release(kb, 1);
  }
  skip(1);

  const size_t row0 = static_cast<size_t>(seq) * T + i0;  // the tile's first row of the [B*T, *] arrays
  const size_t ld = 3 * static_cast<size_t>(W);
  store_rows<D>(o, o2, 1.f, r0, c0, T - i0, W, nullptr, a.o + row0 * W + h * D);
  store_rows<D>(dq, dq2, a.scale, r0, c0, T - i0, ld, a.dqkv + row0 * ld + h * D,
                a.dqkv_r + row0 * ld + h * D);
  if (lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = i0 + r0 + 8 * hr;
      if (i < T) {
        const size_t at = (static_cast<size_t>(seq) * a.H + h) * T + i;
        a.st_m[at] = m[hr];
        a.st_l[at] = l[hr];
        a.st_d[at] = dsum[hr];
      }
    }
  }
}

// -- 2. per key tile: dk and dv ------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_kv_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mx2,
                       const __grid_constant__ CUtensorMap mdo, const __grid_constant__ CUtensorMap mdo2,
                       const Args a) {
  constexpr uint32_t kTB = HeadTile<D>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  auto k_tile = [base](int w) { return base + w * kTB; };
  auto v_tile = [base](int w) { return base + (kConsumers + w) * kTB; };
  auto q_tile = [base](int s) { return base + (2 * kConsumers + s) * kTB; };
  auto do_tile = [base](int s) { return base + (2 * kConsumers + kStages + s) * kTB; };
  float* stats = reinterpret_cast<float*>(smem + (2 * kConsumers + 2 * kStages) * kTB);  // [kStages][3][64]
  const uint32_t bars = base + (2 * kConsumers + 2 * kStages) * kTB + kStages * kStatBytes;
  const uint32_t kv_full = bars;
  auto loaded = [bars](int s) { return bars + 8u * (1 + s); };
  auto ready = [bars](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [bars](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  // this block: key tiles 2 pair and 2 pair + 1 of head h of sequence seq,
  // over the query tiles from qt_begin
  const int pair = blockIdx.x % a.n_pairs, rest = blockIdx.x / a.n_pairs;
  const int h = rest % a.H, seq = rest / a.H;
  const int T = a.T, W = a.W, causal = a.causal, n_tiles = key_blocks(T), kt0 = kConsumers * pair;
  const int n_active = min(kConsumers, n_tiles - kt0);
  const int qt_begin = causal ? kt0 : 0, n_q = n_tiles - qt_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(ready(s), 32);
      mbar_init(empty(s), n_active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer warp (the first of its warpgroup): lane 0 issues the TMA
    // loads; every lane copies a share of the stage's statistics and, once
    // the stage has landed, scales a share of its q tile, then arrives on
    // the stage's ready barrier. Loads run kLag tiles ahead of the scaling.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    constexpr int kLag = kStages / 2;
    const int lane = threadIdx.x % 32;
    const int cq = h * D, ck = W + h * D, cv = 2 * W + h * D;
    const size_t st_row = (static_cast<size_t>(seq) * a.H + h) * T;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * n_active * kTB);
      for (int w = 0; w < n_active; ++w) {
        load_tile<D>(k_tile(w), &mx, &mx2, ck, (kt0 + w) * kTile, seq, kv_full);
        load_tile<D>(v_tile(w), &mx, &mx2, cv, (kt0 + w) * kTile, seq, kv_full);
      }
    }
    for (int it = 0; it < n_q + kLag; ++it) {
      if (it < n_q) {
        const int s = it % kStages, fill = it / kStages, i0 = (qt_begin + it) * kTile;
        if (fill > 0) mbar_wait(empty(s), (fill - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(loaded(s), 2 * kTB);
          load_tile<D>(q_tile(s), &mx, &mx2, cq, i0, seq, loaded(s));
          load_tile<D>(do_tile(s), &mdo, &mdo2, cq, i0, seq, loaded(s));
        }
        // rows past T: m 0, l 1, D 0 (their q and do rows are TMA's zeros)
        float* st = stats + s * 3 * kTile;
        for (int r = lane; r < kTile; r += 32) {
          const int i = i0 + r;
          st[r] = i < T ? a.st_m[st_row + i] : 0.f;
          st[kTile + r] = i < T ? a.st_l[st_row + i] : 1.f;
          st[2 * kTile + r] = i < T ? a.st_d[st_row + i] : 0.f;
        }
      }
      if (it >= kLag) {
        const int j = it - kLag, s = j % kStages;
        mbar_wait(loaded(s), (j / kStages) & 1);
        scale_tile<D>(smem + (2 * kConsumers + s) * kTB, a.scale_q, lane, 32);
        fence_async_shared();
        mbar_arrive(ready(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  if (wg >= n_active) return;  // a tile past T

  // consumer: warpgroup wg owns keys [j0, j0 + 64); the accumulators' rows are keys, their columns queries
  const int kt = kt0 + wg, j0 = kt * kTile;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t k = k_tile(wg), v = v_tile(wg);
  const int it_first = causal ? kt - qt_begin : 0;  // the first query tile at or below the diagonal
  mbar_wait(kv_full, 0);

  float sT[32], dpT[32], dk[32], dk2[8], dv[32], dv2[8];
  uint32_t pp[16], pds[16];
  // s^T = k q^T and dpn^T = v do^T for query tile it, issued and committed
  auto issue_scores = [&](int it) {
    const int s = it % kStages;
    mbar_wait(ready(s), (it / kStages) & 1);
    fence_acc(sT);
    fence_acc(dpT);
    wgmma_fence();
    issue_ss<D>(sT, k, q_tile(s));
    issue_ss<D>(dpT, v, do_tile(s));
    wgmma_commit();
  };
  for (int it = 0; it < it_first; ++it) {  // query tiles above the causal diagonal: the stages' turns only
    mbar_wait(ready(it % kStages), (it / kStages) & 1);
    if (t == 0) mbar_arrive(empty(it % kStages));
  }
  issue_scores(it_first);
  wgmma_wait<0>();
  fence_acc(sT);
  fence_acc(dpT);
  for (int it = it_first; it < n_q; ++it) {
    const int s = it % kStages, qt = qt_begin + it, i0 = qt * kTile;
    const float* st = stats + s * 3 * kTile;
    const bool masked = (qt + 1) * kTile > T || (kt + 1) * kTile > T || (causal && qt == kt);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int c = 8 * cc + c0;  // the query columns c and c + 1 of elements 4 cc .. 4 cc + 3
      const float2 mm = *reinterpret_cast<const float2*>(st + c);
      const float2 ll = *reinterpret_cast<const float2*>(st + kTile + c);
      const float2 dd = *reinterpret_cast<const float2*>(st + 2 * kTile + c);
      const float rl[2] = {1.f / ll.x, 1.f / ll.y};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = 4 * cc + x, i = i0 + c + x % 2, j = j0 + r0 + 8 * (x / 2);
        float p = ex(sT[e] - (x % 2 ? mm.y : mm.x)) * rl[x % 2];
        if (masked && !(i < T && j < T && !(causal && j > i))) p = 0.f;
        dpT[e] = p * (dpT[e] - (x % 2 ? dd.y : dd.x));
        sT[e] = p;
      }
    }
    pack_a(pp, sT);
    pack_a(pds, dpT);
    fence_out<D>(dv, dv2);
    fence_out<D>(dk, dk2);
    wgmma_fence();
    issue_rs<D>(dv, dv2, pp, do_tile(s), it > it_first);
    issue_rs<D>(dk, dk2, pds, q_tile(s), it > it_first);
    wgmma_commit();
    if (it + 1 < n_q) issue_scores(it + 1);
    wgmma_wait<0>();
    fence_out<D>(dv, dv2);
    fence_out<D>(dk, dk2);
    fence_acc(sT);
    fence_acc(dpT);
    if (t == 0) mbar_arrive(empty(s));
  }
  const size_t ld = 3 * static_cast<size_t>(W), row0 = static_cast<size_t>(seq) * T + j0;
  float* out = a.dqkv + row0 * ld + h * D;
  bf16* out_r = a.dqkv_r + row0 * ld + h * D;
  store_rows<D>(dk, dk2, 1.f, r0, c0, T - j0, ld, out + W, out_r + W);
  store_rows<D>(dv, dv2, 1.f, r0, c0, T - j0, ld, out + 2 * W, out_r + 2 * W);
}

template <int D>
int launch(const bf16* qkv, const bf16* dout, bf16* o, float* st, float* dqkv, bf16* dqkv_r, int B, int T, int W,
           int H, int causal, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mx, mx2, mdo, mdo2;
  if (!attn90::encode_head_maps<D>(encode, &mx, &mx2, qkv, B, T, 3 * W) ||
      !attn90::encode_head_maps<D>(encode, &mdo, &mdo2, dout, B, T, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pairs = (key_blocks(T) + kConsumers - 1) / kConsumers, slots = QPlan<D>::slots(T);
  const size_t n = static_cast<size_t>(B) * H * T;
  const Args args{o, st, st + n, st + 2 * n, dqkv, dqkv_r, W, T, H, n_pairs, causal, slots,
                  attn90::round_bf16(scale), scale};
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(n_pairs) * H * B);
  const size_t smem_q = QPlan<D>::smem(slots), smem_kv = KvPlan<D>::smem();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemPerBlock));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_q_kernel<D><<<blocks, kThreads, smem_q, stream>>>(mx, mx2, mdo, mdo2, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kv_kernel<D><<<blocks, kThreads, smem_kv, stream>>>(mx, mx2, mdo, mdo2, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd90

// K5a's bf16 attention backward on the packed qkv [B*T, 3W] and do [B*T,
// W]: o [B*T, W], st [3, B, H, T], dqkv (fp32) and dqkv_r (bf16) [B*T, 3W].
// -1 for a shape or an alignment the kernels do not take, else a CUDA error
// code. A template (of T = bf16 only), so that a library that includes this
// header but runs no backward does not compile the kernels.
template <typename E>
int launch_attn_bwd_sm90(const E* qkv, const E* dout, E* o, float* st, float* dqkv, E* dqkv_r, int B, int T, int W,
                         int H, int causal, float scale, cudaStream_t stream) {
  static_assert(std::is_same<E, bf16>::value, "the wgmma backward is bf16 only");
  if (H < 1 || W % H != 0 || !attn_bwd90::takes_head_dim(W / H) || !attn90::takes(B, T, H, W / H) || W % 8 != 0)
    return -1;
  if (dqkv_r == nullptr || !aligned16(qkv) || !aligned16(dout) || !aligned16(o) || !aligned16(dqkv) ||
      !aligned16(dqkv_r))
    return -1;
  return attn90::dispatch(W / H, [&](auto d) {
    return attn_bwd90::launch<decltype(d)::value>(qkv, dout, o, st, dqkv, dqkv_r, B, T, W, H, causal, scale,
                                                   stream);
  });
}

}  // namespace evr

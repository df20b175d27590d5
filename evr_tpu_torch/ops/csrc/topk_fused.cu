// K4: fused streaming score + top-k over a row range of the frame index,
//     written for Hopper: scores [Q, rows] = (q . row) * row_scale, rows
//     outside [start, end) at -inf, and each block's top kc by (score
//     descending, row ascending) over its run of rows; ops/retrieval.py
//     merges the blocks' lists.
//
// Replaces: evr_tpu/ops/retrieval_pallas.py::fused_topk (Pallas kernel body
// _topk_tile_kernel). What it reproduces: int8 and bf16 rows are scored
// against the queries rounded to bf16 and fp32 rows against fp32 queries,
// products and sums in fp32 (no TF32), the per-row dequantisation scale
// applied after the sum, the [start, end) mask, and ties to the lower row
// (the TPU kernel's first-argmax). Each score is summed over the embedding
// dimension in order, one product and one rounded sum per element
// (__fmul_rn/__fadd_rn; for int8 rows one __fmaf_rn, the same bits, since a
// bf16 query times an int8 value is exact in fp32), then times the row's
// scale, then + 0 (-0 sorts as +0, as in PyTorch). The plain PyTorch version
// in ops/retrieval.py sums in the same order, so the two give the same bits.
// Like the TPU kernel it reads each row once and keeps only candidates out
// of device memory.
//
// Bound on an H100 SXM: memory. At the main-path shape of the chip smoke
// run, 1,048,576 int8 rows of 512 with Q = 1, the kernel must read 512 MiB
// of rows and 4 MiB of scales: 161 us at 3.35 TB/s. Its operations (0.5 G
// fp32 fused multiply-adds on the CUDA cores) take about a third of that.
//
// Design:
//   - a persistent grid of about one block per SM (ops/retrieval.py::
//     topk_plan mirrors the plan): block b walks a contiguous run of
//     tiles_per_block tiles of 1,024 rows, scoring only its rows inside
//     [start, end);
//   - one producer thread keeps a ring of up to kMaxStages stages of 16 KB
//     in flight by TMA (cp.async.bulk.tensor.2d over the index viewed as
//     bytes [N, D * element], boxes of 32 rows x 128 bytes under the
//     128-byte swizzle, zeros past the last row): a stage is one 32-row
//     group's 512-byte slice of its rows, so a row of any width streams
//     through the same stages, slice after slice, its sum carried in
//     registers;
//   - eight consumer warps, one 32-row group each a round, one row a lane,
//     in step: a named barrier after each slice, so the eight units a step
//     waits for lie within the ring's stages (at least eight) and no wait
//     can see a stage's parity from two fills back;
//     each lane reads its row's 16-byte chunks in order, through the
//     swizzle (eight rows' chunk c fall in distinct banks), and the queries
//     as float4 broadcasts from shared memory ([D][QC], QC = 1, 4 or 8
//     queries a pass; more queries take more passes over the rows). int8 is
//     converted exactly without the I2F pipe: the byte, biased by 128, is
//     placed by __byte_perm into the mantissa of 2^23 and 2^23 + 128 is
//     subtracted; bf16 is a 16-bit shift;
//   - selection per query in shared memory: a sorted list of the block's
//     best kc keys (64-bit, ascending = score descending then row
//     ascending) whose kc-th key is the threshold, and a candidate buffer
//     behind it. A lane whose key beats the threshold takes a slot (one
//     shared atomicAdd a warp); after each round, when the buffer could
//     overflow in the next one, and at the end, the consumers sort list and
//     buffer together (bitonic) and keep kc. Keys are a total order, so the
//     list does not depend on the order in which candidates arrive;
//   - rows of the block outside [start, end) are never read: they score
//     -inf, so they enter a list only after every scored row, lowest rows
//     first, and the block writes them so where its list has room. Only the
//     last block can hold fewer than kc rows; its empty slots are (-inf,
//     -1) and sort after every real candidate, so they never reach the top
//     k. k > 1,024 (kc = 1,024) takes one tile a block, whose list then
//     holds every row.
// The candidates are [Q, n_blocks, kc], blocks in row order and each list
// best first, so the merge's stable sort keeps the ties' row order.

#include <algorithm>
#include <cstdint>

#include "sm90.cuh"

namespace evr {
namespace topk90 {

using namespace sm90;

constexpr int kTile = 1024;                       // rows of a plan tile (ops/retrieval.py TILE_ROWS)
constexpr int kGroup = 32;                        // rows of a stage: one a lane of a consumer warp
constexpr int kSlice = 512;                       // bytes of each row a stage holds
constexpr int kBox = 128;                         // a TMA box's width in bytes: one swizzle line
constexpr uint32_t kBoxSize = kGroup * kBox;     // 4 KB
constexpr uint32_t kStageBytes = kGroup * kSlice;  // 16 KB
constexpr int kWarps = 8;                         // consumer warps
constexpr int kBlockThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kRound = kWarps * kGroup;           // rows scored between two selection steps
constexpr int kMaxStages = 12;
constexpr int kMaxCap = 2048;                     // keys of a query's list and buffer, at most
constexpr int kTargetBlocks = 132;                // one block on each SM of an H100
constexpr long long kSmemLimit = 232448;          // the most one block may take (227 KB)
constexpr unsigned long long kAbsent = ~0ull;

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

// -- the plan (ops/retrieval.py::topk_plan mirrors it) ---------------------------

struct Plan {
  int qc;               // queries a pass
  int kc;               // keys a block keeps for each query: min(k, kTile)
  int tiles_per_block;  // tiles of kTile rows a block walks
  int n_blocks;
  int cap;              // keys of a query's list and buffer in shared memory
  int stages;           // ring stages
  long long smem;       // dynamic shared memory of a block
};

inline int queries_per_pass(int Q) { return Q == 1 ? 1 : Q <= 4 ? 4 : 8; }

// the 1,024-byte alignment slack, the ring stages and their two mbarriers,
// the lists and buffers, the buffer counts (8 ints), the queries [D][qc]
inline long long smem_bytes(int qc, int D, int cap, int stages) {
  return 1024 + static_cast<long long>(stages) * (kStageBytes + 16) + static_cast<long long>(qc) * cap * 8 + 32 +
         static_cast<long long>(qc) * D * 4;
}

// N rows of D elements, Q queries, top k: false for a shape not taken. The
// buffer behind a list keeps room for one round (kRound keys); cap is cut
// from kMaxCap while that holds and the ring is short of kMaxStages. The
// ring needs a stage for each consumer warp (the walk below): where the
// lists and queries of qc queries leave fewer, a pass takes fewer queries.
inline bool make_plan(int N, int D, int Q, int k, Plan* p) {
  if (N < 1 || D < 16 || D % 16 != 0 || D > 2048 || Q < 1 || k < 1 || k > N) return false;
  p->kc = std::min(k, kTile);
  const int n_tiles = (N + kTile - 1) / kTile;
  p->tiles_per_block = k > kTile ? 1 : (n_tiles + kTargetBlocks - 1) / kTargetBlocks;
  p->n_blocks = (n_tiles + p->tiles_per_block - 1) / p->tiles_per_block;
  auto stages_for = [&](int cap) {
    const long long room = kSmemLimit - smem_bytes(p->qc, D, cap, 0);
    return static_cast<int>(std::max(0LL, std::min<long long>(kMaxStages, room / (kStageBytes + 16))));
  };
  for (p->qc = queries_per_pass(Q);; p->qc = p->qc == 8 ? 4 : 1) {
    int cap = kMaxCap;
    while (cap / 2 >= p->kc + kRound && stages_for(cap) < kMaxStages) cap /= 2;
    p->cap = cap;
    p->stages = stages_for(cap);
    if (p->stages >= kWarps || p->qc == 1) break;
  }
  p->smem = smem_bytes(p->qc, D, p->cap, p->stages);
  return p->stages >= kWarps;
}

// -- the kernel ------------------------------------------------------------------

struct Args {
  const float* q;       // [Q, D] prepared queries
  const float* scales;  // [N] or null
  float* cand_s;        // [Q, n_blocks, kc]
  int* cand_r;
  int N, D, Q, start, end, kc, cap, stages, rows_per_block, n_blocks;
};

// the fp32 values of a 16-byte chunk's elements, exactly
__device__ __forceinline__ void decode(const uint4 raw, float (&v)[16], int8_t) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)  // [b + 128, 0, 0, 0x4B] is 2^23 + b + 128
      v[4 * i + b] = __fsub_rn(__uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | b)), 8388736.f);
}

__device__ __forceinline__ void decode(const uint4 raw, float (&v)[8], bf16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void decode(const uint4 raw, float (&v)[4], float) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

// acc + q v, rounded once where the product is exact (a bf16 query times an
// int8 value), else the product rounded and then the sum
template <typename T>
__device__ __forceinline__ float step(float acc, float q, float v) {
  if constexpr (std::is_same<T, int8_t>::value)
    return __fmaf_rn(q, v, acc);
  else
    return __fadd_rn(acc, __fmul_rn(q, v));
}

// acc[qi] over one stage: this lane's row r, chunks [0, chunks) of its slice
// in order; q points at the slice's first element's queries ([element][QC])
template <typename T, int QC>
__device__ __forceinline__ void score_slice(float (&acc)[QC], const unsigned char* stage, int chunks,
                                            const float* q, int r) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  const unsigned char* line = stage + r * kBox;
  for (int c = 0; c < chunks; ++c) {
    // chunk c: box c / 8, 16-byte unit c % 8 of the row's line, swizzled by the row's phase r % 8
    const uint4 raw = *reinterpret_cast<const uint4*>(line + (c >> 3) * kBoxSize + (((c & 7) ^ (r & 7)) << 4));
    float v[E];
    decode(raw, v, T{});
    const float4* qc = reinterpret_cast<const float4*>(q + c * E * QC);
#pragma unroll
    for (int e0 = 0; e0 < E; e0 += 4) {
      float qv[4 * QC];
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        const float4 f = qc[e0 * QC / 4 + i];
        qv[4 * i] = f.x;
        qv[4 * i + 1] = f.y;
        qv[4 * i + 2] = f.z;
        qv[4 * i + 3] = f.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int qi = 0; qi < QC; ++qi) acc[qi] = step<T>(acc[qi], qv[e * QC + qi], v[e0 + e]);
    }
  }
}

// keys[0, P) sorted ascending, P a power of two, by the kRound consumer
// threads (tid), a named barrier after each stage
__device__ __forceinline__ void bitonic(unsigned long long* keys, int P, int tid) {
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += kRound) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      named_bar_sync(1, kRound);
    }
}

template <typename T, int QC, bool kSelect>
__global__ void __launch_bounds__(kBlockThreads, 1) topk_kernel(const __grid_constant__ CUtensorMap rows, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int ns = a.stages, cap = a.cap, kc = a.kc;
  const uint32_t bars = base + ns * kStageBytes;
  auto full = [bars](int s) { return bars + 8u * s; };
  auto empty = [bars, ns](int s) { return bars + 8u * (ns + s); };
  unsigned long long* sel = reinterpret_cast<unsigned long long*>(smem + ns * (kStageBytes + 16));  // [QC][cap]
  int* cnt = reinterpret_cast<int*>(sel + QC * cap);  // buffer counts [QC]
  float* sq = reinterpret_cast<float*>(cnt + 8);      // queries [D][QC]

  // this block: rows [b0, b1), of which [lo, hi) lie in [start, end) and are
  // scored, in 32-row groups [g_lo, g_hi); each group's rows in n_slices
  // slices of 512 bytes
  const int RB = a.D * static_cast<int>(sizeof(T));
  const int n_slices = (RB + kSlice - 1) / kSlice;
  const int b0 = blockIdx.x * a.rows_per_block, b1 = min(b0 + a.rows_per_block, a.N);
  const int lo = min(max(a.start, b0), b1), hi = max(min(a.end, b1), lo);
  const int g_lo = lo / kGroup, n_groups = hi > lo ? (hi + kGroup - 1) / kGroup - g_lo : 0;
  const int n_rounds = (n_groups + kWarps - 1) / kWarps;
  const int n_pass = (a.Q + QC - 1) / QC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The units, in the order both sides walk them: per pass, per round, per
  // slice, the round's groups in warp order; unit u sits in stage u % ns,
  // its (u / ns)-th fill.
  if (warp == kWarps) {
    if (lane != 0) return;
    int u = 0;
    for (int p = 0; p < n_pass; ++p)
      for (int rd = 0; rd < n_rounds; ++rd) {
        const int nw = min(kWarps, n_groups - rd * kWarps);
        for (int s = 0; s < n_slices; ++s) {
          const int c0 = s * kSlice, boxes = (min(kSlice, RB - c0) + kBox - 1) / kBox;
          for (int w = 0; w < nw; ++w, ++u) {
            const int slot = u % ns, fill = u / ns;
            if (fill > 0) mbar_wait(empty(slot), (fill - 1) & 1);
            mbar_expect_tx(full(slot), boxes * kBoxSize);
            const int row = (g_lo + rd * kWarps + w) * kGroup;
            for (int b = 0; b < boxes; ++b)
              tma_load_2d(base + slot * kStageBytes + b * kBoxSize, &rows, full(slot), c0 + b * kBox, row);
          }
        }
      }
    return;
  }

  // consumers: warp w scores group g_lo + rd * kWarps + w of round rd, lane l its row l
  const int tid = threadIdx.x;
  int u = 0;
  for (int p = 0; p < n_pass; ++p) {
    const int q0 = p * QC, nq = min(QC, a.Q - q0);
    if (p > 0) named_bar_sync(1, kRound);  // the last pass's lists are written out
    for (int i = tid; i < QC * a.D; i += kRound) {
      const int j = i / QC, qi = i % QC;
      sq[i] = qi < nq ? a.q[static_cast<size_t>(q0 + qi) * a.D + j] : 0.f;
    }
    for (int i = tid; i < QC * cap; i += kRound) sel[i] = kAbsent;
    if (tid < QC) cnt[tid] = 0;
    named_bar_sync(1, kRound);

    unsigned long long best[QC];  // the scan-only variant's least key a query
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) best[qi] = kAbsent;
    for (int rd = 0; rd < n_rounds; ++rd) {
      const int nw = min(kWarps, n_groups - rd * kWarps);
      const bool have = warp < nw;
      float acc[QC];
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) acc[qi] = 0.f;
      for (int s = 0; s < n_slices; ++s) {
        if (have) {
          const int unit = u + warp, slot = unit % ns;
          mbar_wait(full(slot), (unit / ns) & 1);
          const int chunks = min(kSlice, RB - s * kSlice) / 16;
          score_slice<T, QC>(acc, smem + slot * kStageBytes, chunks,
                             sq + (s * kSlice / static_cast<int>(sizeof(T))) * QC, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(slot));
        }
        u += nw;
        // the step's units are consumed before any warp waits on the next
        // step's: a stage's full barrier then never runs two fills ahead of
        // a waiting warp, whose parity wait would pass on the older fill
        named_bar_sync(1, kRound);
      }
      if (have) {
        const int row = (g_lo + rd * kWarps + warp) * kGroup + lane;
        const bool valid = row >= lo && row < hi;
        const float scale = a.scales != nullptr && valid ? a.scales[row] : 1.f;
#pragma unroll
        for (int qi = 0; qi < QC; ++qi) {
          if (qi >= nq) break;
          float sc = a.scales != nullptr ? __fmul_rn(acc[qi], scale) : acc[qi];
          sc = __fadd_rn(sc, 0.f);  // -0 -> +0: the two zeros sort as equal, as in PyTorch
          const unsigned long long key = sort_key(sc, row);
          if constexpr (!kSelect) {
            if (valid) best[qi] = min(best[qi], key);
          } else {
            const bool in = valid && key < sel[qi * cap + kc - 1];
            const unsigned mask = __ballot_sync(0xffffffffu, in);
            if (mask != 0) {
              const int leader = __ffs(mask) - 1;
              int at = 0;
              if (lane == leader) at = atomicAdd(&cnt[qi], __popc(mask));
              at = __shfl_sync(0xffffffffu, at, leader);
              if (in) sel[qi * cap + kc + at + __popc(mask & ((1u << lane) - 1u))] = key;
            }
          }
        }
      }
      if constexpr (kSelect) {
        // sort list and buffer together where the buffer could overflow in
        // the next round, and at the end of the walk
        named_bar_sync(1, kRound);
        const bool last = rd + 1 == n_rounds;
        int c[QC];
        bool any = false;
#pragma unroll
        for (int qi = 0; qi < QC; ++qi) {
          c[qi] = qi < nq ? cnt[qi] : 0;
          if (c[qi] > 0 && (last || c[qi] > cap - kc - kRound)) any = true;
          else c[qi] = 0;
        }
        if (any) {
          named_bar_sync(1, kRound);  // every count read before any is reset
#pragma unroll
          for (int qi = 0; qi < QC; ++qi) {
            if (c[qi] == 0) continue;
            unsigned long long* keys = sel + qi * cap;
            int P = 2;
            while (P < kc + c[qi]) P <<= 1;
            for (int i = kc + c[qi] + tid; i < P; i += kRound) keys[i] = kAbsent;
            if (tid == 0) cnt[qi] = 0;
            named_bar_sync(1, kRound);
            bitonic(keys, P, tid);
          }
        }
      }
    }

    // the block's lists: the scored rows' best keys, then its rows outside
    // [start, end) at -inf, lowest first, then (-inf, -1)
    if constexpr (!kSelect) {
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) {
        unsigned long long b = best[qi];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) b = min(b, __shfl_xor_sync(0xffffffffu, b, o));
        if (lane == 0 && qi < nq) atomicMin(&sel[qi * cap], b);
      }
      named_bar_sync(1, kRound);
    }
    const int n_real = kSelect ? min(kc, hi - lo) : 1;
    for (int qi = 0; qi < nq; ++qi)
      for (int i = tid; i < kc; i += kRound) {
        float s = -INFINITY;
        int r = -1;
        const unsigned long long key = sel[qi * cap + i];
        if (i < n_real && key != kAbsent) {
          s = key_score(key);
          r = static_cast<int>(key & 0xffffffffu);
        } else if (kSelect) {
          const int m = i - n_real;  // the m-th row of the block outside [start, end)
          if (m < lo - b0)
            r = b0 + m;
          else if (m - (lo - b0) < b1 - hi)
            r = hi + m - (lo - b0);
        }
        const size_t at = (static_cast<size_t>(q0 + qi) * a.n_blocks + blockIdx.x) * kc + i;
        a.cand_s[at] = s;
        a.cand_r[at] = r;
      }
  }
}

template <typename T, int QC, bool kSelect>
int launch_plan(const CUtensorMap& map, const Args& args, const Plan& p, cudaStream_t stream) {
  auto kernel = topk_kernel<T, QC, kSelect>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n_blocks, kBlockThreads, p.smem, stream>>>(map, args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSelect>
int topk(const void* index, const float* q, const float* scales, int N, int D, int Q, int start, int end, int k,
         float* cand_s, int* cand_r, cudaStream_t stream) {
  Plan p;
  if (!make_plan(N, D, Q, k, &p) || start < 0 || start > end || end > N || !aligned16(index)) return -1;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const int RB = D * static_cast<int>(sizeof(T));
  if (!encode_map(encode, &map, static_cast<const int8_t*>(index), N, RB, kGroup, kBox))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{q, scales, cand_s, cand_r, N, D, Q, start, end, p.kc, p.cap, p.stages,
                  p.tiles_per_block * kTile, p.n_blocks};
  if (p.qc == 1) return launch_plan<T, 1, kSelect>(map, args, p, stream);
  if (p.qc == 4) return launch_plan<T, 4, kSelect>(map, args, p, stream);
  return launch_plan<T, 8, kSelect>(map, args, p, stream);
}

template <bool kSelect>
int topk_dtype(int dtype, const void* index, const void* q, const void* scales, int N, int D, int Q, int start,
               int end, int k, void* cand_s, void* cand_r, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto sc = static_cast<const float*>(scales);
  auto cs = static_cast<float*>(cand_s);
  auto cr = static_cast<int*>(cand_r);
  if (dtype == 0) return topk<float, kSelect>(index, qf, sc, N, D, Q, start, end, k, cs, cr, s);
  if (dtype == 1) return topk<bf16, kSelect>(index, qf, sc, N, D, Q, start, end, k, cs, cr, s);
  if (dtype == 2) return topk<int8_t, kSelect>(index, qf, sc, N, D, Q, start, end, k, cs, cr, s);
  return -1;
}

}  // namespace topk90
}  // namespace evr

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16, 2 = int8
// rows; index [N, D], 16-byte aligned; q [Q, D] fp32 (already normalised,
// and rounded to bf16 for dtypes 1 and 2); scales [N] fp32 or null; cand_s /
// cand_r [Q, n_blocks, kc] with n_blocks and kc from evr_topk_plan. Returns
// 0, -1 for a shape or range the kernel does not take, or a CUDA error code.
extern "C" int evr_fused_topk(int dtype, const void* index, const void* q, const void* scales, int N, int D,
                              int Q, int start, int end, int k, void* cand_s, void* cand_r, void* stream) {
  return evr::topk90::topk_dtype<true>(dtype, index, q, scales, N, D, Q, start, end, k, cand_s, cand_r, stream);
}

// The same walk over the rows with no selection, for timing the scan apart
// from it: each block writes only its least key a query, in slot 0 of its
// list (the rest (-inf, -1)). No path calls it.
extern "C" int evr_fused_topk_scan(int dtype, const void* index, const void* q, const void* scales, int N, int D,
                                   int Q, int start, int end, int k, void* cand_s, void* cand_r, void* stream) {
  return evr::topk90::topk_dtype<false>(dtype, index, q, scales, N, D, Q, start, end, k, cand_s, cand_r, stream);
}

// The plan of a call: out = (n_blocks, tiles_per_block, queries a pass, kc,
// cap, stages, shared-memory bytes). Returns 0, or -1 for a shape not taken.
extern "C" int evr_topk_plan(int N, int D, int Q, int k, int* out) {
  evr::topk90::Plan p;
  if (!evr::topk90::make_plan(N, D, Q, k, &p)) return -1;
  const int v[7] = {p.n_blocks, p.tiles_per_block, p.qc, p.kc, p.cap, p.stages, static_cast<int>(p.smem)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

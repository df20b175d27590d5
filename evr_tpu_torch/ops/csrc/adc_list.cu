// K7: ADC (product-quantisation table lookup) scores of probed inverted
//     lists, read where they lie, written for Hopper:
//     out[b, j, c] = sum_s tables[b, s, codes_lists[list_ids[b, j], c, s]],
//     codes_lists [L, C, S] uint8, list_ids [B, n] int64, tables [B, S, K]
//     fp32 (both walks take them code-major, [B, K, S]), out [B, n, C]. An
//     id outside [0, L) traps, as torch's own indexing asserts on the card.
//
// Replaces: evr_tpu/ops/adc_pallas.py::adc_list_scores (Pallas kernel body
// _adc_list_kernel), which scores gathered [P, C, S] blocks against their
// query's table (the JAX search slices each probed list out first); that is
// the case codes_lists = blocks, list_ids = arange(P).view(B, nprobe). Every
// term is one exact fp32 table read, so only the order of the sum over S is
// free: each row is summed over s = 0, 1, ..., S-1 in order, one rounded add
// per term (__fadd_rn, from 0), the order of the plain PyTorch version in
// ops/adc.py, so the two agree to the bit. No tensor cores: a one-hot x table
// product in TF32 would not be exact.
//
// Bound on an H100 SXM: memory. At the IVF-PQ probe shape of the chip smoke
// run (B = 8 queries x nprobe 32 = 256 probed lists of C = 3,072 rows, S =
// 64, K = 256) the kernel must read 50.3 MB of codes and 0.5 MB of tables and
// write 3.1 MB of scores: 16 us at 3.35 TB/s. Its 50 M table reads come from
// shared memory: about 0.007 ms at one wavefront each, 0.021-0.024 ms at the
// ~3.5-way bank conflicts of 32 lanes reading one subspace at random codes.
//
// Design (ops/adc.py::adc_plan mirrors the plan):
//   - a persistent grid of about one block an SM (kTargetBlocks); the work is
//     tiles of R rows of one probed list, ordered (query, probe, tile), and
//     block b takes a contiguous run of them, so its tiles share a query;
//   - the ring walk (S of 32, 64, 96 or 128, a 16-byte-aligned codes_lists,
//     table and ring within 227 KB): the block stages its query's code-major
//     [K][S] table once by one 1-D bulk copy onto an mbarrier, and again only
//     where its run crosses into the next query (after a barrier: every warp
//     is done with the old one). Eight warps take the run's tiles in turn;
//     lane 0 of each is the producer thread of the warp's own ring of 2-4
//     stages, each one tile [R = 32 g rows][S] copied by the TMA unit from
//     where the list lies, at list_ids[p] read in the kernel: a list's rows
//     are contiguous, so a tile is one 1-D bulk copy (a 3-D tensor map over
//     [L, C, S] moves it as R requests of S bytes, and streamed an
//     L2-resident list 30 % slower on an H100); a ragged last tile copies its
//     rows only, and lanes past C read the tile's first row, unstored. A
//     stage is refilled by the warp that read it, after its last read, so a
//     parity wait never sees a fill two back;
//   - table reads without bank conflicts: in the code-major table the bank of
//     (code, s) is s mod 32, so the 32 lanes of a warp must read 32 distinct
//     s at once. Lane l owns rows g * 32 + l of each tile and walks them back
//     to back, l + 1 steps behind lane 0: in a block of S steps it finishes
//     its old row (the last l + 1 subspaces, into acc_o) and starts its new
//     one (the first S - l - 1, into acc_n), each row still summed in order
//     s = 0 .. S-1. Steps 0 and 32.. are uniform across lanes, steps 1..31
//     pick the accumulator by a predicate (no branch). The codes come a
//     32-bit word a lane every four steps from the stage (two-way bank
//     conflicts at S = 64), funnel-shifted by the lane's byte phase; at S =
//     64 one byte permute of that word and a lane constant gives the entry's
//     byte offset (code << 8) | 4 s, so a lookup is a permute, a load and an
//     add. The skew costs one idle block per warp and query run;
//   - the direct walk (any other shape: S % 32 != 0 or S > 128, an unaligned
//     codes_lists, or a table the ring cannot hold beside its stages): blocks
//     of 256 threads on runs of 256-row tiles, the [S][K] table staged by
//     plain loads at each query change, one row a thread read from global
//     memory at list_ids (16-byte loads where S % 16 == 0 and aligned); the
//     staging loop transposes the code-major table, since a [K][S] table read
//     a row a thread would put a warp's lanes on few banks.
// The choice is the shape's alone (make_plan), never a failure's.
//
// Measured on an H100 (tools/adc_bench.py): a full probe of 2,048 lists at B
// = 8 streams at about the device's memory rate; at the probe shape above a
// launch spends about 10 us beyond that rate in its start (the table, the
// first tiles) and tail.

#include <algorithm>
#include <climits>
#include <cstdint>

#include "sm90.cuh"

namespace evr {
namespace adc90 {

using namespace sm90;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTargetBlocks = 132;        // one block on each SM of an H100
constexpr long long kSmemLimit = 232448;  // the most one block may take (227 KB)
constexpr long long kSmShared = 233472;   // the shared memory of one SM
constexpr int kMaxStages = 4;             // ring stages a warp, at most
constexpr int kDirectRows = 256;          // rows of a direct-walk tile, one a thread
enum Walk { kDirect = 0, kRing = 1 };

// -- the plan (ops/adc.py::adc_plan mirrors it) -------------------------------

struct Plan {
  int walk;
  int g;        // ring walk: rows of each lane in a tile (R = 32 g)
  int tiles;    // tiles of one list
  int per;      // tiles of each block's run
  int grid;
  int stages;   // ring stages a warp
  long long smem;
};

inline bool ring_subspaces(int S) { return S == 32 || S == 64 || S == 96 || S == 128; }

// the table, the warps' stages, their full barriers and the table's barrier
inline long long ring_smem(int S, int K, int g, int stages) {
  return 4LL * K * S + static_cast<long long>(kWarps) * stages * 32 * g * S + 8LL * (kWarps * stages + 1);
}

// L lists of C rows of S codes, K centroids, P probed lists; aligned: the
// codes' base is 16-byte aligned. The ring takes the largest g of 4, 2, 1
// that leaves every warp of the grid a tile (or g = 1) and fits with two or
// more stages.
inline bool make_plan(int L, int C, int S, int K, int P, bool aligned, Plan* p) {
  if (L < 1 || C < 1 || S < 1 || K < 1 || K > 256 || P < 1) return false;
  if (ring_subspaces(S) && aligned) {
    for (int g = 4; g >= 1; g >>= 1) {
      const int tiles = (C + 32 * g - 1) / (32 * g);
      const long long total = static_cast<long long>(P) * tiles;
      if (g > 1 && total < static_cast<long long>(kTargetBlocks) * kWarps) continue;
      int st = kMaxStages;
      while (st >= 2 && ring_smem(S, K, g, st) > kSmemLimit) --st;
      if (st < 2 || total > INT_MAX) continue;
      p->walk = kRing;
      p->g = g;
      p->tiles = tiles;
      p->stages = st;
      p->smem = ring_smem(S, K, g, st);
      p->per = static_cast<int>((total + kTargetBlocks - 1) / kTargetBlocks);
      p->grid = static_cast<int>((total + p->per - 1) / p->per);
      return true;
    }
  }
  const long long table = 4LL * S * K;
  const int tiles = (C + kDirectRows - 1) / kDirectRows;
  const long long total = static_cast<long long>(P) * tiles;
  if (table > kSmemLimit || total > INT_MAX) return false;
  const long long per_sm = std::max(1LL, std::min(8LL, kSmShared / (table + 1024)));
  p->walk = kDirect;
  p->g = 0;
  p->tiles = tiles;
  p->stages = 0;
  p->smem = table;
  p->per = static_cast<int>((total + kTargetBlocks * per_sm - 1) / (kTargetBlocks * per_sm));
  p->grid = static_cast<int>((total + p->per - 1) / p->per);
  return true;
}

// -- the kernels -------------------------------------------------------------------

struct Args {
  const uint8_t* codes;  // [L, C, S]
  const long long* ids;  // [P], P = B * n, each in [0, L)
  const float* tables;   // [B, K, S], code-major
  float* out;            // [P, C]
  int L, C, S, K, n, tiles, per, total, g, stages;
};

// list_ids[p], trapping on an id outside [0, L): the kernel would read past
// the lists
__device__ __forceinline__ long long list_id(const Args& a, int p) {
  const long long id = a.ids[p];
  if (id < 0 || id >= a.L) __trap();
  return id;
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1) adc_ring_kernel(const Args a) {
  // the table at offset 0 of the dynamic shared memory (the kernel has no
  // static shared memory), so an entry's byte offset is its address past
  // the base; the stages after it keep the 16-byte alignment bulk copies need
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);  // the code-major table [K][S]
  const int R = 32 * a.g, ns = a.stages;
  const uint32_t stage_bytes = static_cast<uint32_t>(R) * S;
  const uint32_t table_bytes = static_cast<uint32_t>(a.K) * S * 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t ring = base + table_bytes + warp * ns * stage_bytes;  // this warp's stages
  const unsigned char* ring_ptr = smem + table_bytes + warp * ns * stage_bytes;
  const uint32_t bars = base + table_bytes + kWarps * ns * stage_bytes;
  const uint32_t tbar = bars + 8u * kWarps * ns;
  auto full = [bars, warp, ns](int slot) { return bars + 8u * (warp * ns + slot); };
  const int t0 = blockIdx.x * a.per, nt = min(a.per, a.total - t0);
  const int per_query = a.n * a.tiles;  // tiles of one query's probes

  if (threadIdx.x == 0) {
    if (base % 16 != 0) __trap();  // never: no static shared memory precedes it
    for (int i = 0; i <= kWarps * ns; ++i) mbar_init(bars + 8u * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The warp's tiles: run positions k = warp, warp + kWarps, ...; its j-th
  // tile sits in slot j % ns, that slot's (j / ns)-th fill.
  const int nw = nt > warp ? (nt - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int j) {
    const int tau = t0 + warp + j * kWarps;
    const int p = tau / a.tiles, slot = j % ns, row0 = (tau - p * a.tiles) * R;
    const uint32_t bytes = static_cast<uint32_t>(min(R, a.C - row0)) * S;  // the tile's rows lie back to back
    mbar_expect_tx(full(slot), bytes);
    bulk_load(ring + slot * stage_bytes, a.codes + (static_cast<size_t>(list_id(a, p)) * a.C + row0) * S, bytes,
              full(slot));
  };
  auto load_table = [&](int q) {
    mbar_expect_tx(tbar, table_bytes);
    bulk_load(base, a.tables + static_cast<size_t>(q) * a.K * S, table_bytes, tbar);
  };
  if (lane == 0)
    for (int j = 0; j < min(ns, nw); ++j) issue(j);
  if (threadIdx.x == 0) load_table(t0 / per_query);

  // lane l runs d = l + 1 steps behind: in a block, steps i < d finish the
  // old row at s = o + i, steps i >= d start the new row at s = o + i - S;
  // its codes are bytes o + i of the old row's and the new row's S bytes
  // back to back, read as words bq + w + 1 (old row while w < wt) shifted by
  // sh bits
  const int d = lane + 1, o = S - d;
  const int bq = o >> 2, sh = 8 * (o & 3), wt = S / 4 - bq - 1;
  // S = 64: a code's table row is 256 bytes, so one byte permute builds the
  // byte offset (code << 8) | 4 s of step i's entry, s = (o + i) mod 64 on
  // either row, from the code and the lane's column bytes of steps 2k and
  // 2k + 1, kept in bytes 0 and 2 of cols[k] (bytes 1 and 3 zero); an opaque
  // move keeps them in registers (recomputed, they cost three integer
  // operations a pair of steps)
  uint32_t cols[S == 64 ? 32 : 1];
#pragma unroll
  for (int k = 0; k < (S == 64 ? 32 : 1); ++k)
    asm volatile("mov.b32 %0, %1;"
                 : "=r"(cols[k])
                 : "r"((4u * ((o + 2 * k) & 63)) | ((4u * ((o + 2 * k + 1) & 63)) << 16)));

  int j = 0;  // the warp's next tile
  for (int k0 = 0, seg = 0; k0 < nt; ++seg) {
    const int q = (t0 + k0) / per_query;
    const int k1 = min(nt, (q + 1) * per_query - t0);  // the query's tiles end the run at k1
    const int jb = k1 > warp ? min(nw, (k1 - warp + kWarps - 1) / kWarps) : 0;
    mbar_wait(tbar, seg & 1);
    const int rows = (jb - j) * a.g;  // rows of each lane in this query's tiles
    float acc_o = 0.f, acc_n = 0.f;
    const unsigned char* old_row = nullptr;
    float* out_old = nullptr;  // where the old row's score goes; null: nowhere
    float* out_tile = nullptr;
    uint32_t w0 = 0;
    int jn = j, gn = 0, rows_left = 0;  // the new row: tile jn (of the warp's), row gn * 32 + lane
    for (int m = 0; rows > 0 && m <= rows; ++m) {
      // block m: old row m - 1, new row m (none at 0 and at rows: their
      // steps read a row of the stage and are discarded)
      const bool tile_start = gn == 0;
      const unsigned char* new_row = old_row;
      float* out_new = nullptr;
      if (m < rows) {
        const int slot = jn % ns;
        if (tile_start) {
          mbar_wait(full(slot), (jn / ns) & 1);
          const int tau = t0 + warp + jn * kWarps, p = tau / a.tiles, row0 = (tau - p * a.tiles) * R;
          out_tile = a.out + static_cast<size_t>(p) * a.C + row0;
          rows_left = a.C - row0;
        }
        // a row past C (a ragged last tile copies its rows only) reads the
        // tile's first row instead, and its score is not stored
        const bool real = gn * 32 + lane < rows_left;
        new_row = ring_ptr + slot * stage_bytes + (real ? gn * 32 + lane : 0) * S;
        if (real) out_new = out_tile + gn * 32 + lane;
      }
      if (m == 0) {
        old_row = new_row;
        w0 = *reinterpret_cast<const uint32_t*>(old_row + 4 * bq);
      }
      const uint32_t* wo = reinterpret_cast<const uint32_t*>(old_row + 4 * (bq + 1));
      const uint32_t* wn = reinterpret_cast<const uint32_t*>(new_row + 4 * (bq + 1) - S);
#pragma unroll
      for (int w = 0; w < S / 4; ++w) {
        const uint32_t w1 = (w < wt ? wo : wn)[w];
        const uint32_t v = __funnelshift_r(w0, w1, sh);  // bytes o + 4w .. o + 4w + 3
        w0 = w1;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = 4 * w + b;
          // the byte offset of the entry (code, o + i) of the old row or
          // (code, o + i - S) of the new one
          const bool old = i == 0 || (i < 32 && i < d);  // uniform at i = 0 and from 32 on
          uint32_t at;
          if constexpr (S == 64)
            at = __byte_perm(v, cols[i / 2], 0x7504u | (b << 4) | (2 * (i & 1)));
          else
            at = 4u * (__byte_perm(v, 0u, 0x4440u | b) * S + (old ? o + i : o + i - S));
          const float t = *reinterpret_cast<const float*>(smem + at);
          if (i == 0) {  // every lane on its old row
            acc_o = __fadd_rn(acc_o, t);
          } else if (i >= 32) {  // every lane on its new row
            acc_n = __fadd_rn(acc_n, t);
          } else {  // lanes with i < d on the old row: predicated adds, no branch
            asm("{\n.reg .pred p;\n"
                "setp.gt.s32 p, %3, %2;\n"
                "@p add.rn.f32 %0, %0, %4;\n"
                "@!p add.rn.f32 %1, %1, %4;\n}"
                : "+f"(acc_o), "+f"(acc_n)
                : "r"(i), "r"(d), "f"(t));
          }
        }
      }
      if (out_old != nullptr) *out_old = acc_o;
      if (m > 0 && tile_start) {
        // the old row was its tile's last: the stage is read, refill it
        __syncwarp();
        if (lane == 0 && jn - 1 + ns < nw) {
          fence_async_shared();
          issue(jn - 1 + ns);
        }
      }
      acc_o = acc_n;
      acc_n = 0.f;
      old_row = new_row;
      out_old = out_new;
      if (++gn == a.g) {
        gn = 0;
        ++jn;
      }
    }
    j = jb;
    k0 = k1;
    if (k0 < nt) {
      __syncthreads();  // every warp is done with this query's table
      if (threadIdx.x == 0) {
        fence_async_shared();
        load_table((t0 + k0) / per_query);
      }
    }
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads) adc_direct_kernel(const Args a) {
  extern __shared__ __align__(16) float tbl[];  // [S][K]
  const int S = a.S, K = a.K;
  const int t0 = blockIdx.x * a.per, t1 = min(t0 + a.per, a.total);
  int q_cur = -1;
  for (int t = t0; t < t1; ++t) {
    const int p = t / a.tiles, q = p / a.n;
    if (q != q_cur) {
      __syncthreads();  // every thread is done with the last query's table
      const float* src = a.tables + static_cast<size_t>(q) * K * S;  // [K][S]
      for (int i = threadIdx.x; i < S * K; i += kThreads) tbl[i] = src[(i % K) * S + i / K];
      __syncthreads();
      q_cur = q;
    }
    const int c = (t - p * a.tiles) * kDirectRows + threadIdx.x;
    if (c >= a.C) continue;
    const uint8_t* codes = a.codes + (static_cast<size_t>(list_id(a, p)) * a.C + c) * S;
    float acc = 0.f;
    if (kVec16) {
      for (int s0 = 0; s0 < S; s0 += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(codes + s0);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 16; ++j) acc = __fadd_rn(acc, tbl[(s0 + j) * K + b[j]]);
      }
    } else {
      for (int s = 0; s < S; ++s) acc = __fadd_rn(acc, tbl[s * K + codes[s]]);
    }
    a.out[static_cast<size_t>(p) * a.C + c] = acc;
  }
}

template <int S>
int launch_ring(const Args& a, const Plan& p, cudaStream_t stream) {
  auto kernel = adc_ring_kernel<S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, kThreads, p.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec16>
int launch_direct(const Args& a, const Plan& p, cudaStream_t stream) {
  auto kernel = adc_direct_kernel<kVec16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, kThreads, p.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace adc90
}  // namespace evr

// Plain C entry point for ctypes: codes_lists [L, C, S] uint8, list_ids [B, n]
// int64 (each in [0, L): the kernel traps on another), tables [B, K, S] fp32
// code-major, out [B, n, C] fp32, all contiguous on the device. Returns 0, -1
// for a shape the kernel does not take, or a CUDA error code.
extern "C" int evr_adc_probe_scores(const void* codes, int L, int C, int S, const void* ids, int B, int n,
                                    const void* tables, int K, void* out, void* stream) {
  using namespace evr::adc90;
  Plan p;
  if (B < 1 || n < 1 || static_cast<long long>(B) * n > INT_MAX ||
      !make_plan(L, C, S, K, B * n, evr::aligned16(codes), &p))
    return -1;
  const Args a{static_cast<const uint8_t*>(codes), static_cast<const long long*>(ids),
               static_cast<const float*>(tables), static_cast<float*>(out), L, C, S, K, n, p.tiles, p.per,
               B * n * p.tiles, p.g, p.stages};
  auto s = static_cast<cudaStream_t>(stream);
  if (p.walk == kRing) {
    if (S == 32) return launch_ring<32>(a, p, s);
    if (S == 64) return launch_ring<64>(a, p, s);
    if (S == 96) return launch_ring<96>(a, p, s);
    return launch_ring<128>(a, p, s);
  }
  if (S % 16 == 0 && evr::aligned16(codes)) return launch_direct<true>(a, p, s);
  return launch_direct<false>(a, p, s);
}

// The plan of a call: out = (walk, g, tiles, per, grid, stages, shared-memory
// bytes). Returns 0, or -1 for a shape not taken.
extern "C" int evr_adc_plan(int L, int C, int S, int K, int P, int aligned, int* out) {
  evr::adc90::Plan p;
  if (!evr::adc90::make_plan(L, C, S, K, P, aligned != 0, &p)) return -1;
  const int v[7] = {p.walk, p.g, p.tiles, p.per, p.grid, p.stages, static_cast<int>(p.smem)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

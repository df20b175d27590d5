// K7: ADC (product-quantisation table lookup) scores of probed inverted lists:
//     out[p, c] = sum_s tables[p / nprobe, s, blocks[p, c, s]],
//     blocks [P, C, S] uint8, tables [B, S, K] fp32, out [P, C] fp32.
//
// Replaces: evr_tpu/ops/adc_pallas.py::adc_list_scores (Pallas kernel body
// _adc_list_kernel). The TPU kernel builds the one-hot of each 128-row chunk
// in VMEM and contracts it with the table on the vector unit; every term is
// one exact fp32 table read, so only the order of the sum over S is free.
// Here each row is summed over s = 0, 1, ..., S-1 in order, one rounded add
// per term (__fadd_rn, from 0), which is the order of the plain PyTorch
// version in ops/adc.py: the two agree to the bit.
//
// Bound on an H100 SXM: memory. At the IVF-PQ probe shape of the chip smoke
// run (P = 256 probed lists of C = 3,072 rows, S = 64, K = 256, B = 8) the
// kernel must read 50.3 MB of codes and 0.5 MB of tables and write 3.1 MB of
// scores: 16 us at 3.35 TB/s. Its 50 M table reads come from shared memory.
//
// Design (right and simple first): one block of 256 threads per (probed list
// p, tile of 256 rows), p on the grid's x axis (any P) and the tile on y. The
// block stages its query's [S, K] table in shared memory (64 KB at S = 64,
// K = 256; up to the 227 KB a block may hold, which the wrapper checks), then
// each thread owns one row: it reads the row's S
// codes with 16-byte vector loads (a scalar loop where S % 16 != 0) and adds
// table[s][code] in fp32. Rows past C in the last tile are masked. Left for
// later: the bank conflicts of the random table reads, reuse of a table across
// a query's probes, and reading the codes straight from the packed lists
// instead of a gathered [P, C, S] copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace evr {

constexpr int kAdcThreads = 256;  // rows per block, one per thread
constexpr int kAdcMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90

template <bool kVec16>
__global__ void __launch_bounds__(kAdcThreads) adc_list_kernel(
    const uint8_t* __restrict__ blocks, const float* __restrict__ tables, int C, int S, int K,
    int nprobe, float* __restrict__ out) {
  extern __shared__ __align__(16) float table[];  // [S][K]
  const int p = blockIdx.x;
  const float* src = tables + static_cast<size_t>(p / nprobe) * S * K;
  for (int i = threadIdx.x; i < S * K; i += kAdcThreads) table[i] = src[i];
  __syncthreads();

  const int c = blockIdx.y * kAdcThreads + threadIdx.x;
  if (c >= C) return;
  const uint8_t* codes = blocks + (static_cast<size_t>(p) * C + c) * S;
  float acc = 0.f;
  if (kVec16) {
    for (int s0 = 0; s0 < S; s0 += 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(codes + s0);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc = __fadd_rn(acc, table[(s0 + j) * K + b[j]]);
    }
  } else {
    for (int s = 0; s < S; ++s) acc = __fadd_rn(acc, table[s * K + codes[s]]);
  }
  out[static_cast<size_t>(p) * C + c] = acc;
}

template <bool kVec16>
int launch_adc(const uint8_t* blocks, const float* tables, int P, int C, int S, int K, int nprobe,
               float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * S * K;
  auto kernel = adc_list_kernel<kVec16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P, (C + kAdcThreads - 1) / kAdcThreads);
  kernel<<<grid, kAdcThreads, smem, stream>>>(blocks, tables, C, S, K, nprobe, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace evr

// Plain C entry point for ctypes: blocks [P, C, S] uint8 and tables [B, S, K]
// fp32 contiguous on the device, P = B * nprobe, out [P, C] fp32. Returns 0,
// -1 for a shape the kernel does not take, or a CUDA error code.
extern "C" int evr_adc_list_scores(const void* blocks, const void* tables, int P, int C, int S,
                                   int K, int nprobe, void* out, void* stream) {
  if (P < 1 || C < 1 || S < 1 || K < 1 || K > 256 || nprobe < 1 || P % nprobe != 0 ||
      (C + evr::kAdcThreads - 1) / evr::kAdcThreads > 65535 ||
      static_cast<size_t>(S) * K * sizeof(float) > evr::kAdcMaxSmem)
    return -1;
  auto b = static_cast<const uint8_t*>(blocks);
  auto t = static_cast<const float*>(tables);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte code loads need every row's start aligned: S % 16 == 0 and an
  // aligned base
  if (S % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0)
    return evr::launch_adc<true>(b, t, P, C, S, K, nprobe, o, s);
  return evr::launch_adc<false>(b, t, P, C, S, K, nprobe, o, s);
}

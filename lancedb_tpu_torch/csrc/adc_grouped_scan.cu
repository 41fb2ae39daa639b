// Query-grouped IVF_PQ ADC probe scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ivf_pq_adc_grouped_scan_pallas
// (lancedb_tpu/ops/pallas_adc.py, cells _adc_group_cell_kernel_onehot
// for K <= 64 and _adc_group_cell_kernel_gather for K > 64). For every
// (query q, probe j, slot p) with pid = probe_ids[q, j]:
//
//   base         = qn2[q] - 2 * qc[q, j]
//   qdotr        = sum_s lut[q, s, codes[pid, s, p]]   (f32, s = 0, 1, ...)
//   out[q, j, p] = (base - 2 * qdotr) + rnorms[pid, p]
//
// where lut is dlut rounded to bf16 (round to nearest even) when
// round_bf16 != 0 and dlut itself otherwise. That is the TPU kernel's own
// arithmetic: its one-hot cell multiplies a bf16 LUT by a bf16 one-hot
// with f32 sums, its gather cell looks the f32 LUT up, and both add the
// per-pair base first. So for K <= 64 this is not B1's function: the LUT
// entries carry bf16's 8-bit mantissa.
//
// The (query, probe) pairs arrive grouped by partition
// (ops/util.py group_probe_pairs, flattened by ops/flat_scan.py
// grouped_plan): group g covers partition gpid[g] and up to qpc pairs,
// pair_of_slot[g * qpc + i] = q * NP + j, or -1 on padding. Padding,
// filter and delete penalties arrive through rnorms (+3e38, or inf where
// two add up), so the kernel never branches on them.
//
// Bound: device-memory bytes, as for B1 (csrc/adc_scan.cu): each probed
// partition's S x pmax code bytes and pmax rnorms, the LUTs and the
// (Q, NP, pmax) f32 output; S adds per output are far below the card's
// f32 rate. Design (simple first): one block per (group, 256-slot tile),
// one thread per slot. The block reads the group's S x 256 codes from
// device memory into shared memory once and serves every query of the
// group from them; that sharing is the point of the grouped shape. The
// queries' LUTs are staged in shared memory `lpc` at a time (as many as
// the wrapper's budget holds, at least one: all of a group's LUTs at
// qpc 16, S 16, K 256 would be 256 KiB, more than a block may have).
// Each real slot's row goes straight to out[q, j]; padded slots are
// never written, and a group of padding only returns at once. The
// LUT·one-hot product on tensor cores and wider code loads are later
// work.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // slots of one block, one thread each
constexpr int kMaxQpc = 32;

__global__ void __launch_bounds__(kTile) adc_grouped_scan_kernel(
    const int32_t* __restrict__ gpid,          // (G,)
    const int32_t* __restrict__ pair_of_slot,  // (G * qpc,), -1 on padding
    const float* __restrict__ dlut,            // (Q, S, K)
    const uint8_t* __restrict__ codes,         // (P, S, pmax)
    const float* __restrict__ rnorms,          // (P, pmax)
    const float* __restrict__ qc,              // (Q * NP,)
    const float* __restrict__ qn2,             // (Q,)
    float* __restrict__ out,                   // (Q * NP, pmax)
    int qpc, int lpc, int np_, int s_, int k_, int pmax, int round_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* pairs = reinterpret_cast<int*>(smem);                  // kMaxQpc pair ids
  uint8_t* tile = smem + kMaxQpc * sizeof(int);               // S x kTile codes
  float* luts = reinterpret_cast<float*>(tile + s_ * kTile);  // lpc x S x K
  const int t = threadIdx.x;
  const int grp = blockIdx.x;
  const int p0 = blockIdx.y * kTile;
  if (t < kMaxQpc) {
    pairs[t] = t < qpc ? pair_of_slot[static_cast<size_t>(grp) * qpc + t] : -1;
  }
  __syncthreads();
  // slots fill each group front first, so this is a group of padding only
  if (pairs[0] < 0) return;

  const int pid = gpid[grp];
  const int width = min(kTile, pmax - p0);
  const uint8_t* block = codes + static_cast<size_t>(pid) * s_ * pmax + p0;
  for (int i = t; i < s_ * kTile; i += kTile) {
    const int s = i / kTile, c = i % kTile;
    tile[i] = c < width ? block[static_cast<size_t>(s) * pmax + c] : 0;
  }
  const bool live = t < width;
  const float rn = live ? rnorms[static_cast<size_t>(pid) * pmax + p0 + t] : 0.0f;
  const int sk = s_ * k_;
  for (int g0 = 0; g0 < qpc; g0 += lpc) {
    const int n = min(lpc, qpc - g0);
    __syncthreads();  // the code tile is in place; the last pass's LUTs are read
    for (int i = t; i < n * sk; i += kTile) {
      const int pair = pairs[g0 + i / sk];
      if (pair < 0) continue;
      float v = dlut[static_cast<size_t>(pair / np_) * sk + i % sk];
      if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      luts[i] = v;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const int pair = pairs[g0 + j];
      if (pair < 0) continue;
      const float* lut = luts + j * sk;
      float acc = 0.0f;
      for (int s = 0; s < s_; ++s) {
        acc = __fadd_rn(acc, lut[s * k_ + tile[s * kTile + t]]);
      }
      // base first, then -2 qdotr, then rnorms, rounded step by step as
      // the plain version and the TPU kernel do
      const float base = __fsub_rn(qn2[pair / np_], __fmul_rn(2.0f, qc[pair]));
      out[static_cast<size_t>(pair) * pmax + p0 + t] =
          __fadd_rn(__fsub_rn(base, __fmul_rn(2.0f, acc)), rn);
    }
  }
}

}  // namespace

// Shared memory of one block (all of it dynamic): the group's pair ids,
// the code tile and lpc LUTs.
extern "C" int adc_grouped_scan_smem_bytes(int s_, int k_, int lpc) {
  return static_cast<int>(kMaxQpc * sizeof(int)) + s_ * kTile +
         lpc * s_ * k_ * static_cast<int>(sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// qpc in [1, 32], lpc in [1, qpc]; round_bf16 != 0 rounds the LUT to bf16.
extern "C" int adc_grouped_scan_launch(
    const void* gpid, const void* pair_of_slot, const void* dlut, const void* codes,
    const void* rnorms, const void* qc, const void* qn2, void* out,
    int g, int qpc, int lpc, int np_, int s_, int k_, int pmax, int round_bf16,
    void* stream) {
  if (qpc < 1 || qpc > kMaxQpc || lpc < 1 || lpc > qpc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = adc_grouped_scan_smem_bytes(s_, k_, lpc);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        adc_grouped_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(g), (pmax + kTile - 1) / kTile);
  adc_grouped_scan_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gpid), static_cast<const int32_t*>(pair_of_slot),
      static_cast<const float*>(dlut), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(rnorms), static_cast<const float*>(qc),
      static_cast<const float*>(qn2), static_cast<float*>(out),
      qpc, lpc, np_, s_, k_, pmax, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adc_grouped_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

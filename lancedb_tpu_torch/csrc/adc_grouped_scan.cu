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
// K <= 64 and dlut itself otherwise. That is the TPU kernel's own
// arithmetic: its one-hot cell multiplies a bf16 LUT by a bf16 one-hot
// with f32 sums, its gather cell looks the f32 LUT up, and both add the
// per-pair base first. So for K <= 64 this is not B1's function: the LUT
// entries carry bf16's 8-bit mantissa.
//
// The (query, probe) pairs arrive grouped by partition (the plan of
// csrc/group_plan.cu, or ops/util.py grouped_plan_reference): group g
// covers partition gpid[g] and up to qpc pairs, pair_of_slot[g * qpc + i]
// = q * NP + j, or -1 on padding. Slots fill each group front first and
// the groups of padding only sit at the tail of the plan. Padding, filter
// and delete penalties arrive through rnorms (+3e38, or inf where two add
// up), so the kernel never branches on them.
//
// Bound: device-memory bytes, as for B1 (csrc/adc_scan.cu): each probed
// partition's S x pmax code bytes and pmax rnorms, the LUTs and the
// (Q, NP, pmax) f32 output; S adds per output are far below the card's
// f32 rate. A block per (group, 256-slot tile) would stage every LUT once
// per tile: about 283 MB of L2 reads per 8-bit launch at chip_smoke's
// inputs, against 17 MB of codes. This design:
//   - one block of 256 threads per group; a group of padding only (the
//     plan's tail) returns after one load a thread;
//   - the block stages each live query's LUT once, lpc at a time, with
//     16-byte cp.async copies; for K <= 64 the LUTs are rounded to bf16
//     as they are staged (exact: that is the TPU cell's operand) and take
//     half the space. The wrapper sizes lpc so that two blocks share an
//     SM (4 LUTs at S 16, K 256): one block of 8 LUTs an SM was slower;
//   - the partition's codes stream through two shared-memory stages of
//     S x ts bytes (16-byte cp.async; `ts` a multiple of 16 slots from
//     the wrapper, the whole partition where it fits): the next tile, or
//     the next pass's first, loads while the current one is summed;
//   - the block's work items are (live query, 4 consecutive slots),
//     slot-fastest: a thread reads one 4-byte word of codes a subvector
//     (consecutive words across a warp: no bank conflict), does 4 LUT
//     lookups with it and writes the 4 outputs with one 16-byte store;
//   - the arithmetic keeps the plain version's order: the S lookups
//     summed in f32 subvector by subvector from 0, then (base - 2 acc) +
//     rnorms, each step rounded (__fadd_rn / __fmul_rn / __fsub_rn);
//   - padded slots (p >= pmax) and padded group slots are never written.
// Where pmax or a pointer does not allow 16-byte copies, the same stages
// are filled with plain loads, and stores go one float at a time.
// Measured (PERF.md §6): 1.4x B1's time on the same inputs and 4.5-4.8x
// its bytes bound; both kernels are bound by the S LUT lookups of every
// output (3-4 way bank conflicts at K = 256), not by bytes. A persistent
// grid (a block per resident slot walking the groups, prefetching the
// next group's codes), 8 or 16 slots an item, one thread per 4 slots with
// the queries in registers, and one pass of 8 LUTs at 8 bits each ran
// slower on the card.
//
// nvcc -Xptxas -v (CUDA 12.9, sm_90a): 40 registers for both LUT types,
// no spills, 384 bytes of static shared memory; the dynamic shared memory
// is 2 x S x ts + lpc x S x K x (2 or 4) bytes (100 KiB at 8-bit x16, 44
// KiB at 4-bit x32 at pmax 1152).
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQpc = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// One LUT entry as f32: a bf16 entry widens exactly.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// Stage code tile `tile` of partition `pid`: S rows of ts bytes, row s
// holding codes[pid, s, tile * ts ...]. With `vec` (pmax and ts multiples
// of 16, codes 16-byte aligned) by cp.async; else by plain loads, zero
// past the partition's slots up to a whole word.
__device__ __forceinline__ void stage_codes(uint8_t* stage, const uint8_t* __restrict__ codes,
                                            int pid, int tile, int s_, int pmax, int ts,
                                            bool vec) {
  const int p0 = tile * ts;
  const int rows = min(ts, pmax - p0);
  const uint8_t* src = codes + static_cast<size_t>(pid) * s_ * pmax + p0;
  if (vec) {
    const int cpr = rows >> 4;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < s_ * cpr; i += blockDim.x) {
      const int s = i / cpr, c = i - s * cpr;
      cp_async16(stage + s * ts + c * 16, src + static_cast<size_t>(s) * pmax + c * 16);
    }
  } else {
    const int w = (rows + 3) & ~3;
    for (int i = threadIdx.x; i < s_ * w; i += blockDim.x) {
      const int s = i / w, c = i - s * w;
      stage[s * ts + c] = c < rows ? src[static_cast<size_t>(s) * pmax + c] : 0;
    }
  }
}

// Stage the LUTs of queries qrow[0 .. nl): f32 by cp.async, or rounded
// to bf16 through registers. `vec`: S x K a multiple of 4 and dlut
// 16-byte aligned.
template <bool BF16>
__device__ __forceinline__ void stage_luts(void* luts, const float* __restrict__ dlut,
                                           const int* qrow, int nl, int sk, bool vec) {
  const int t = threadIdx.x;
  if (vec) {
    const int n4 = sk >> 2;
    for (int i = t; i < nl * n4; i += blockDim.x) {
      const int j = i / n4, c = i - j * n4;
      const float* src = dlut + static_cast<size_t>(qrow[j]) * sk + c * 4;
      if constexpr (BF16) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src));
        uint2 packed;
        packed.x = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
        packed.y = bf16_bits(v.z) | (bf16_bits(v.w) << 16);
        *reinterpret_cast<uint2*>(static_cast<uint16_t*>(luts) + static_cast<size_t>(j) * sk +
                                  c * 4) = packed;
      } else {
        cp_async16(static_cast<float*>(luts) + static_cast<size_t>(j) * sk + c * 4, src);
      }
    }
  } else {
    for (int i = t; i < nl * sk; i += blockDim.x) {
      const int j = i / sk, e = i - j * sk;
      const float v = dlut[static_cast<size_t>(qrow[j]) * sk + e];
      if constexpr (BF16) {
        static_cast<uint16_t*>(luts)[i] = static_cast<uint16_t>(bf16_bits(v));
      } else {
        static_cast<float*>(luts)[i] = v;
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) adc_grouped_scan_kernel(
    const int32_t* __restrict__ gpid,          // (G,)
    const int32_t* __restrict__ pair_of_slot,  // (G * qpc,), -1 on padding
    const float* __restrict__ dlut,            // (Q, S, K)
    const uint8_t* __restrict__ codes,         // (P, S, pmax)
    const float* __restrict__ rnorms,          // (P, pmax)
    const float* __restrict__ qc,              // (Q * NP,)
    const float* __restrict__ qn2,             // (Q,)
    float* __restrict__ out,                   // (Q * NP, pmax)
    int qpc, int lpc, int np_, int s_, int k_, int pmax, int ts, int vec_codes, int vec_lut,
    int vec_out) {
  using Lut = typename std::conditional<BF16, uint16_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pairs[kMaxQpc], qrow[kMaxQpc];
  __shared__ float base[kMaxQpc];
  const int stage_bytes = s_ * ts;
  uint8_t* stages = smem;                                      // 2 x S x ts code bytes
  Lut* luts = reinterpret_cast<Lut*>(smem + 2 * stage_bytes);  // lpc x S x K
  const int t = threadIdx.x;
  const int grp = blockIdx.x;
  // the group's live pairs (real slots first); none: a group of padding
  const int mine = t < qpc ? pair_of_slot[static_cast<size_t>(grp) * qpc + t] : -1;
  const int n = __syncthreads_count(mine >= 0);
  if (n == 0) return;
  if (t < n) {
    pairs[t] = mine;
    qrow[t] = mine / np_;
  }
  const int pid = gpid[grp];
  stage_codes(stages, codes, pid, 0, s_, pmax, ts, vec_codes);
  cp_async_commit();
  __syncthreads();

  const int sk = s_ * k_;
  const int ts4 = ts >> 2;
  const int ntiles = (pmax + ts - 1) / ts;
  const int npass = (n + lpc - 1) / lpc;
  const int per = (n + npass - 1) / npass;  // balanced passes
  int buf = 0;
  for (int pass = 0; pass < npass; ++pass) {
    const int j0 = pass * per, nl = min(per, n - j0);
    // every read of the last pass's LUTs ended at the last step's barrier
    stage_luts<BF16>(luts, dlut, qrow + j0, nl, sk, vec_lut);
    if (t < nl) base[t] = __fsub_rn(qn2[qrow[j0 + t]], __fmul_rn(2.0f, qc[pairs[j0 + t]]));
    cp_async_commit();
    for (int tile = 0; tile < ntiles; ++tile) {
      // the next step's code tile (or the next pass's first) into the other stage
      if (tile + 1 < ntiles || pass + 1 < npass) {
        stage_codes(stages + (buf ^ 1) * stage_bytes, codes, pid, (tile + 1) % ntiles, s_, pmax,
                    ts, vec_codes);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this tile and the LUTs are in
      __syncthreads();

      const unsigned* cw = reinterpret_cast<const unsigned*>(stages + buf * stage_bytes);
      const int p0 = tile * ts;
      const int nq4 = (min(ts, pmax - p0) + 3) >> 2;  // items of one query
      for (int i = t; i < nl * nq4; i += kThreads) {
        const int j = i / nq4, qd = i - j * nq4;
        const Lut* lut = luts + static_cast<size_t>(j) * sk;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int s = 0; s < s_; ++s) {
          const unsigned w = cw[s * ts4 + qd];
          const Lut* row = lut + s * k_;
          a0 = __fadd_rn(a0, widen(row[w & 0xff]));
          a1 = __fadd_rn(a1, widen(row[(w >> 8) & 0xff]));
          a2 = __fadd_rn(a2, widen(row[(w >> 16) & 0xff]));
          a3 = __fadd_rn(a3, widen(row[w >> 24]));
        }
        // base first, then -2 qdotr, then rnorms, rounded step by step
        const float b = base[j];
        const int p = p0 + qd * 4;
        const float* rn = rnorms + static_cast<size_t>(pid) * pmax + p;
        float* o = out + static_cast<size_t>(pairs[j0 + j]) * pmax + p;
        if (vec_out && p + 4 <= pmax) {
          const float4 r4 = __ldg(reinterpret_cast<const float4*>(rn));
          float4 v;
          v.x = __fadd_rn(__fsub_rn(b, __fmul_rn(2.0f, a0)), r4.x);
          v.y = __fadd_rn(__fsub_rn(b, __fmul_rn(2.0f, a1)), r4.y);
          v.z = __fadd_rn(__fsub_rn(b, __fmul_rn(2.0f, a2)), r4.z);
          v.w = __fadd_rn(__fsub_rn(b, __fmul_rn(2.0f, a3)), r4.w);
          *reinterpret_cast<float4*>(o) = v;
        } else {
          const float a[4] = {a0, a1, a2, a3};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (p + e < pmax) o[e] = __fadd_rn(__fsub_rn(b, __fmul_rn(2.0f, a[e])), rn[e]);
          }
        }
      }
      __syncthreads();  // this stage and the LUTs are free again
      buf ^= 1;
    }
  }
}

template <bool BF16>
int launch_typed(const void* gpid, const void* pair_of_slot, const void* dlut, const void* codes,
                 const void* rnorms, const void* qc, const void* qn2, void* out, int g, int qpc,
                 int lpc, int np_, int s_, int k_, int pmax, int ts, cudaStream_t stream) {
  const int smem = 2 * s_ * ts + lpc * s_ * k_ * static_cast<int>(BF16 ? 2 : 4);
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      adc_grouped_scan_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec_codes = pmax % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const bool vec_lut = (s_ * k_) % 4 == 0 && reinterpret_cast<uintptr_t>(dlut) % 16 == 0;
  const bool vec_out = pmax % 4 == 0 && reinterpret_cast<uintptr_t>(rnorms) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  adc_grouped_scan_kernel<BF16><<<g, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(gpid), static_cast<const int32_t*>(pair_of_slot),
      static_cast<const float*>(dlut), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(rnorms), static_cast<const float*>(qc),
      static_cast<const float*>(qn2), static_cast<float*>(out), qpc, lpc, np_, s_, k_, pmax, ts,
      vec_codes, vec_lut, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block: two code stages of S x ts bytes and
// lpc LUTs of S x K entries (bf16 when lut_bf16, else f32). The wrapper's
// ops/adc.py grouped_geometry computes the same.
extern "C" int adc_grouped_scan_smem_bytes(int s_, int k_, int lpc, int ts, int lut_bf16) {
  return 2 * s_ * ts + lpc * s_ * k_ * (lut_bf16 ? 2 : 4);
}

// Static shared memory of the kernel (its pair ids, query rows and bases).
extern "C" int adc_grouped_scan_static_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, adc_grouped_scan_kernel<false>) != cudaSuccess) return -1;
  return static_cast<int>(attr.sharedSizeBytes);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Geometry from the wrapper: qpc in [1, 32], lpc >= 1, ts a positive
// multiple of 16. round_bf16 != 0 rounds the LUT to bf16 (K <= 64).
extern "C" int adc_grouped_scan_launch(
    const void* gpid, const void* pair_of_slot, const void* dlut, const void* codes,
    const void* rnorms, const void* qc, const void* qn2, void* out,
    int g, int qpc, int lpc, int np_, int s_, int k_, int pmax, int ts, int round_bf16,
    void* stream) {
  if (qpc < 1 || qpc > kMaxQpc || lpc < 1 || ts < 16 || ts % 16 != 0 || k_ < 1 || k_ > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 0 || pmax == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_bf16 ? launch_typed<true>(gpid, pair_of_slot, dlut, codes, rnorms, qc, qn2, out, g,
                                         qpc, lpc, np_, s_, k_, pmax, ts, s)
                    : launch_typed<false>(gpid, pair_of_slot, dlut, codes, rnorms, qc, qn2, out,
                                          g, qpc, lpc, np_, s_, k_, pmax, ts, s);
}

extern "C" const char* adc_grouped_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

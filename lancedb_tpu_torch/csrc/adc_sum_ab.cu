// The two inner-loop designs of the ADC scan, side by side, for Hopper
// (sm_90a): an A/B harness kernel, not on a search path.
//
// Replaces the TPU harness kernels of scripts/ab_adc8.py (`run`, with the
// cells of make_select and make_gather). For every cell c < ncells and
// slot p < pmax, with q = c mod Q and part = c mod P:
//
//   out[c, p] = sum_s dlut[q, s, codes[part, s, p]]     (f32, s = 0, 1, ...)
//
// in one of two designs, chosen by `design`. Both sum in subvector order
// from 0, each add rounded (__fadd_rn), so they give the same bits:
//   0, select: no lookup at a data-dependent shared-memory address. For the
//      current subvector, lane l of a warp holds the LUT row's entries
//      32 j + l in registers (consecutive, conflict-free reads), and code c
//      is looked up with one warp shuffle a 32-entry chunk:
//      v = (c >> 5) == j ? shfl(r_j, c & 31) : v. That is the TPU cell's
//      K-chunked compare-select with a chunk of 32 a shuffle: O(K / 32) a
//      lookup (1 shuffle at K <= 32, 8 at K 256) instead of O(K);
//   1, gather: the staged LUT read at the code's address, one read a
//      lookup. At K <= 32 a bank holds one entry of a row and repeats
//      broadcast, so a warp's reads never conflict; at K 256 its 32 reads
//      into one 256-entry row meet about 3.5 to a bank.
//
// Bound: device-memory bytes for the function (each partition's S x pmax
// code bytes once, the LUTs once, the (ncells, pmax) f32 output), with
// the lookups close behind: S per output, at best one 4-byte shared-memory
// read or shuffle a lane a clock on each SM (chip_smoke.py reports both).
// Design:
//   - grid by query: cell c uses the LUT of query c mod Q, so a block takes
//     one query q and a run of `units` of its (cell, 128-slot tile) units
//     (cells c = q + Q i, tile fastest) and stages its S x K LUT once, with
//     16-byte cp.async copies. The grid is one wave: as many blocks as the
//     card holds at once (kBlocksPerSm an SM, fewer where shared memory
//     allows fewer). A block per (cell, slot tile) staged the LUT 12,800
//     times a scan at the reference's inputs (210 MB of L2 reads at 8 bits
//     for 2.1 MB of LUTs); a grid of more blocks than the card holds ran a
//     second, nearly empty wave;
//   - a unit is one warp's work: 32 lanes x 4 consecutive slots. Each warp
//     takes every kWarps-th unit of its block and streams their codes
//     through two shared-memory stages of its own (S x 128 bytes each):
//     the next unit's codes load while the current ones are summed, and
//     no barrier of the block waits on the slowest warp. Copies are
//     16-byte cp.async, or 8 or 4 bytes where pmax or the codes' address
//     allows no more, or plain byte loads; where the LUT leaves no room
//     for the stages, each lane reads its codes from device memory;
//   - a lane reads one 4-byte code word a subvector (consecutive words
//     across the warp: no bank conflict), makes 4 lookups with it and
//     writes its 4 outputs with one 16-byte store. Every lane of a warp
//     takes part in each shuffle; a lane past a ragged unit's slots looks
//     up code 0 and stores nothing.
// The launch geometry is computed here (geometry()) from the card's SM
// count and shared-memory limit; ops/probe_kernels.py adc_sum_geometry
// computes the same, and adc_sum_ab_geometry returns this one.
//
// Measured (PERF.md §6, H100 80GB HBM3 at 700 W, the probe's inputs): the
// kernel is bound by its instructions and its code bytes, not by the
// lookups alone: about 4 instructions a lookup in the gather's loop (byte
// extract, address, read, add). The full-unit staging takes no division,
// and a warp's next unit is found by adding, not dividing: both showed on
// the card. Slower there and not kept: LUT rows padded to K + 1 (a warp's
// 32 lookups all read one row, so padding moves no conflict), a third
// stage a warp, blocks of 4 warps, and every lane reading its codes from
// device memory (the stageless route, kept only where the LUT leaves no
// room for stages). The select at K 256 is bound by its 8 shuffles a
// lookup.
//
// nvcc -Xptxas -v (CUDA 12.9, sm_90a): 56-64 registers, no spills.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 128;       // slots of a unit: 32 lanes x 4
constexpr int kBlocksPerSm = 4;   // blocks an SM the grid aims at, at most
constexpr int kSmemReserved = 1024;  // shared memory the card keeps a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem));
}
template <int N>  // 4 or 8 bytes
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" :: "r"(dst), "l"(gmem), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// One warp stages a unit's codes: S rows of kSlots bytes, row s holding
// the `rows` codes of subvector s from `src` (row stride pmax). `width`
// 16, 8 or 4: cp.async copies (rows is then a multiple of width); 1: plain
// loads, zero past the rows up to a whole word.
__device__ __forceinline__ void stage_unit(uint8_t* stage, const uint8_t* __restrict__ src,
                                           int rows, int s_, int pmax, int width, int lane) {
  if (width == 1) {
    const int w = (rows + 3) & ~3;
    for (int i = lane; i < s_ * w; i += 32) {
      const int s = i / w, c = i - s * w;
      stage[s * kSlots + c] = c < rows ? src[static_cast<size_t>(s) * pmax + c] : 0;
    }
    return;
  }
  if (width == 16 && rows == kSlots) {  // a whole unit: 8 copies a row, 4 rows a step
    const int c = (lane & 7) * 16;
    for (int s = lane >> 3; s < s_; s += 4) {
      cp_async16(stage + s * kSlots + c, src + static_cast<size_t>(s) * pmax + c);
    }
    return;
  }
  const int n = rows / width;  // copies a row
  for (int i = lane; i < s_ * n; i += 32) {
    const int s = i / n, c = (i - s * n) * width;
    uint8_t* dst = stage + s * kSlots + c;
    const uint8_t* from = src + static_cast<size_t>(s) * pmax + c;
    if (width == 16) {
      cp_async16(dst, from);
    } else if (width == 8) {
      cp_async_small<8>(dst, from);
    } else {
      cp_async_small<4>(dst, from);
    }
  }
}

// The 4 codes of slots p .. p + 3 of subvector s, read from device memory
// (no stages): one 4-byte load where `width` allows, else bytes, zero
// past pmax.
__device__ __forceinline__ unsigned direct_word(const uint8_t* __restrict__ src, int s, int p,
                                                int pmax, int width) {
  const uint8_t* at = src + static_cast<size_t>(s) * pmax + p;
  if (width >= 4) return __ldg(reinterpret_cast<const unsigned*>(at));
  unsigned w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (p + e < pmax) w |= static_cast<unsigned>(__ldg(at + e)) << (8 * e);
  }
  return w;
}

// Entry `code` of the LUT row whose 32-entry chunks the warp holds in r:
// one shuffle a chunk, every lane of the warp taking part.
template <int N>
__device__ __forceinline__ float pick(const float (&r)[N], unsigned code) {
  const int lo = static_cast<int>(code & 31);
  const unsigned hi = code >> 5;
  float v = __shfl_sync(kFull, r[0], lo);
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const float t = __shfl_sync(kFull, r[j], lo);
    v = hi == static_cast<unsigned>(j) ? t : v;
  }
  return v;
}

// kChunks 0: gather; else select, the LUT row held in kChunks 32-entry
// chunks (a power of two at least K / 32). kStaged: codes through each
// warp's shared-memory stages; else each lane reads them from device memory.
template <int kChunks, bool kStaged>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) adc_sum_kernel(
    const float* __restrict__ dlut,     // (Q, S, K)
    const uint8_t* __restrict__ codes,  // (P, S, pmax)
    float* __restrict__ out,            // (ncells, pmax)
    int ncells, int q_, int p_, int s_, int k_, int pmax, int units, int code_width, int vec_lut,
    int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qa = min(q_, ncells);  // queries that own a cell
  const int q = blockIdx.x % qa;
  const int ntiles = (pmax + kSlots - 1) / kSlots;
  const int u0 = (blockIdx.x / qa) * units;  // the block's first unit of query q
  const int u1 = min(u0 + units, (ncells - q + q_ - 1) / q_ * ntiles);
  if (u0 >= u1) return;
  const int unit_bytes = s_ * kSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* mine = smem + warp * 2 * unit_bytes;  // the warp's two stages
  float* lut = reinterpret_cast<float*>(smem + (kStaged ? kWarps * 2 * unit_bytes : 0));

  const int sk = s_ * k_;
  const float* src_lut = dlut + static_cast<size_t>(q) * sk;
  if (vec_lut) {
    for (int i = threadIdx.x; i < (sk >> 2); i += kThreads) {
      cp_async16(lut + 4 * i, src_lut + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < sk; i += kThreads) lut[i] = src_lut[i];
  }
  cp_async_commit();
  // unit u: cell q + Q (u / ntiles), its codes from partition cell mod P,
  // slots from (u % ntiles) kSlots; a warp's next unit is kWarps further
  int u = u0 + warp;
  int tile = u % ntiles, cell = q + u / ntiles * q_, part = cell % p_;
  const int q_mod_p = q_ % p_;
  if (kStaged && u < u1) {
    stage_unit(mine, codes + (static_cast<size_t>(part) * s_ * pmax + tile * kSlots),
               min(kSlots, pmax - tile * kSlots), s_, pmax, code_width, lane);
  }
  cp_async_commit();
  cp_async_wait1();  // this thread's LUT copies are in
  __syncthreads();   // and every thread's

  int buf = 0;
  for (; u < u1; u += kWarps) {  // warp-uniform: every lane reaches each shuffle
    int tile_n = tile + kWarps, cell_n = cell, part_n = part;
    while (tile_n >= ntiles) {
      tile_n -= ntiles;
      cell_n += q_;
      part_n += q_mod_p;
      if (part_n >= p_) part_n -= p_;
    }
    if (kStaged && u + kWarps < u1) {
      stage_unit(mine + (buf ^ 1) * unit_bytes,
                 codes + (static_cast<size_t>(part_n) * s_ * pmax + tile_n * kSlots),
                 min(kSlots, pmax - tile_n * kSlots), s_, pmax, code_width, lane);
    }
    cp_async_commit();
    cp_async_wait1();  // this unit's codes are in
    __syncwarp();

    const int p = tile * kSlots + 4 * lane;
    const bool live = p < pmax;
    const unsigned mask = live ? 0xffffffffu : 0u;  // a dead lane looks up code 0
    const unsigned* cw = reinterpret_cast<const unsigned*>(mine + buf * unit_bytes) + lane;
    const uint8_t* src = codes + static_cast<size_t>(part) * s_ * pmax;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll (kChunks == 0 ? 8 : 1)
    for (int s = 0; s < s_; ++s) {
      unsigned w;
      if constexpr (kStaged) {
        w = cw[s * (kSlots / 4)] & mask;
      } else {
        w = live ? direct_word(src, s, p, pmax, code_width) : 0u;
      }
      const float* row = lut + s * k_;
      float v0, v1, v2, v3;
      if constexpr (kChunks == 0) {
        v0 = row[w & 0xff];
        v1 = row[(w >> 8) & 0xff];
        v2 = row[(w >> 16) & 0xff];
        v3 = row[w >> 24];
      } else {
        float r[kChunks];
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int e = 32 * j + lane;
          r[j] = e < k_ ? row[e] : 0.0f;
        }
        v0 = pick(r, w & 0xff);
        v1 = pick(r, (w >> 8) & 0xff);
        v2 = pick(r, (w >> 16) & 0xff);
        v3 = pick(r, w >> 24);
      }
      a0 = __fadd_rn(a0, v0);
      a1 = __fadd_rn(a1, v1);
      a2 = __fadd_rn(a2, v2);
      a3 = __fadd_rn(a3, v3);
    }
    if (live) {
      float* o = out + static_cast<size_t>(cell) * pmax + p;
      if (vec_out && p + 4 <= pmax) {
        *reinterpret_cast<float4*>(o) = make_float4(a0, a1, a2, a3);
      } else {
        o[0] = a0;
        if (p + 1 < pmax) o[1] = a1;
        if (p + 2 < pmax) o[2] = a2;
        if (p + 3 < pmax) o[3] = a3;
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
    buf ^= 1;
    tile = tile_n;
    cell = cell_n;
    part = part_n;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

struct Geometry {
  int units;   // (cell, 128-slot tile) units of one query a block sums
  int blocks;  // the grid
  int staged;  // 1: codes through shared-memory stages; 0: read by each lane
  int smem;    // dynamic shared memory of a block: the stages, then the LUT
};

// The stages where they fit beside the LUT; blocks resident an SM: at
// most kBlocksPerSm, as the SM's shared memory (the limit plus one
// reserve) holds; the grid: one wave of them over the queries that own a
// cell, each query's units split evenly.
Geometry geometry(int q_, int s_, int k_, int ncells, int pmax, int smem_limit, int sms) {
  const long long lut = static_cast<long long>(s_) * k_ * 4;
  long long stages = 2LL * kWarps * s_ * kSlots;
  if (stages + lut > smem_limit) stages = 0;
  const long long smem = stages + lut;
  long long resident = (smem_limit + kSmemReserved) / (smem + kSmemReserved);
  resident = resident < 1 ? 1 : resident > kBlocksPerSm ? kBlocksPerSm : resident;
  const long long qa = q_ < ncells ? q_ : ncells;
  const long long per_query = cdiv(ncells, q_) * cdiv(pmax, kSlots);  // units of query 0
  long long bpq = resident * sms / qa;
  bpq = bpq < 1 ? 1 : bpq > per_query ? per_query : bpq;
  Geometry g;
  g.units = static_cast<int>(cdiv(per_query, bpq));
  g.blocks = static_cast<int>(qa * cdiv(per_query, g.units));
  g.staged = stages > 0;
  g.smem = static_cast<int>(smem);
  return g;
}

template <int kChunks, bool kStaged>
int launch_typed(const void* dlut, const void* codes, void* out, int ncells, int q_, int p_,
                 int s_, int k_, int pmax, const Geometry& g, cudaStream_t stream) {
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      adc_sum_kernel<kChunks, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t ca = reinterpret_cast<uintptr_t>(codes);
  int width = 1;
  for (int w = 16; w >= 4; w >>= 1) {
    if (pmax % w == 0 && ca % w == 0) {
      width = w;
      break;
    }
  }
  const bool vec_lut = (s_ * k_) % 4 == 0 && reinterpret_cast<uintptr_t>(dlut) % 16 == 0;
  const bool vec_out = pmax % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  adc_sum_kernel<kChunks, kStaged><<<g.blocks, kThreads, g.smem, stream>>>(
      static_cast<const float*>(dlut), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), ncells, q_, p_, s_, k_, pmax, g.units, width, vec_lut, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// design 1: gather; 0: select with the fewest chunks (a power of two) that hold K
template <bool kStaged>
int launch_design(const void* dlut, const void* codes, void* out, int ncells, int q_, int p_,
                  int s_, int k_, int pmax, int design, const Geometry& g, cudaStream_t st) {
  int (*launch)(const void*, const void*, void*, int, int, int, int, int, int, const Geometry&,
                cudaStream_t) = &launch_typed<8, kStaged>;
  const int chunks = (k_ + 31) / 32;
  if (design == 1) {
    launch = &launch_typed<0, kStaged>;
  } else if (chunks == 1) {
    launch = &launch_typed<1, kStaged>;
  } else if (chunks == 2) {
    launch = &launch_typed<2, kStaged>;
  } else if (chunks <= 4) {
    launch = &launch_typed<4, kStaged>;
  }
  return launch(dlut, codes, out, ncells, q_, p_, s_, k_, pmax, g, st);
}

}  // namespace

// The launch geometry on a card of `sms` SMs whose blocks may use
// `smem_limit` bytes of shared memory: writes units, blocks, staged and
// smem to out[0 .. 4).
extern "C" void adc_sum_ab_geometry(int q_, int s_, int k_, int ncells, int pmax, int smem_limit,
                                    int sms, int* out) {
  const Geometry g = geometry(q_, s_, k_, ncells, pmax, smem_limit, sms);
  out[0] = g.units;
  out[1] = g.blocks;
  out[2] = g.staged;
  out[3] = g.smem;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// design 0: select, 1: gather. K in [1, 256]; the S x K f32 LUT must fit
// the card's shared memory.
extern "C" int adc_sum_ab_launch(
    const void* dlut, const void* codes, void* out,
    int ncells, int q_, int p_, int s_, int k_, int pmax, int design, void* stream) {
  if ((design != 0 && design != 1) || k_ < 1 || k_ > 256 || q_ < 1 || p_ < 1 || s_ < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ncells == 0 || pmax == 0) return 0;
  int dev = 0, sms = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (static_cast<long long>(s_) * k_ * 4 > limit) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(q_, s_, k_, ncells, pmax, limit, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (g.staged ? launch_design<true> : launch_design<false>)(
      dlut, codes, out, ncells, q_, p_, s_, k_, pmax, design, g, st);
}

extern "C" const char* adc_sum_ab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Per-pair IVF_FLAT probe scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ivf_flat_scan_pallas
// (lancedb_tpu/ops/pallas_scan.py, cell _scan_cell_kernel). For every
// (query q, probe j, slot p) with pid = probe_ids[q, j]:
//
//   out[q, j, p] = alpha[q] * (queries[q] . vectors[pid, p]) + norms[pid, p] + gamma[q]
//
// in f32 from f32 or bf16 storage: the same function as the grouped scan
// (ivf_flat_group_scan.cu) with no grouping of the pairs. Penalties
// arrive through norms (+3e38, or inf where two add up).
//
// Bound: device-memory bytes. The function must read each probed block
// once and write the (Q, NP, pmax) f32 output. A per-pair design cannot
// reach that: every (query, probe) pair reads its whole block, so a block
// probed by n queries is read n times, from device memory unless L2
// still holds it (reading each pair's block once is 2.17 GB at the
// IVF_FLAT path's shapes, about 0.65 ms at 3.35 TB/s). Grouping the pairs
// is B2's design. One thread per row, walking its row's D values with
// 4-byte loads D x 4 bytes apart from its neighbours', would leave the
// loads uncoalesced. This design streams the rows:
//   - one block of 256 threads per (query, `npb` consecutive probes of
//     it), so the query is read once per block, into registers; blocks
//     are numbered query-major, so a repeated probe of one query (and
//     its neighbours' blocks) meet the rows while L2 holds them;
//   - the probed block's rows stream through two shared-memory stages
//     of `tile_rows` rows (about 32 KB each) with 16-byte cp.async
//     copies: a tile of rows is one contiguous run of the (P, pmax, D)
//     array, so a warp's copies cover 512 contiguous bytes; the next
//     tile (or the next probe's first) loads while the current one is
//     summed;
//   - L lanes of a warp share a row (8 at D x the element size <= 512 B,
//     16 and 32 above), each taking 16-byte chunks c = lane, lane + L,
//     ... of it from shared memory and summing their products with the
//     query's chunks, held in registers, with f32 FMAs (bf16 widened
//     first); a butterfly of shuffles adds the L partial sums. A quarter
//     warp reads 128 contiguous bytes of one row: no bank conflict;
//   - the epilogue is the plain version's, rounded step by step:
//     (alpha * dot + norms) + gamma.
// Where D x the element size is not a multiple of 16 bytes (or a pointer
// is not 16-byte aligned), the same stages are filled with plain loads
// at a row pitch rounded up to 16 bytes, zero past D.
// Measured (PERF.md §6): at the IVF_FLAT path's shapes the f32 scan runs
// at about 95 % of the per-pair read time (each pair's block from device
// memory at 3.35 TB/s), bf16 storage at about 85 %; on the searcher's
// inputs, whose neighbouring probes meet in L2, below that time.
//
// nvcc -Xptxas -v (CUDA 12.9, sm_90a): 57 registers for f32 rows of up
// to 512 bytes (8 lanes x 4 chunks), 64 at 16 and 32 lanes, 112 at 32 x
// 16; 76 for bf16 rows, 168 at 32 x 16; no spills; the two stages take
// 2 x tile_rows x pitch bytes of dynamic shared memory (64 KiB at D 128).
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 16 bytes of storage → f32
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Stage rows [r0, r0 + n) of probed block `pid` at `pitch` bytes a row.
// With `vec` (pitch == D x the element size, 16-byte aligned) the rows
// are one contiguous run, copied 16 bytes a thread; else plain loads,
// zero past D.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* stage, const T* __restrict__ vectors,
                                           int pid, int pmax, int d, int r0, int n, int pitch,
                                           bool vec) {
  const T* src = vectors + (static_cast<size_t>(pid) * pmax + r0) * d;
  if (vec) {
    const int chunks = n * (pitch >> 4);
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    for (int i = threadIdx.x; i < chunks; i += kThreads) cp_async16(stage + i * 16, s + i * 16);
  } else {
    const int pe = pitch / static_cast<int>(sizeof(T));  // elements of a staged row
    for (int i = threadIdx.x; i < n * pe; i += kThreads) {
      const int r = i / pe, e = i - r * pe;
      reinterpret_cast<T*>(stage)[i] = e < d ? src[static_cast<size_t>(r) * d + e] : T(0.0f);
    }
  }
}

// L: lanes that share a row; CPL: 16-byte chunks of a row a lane takes
template <typename T, int L, int CPL>
__global__ void __launch_bounds__(kThreads) flat_scan_kernel(
    const int32_t* __restrict__ probe_ids,  // (Q, NP)
    const float* __restrict__ queries,      // (Q, D)
    const T* __restrict__ vectors,          // (P, pmax, D)
    const float* __restrict__ norms,        // (P, pmax)
    const float* __restrict__ alpha,        // (Q,)
    const float* __restrict__ gamma,        // (Q,)
    float* __restrict__ out,                // (Q, NP, pmax)
    int np_, int pmax, int d, int npb, int tile_rows, int pitch, int vec) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements of a chunk
  constexpr int RPW = 32 / L;                            // rows a warp sums at once
  extern __shared__ __align__(16) unsigned char smem[];  // 2 x tile_rows x pitch
  const int nchunk_j = (np_ + npb - 1) / npb;
  const int q = blockIdx.x / nchunk_j;
  const int j0 = (blockIdx.x - q * nchunk_j) * npb;
  const int nj = min(npb, np_ - j0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (L - 1), slot = lane / L;
  const int nchunks = pitch >> 4;

  // the query's chunks of this lane, zero past D
  float qv[CPL][EPC];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const int idx = (sub + i * L) * EPC + e;
      qv[i][e] = idx < d ? queries[static_cast<size_t>(q) * d + idx] : 0.0f;
    }
  }
  const float al = alpha[q], ga = gamma[q];
  const int ntiles = (pmax + tile_rows - 1) / tile_rows;
  const int nsteps = nj * ntiles;
  const int* pids = probe_ids + static_cast<size_t>(q) * np_ + j0;
  const int stage_bytes = tile_rows * pitch;

  stage_rows<T>(smem, vectors, pids[0], pmax, d, 0, min(tile_rows, pmax), pitch, vec);
  cp_async_commit();
  for (int step = 0; step < nsteps; ++step) {
    const int jj = step / ntiles, tile = step - jj * ntiles;
    if (step + 1 < nsteps) {  // the next step's rows into the other stage
      const int jn = (step + 1) / ntiles, tn = step + 1 - jn * ntiles;
      const int rn = tn * tile_rows;
      stage_rows<T>(smem + ((step + 1) & 1) * stage_bytes, vectors, pids[jn], pmax, d, rn,
                    min(tile_rows, pmax - rn), pitch, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's rows are in
    __syncthreads();

    const int pid = pids[jj];
    const int r0 = tile * tile_rows;
    const int rows = min(tile_rows, pmax - r0);
    const unsigned char* st = smem + (step & 1) * stage_bytes;
    float* orow = out + (static_cast<size_t>(q) * np_ + j0 + jj) * pmax + r0;
    const float* nrow = norms + static_cast<size_t>(pid) * pmax + r0;
    for (int rb = warp * RPW; rb < rows; rb += kWarps * RPW) {
      const int r = rb + slot;  // < tile_rows, a multiple of kWarps * RPW
      const T* row = reinterpret_cast<const T*>(st + r * pitch);
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = sub + i * L;
        if (c < nchunks) {
          float x[EPC];
          widen16(row + c * EPC, x);
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc = fmaf(qv[i][e], x[e], acc);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      // alpha * dot + norms + gamma, rounded step by step as the plain version
      if (sub == 0 && r < rows) {
        orow[r] = __fadd_rn(__fadd_rn(__fmul_rn(al, acc), nrow[r]), ga);
      }
    }
    __syncthreads();  // this stage is free again
  }
  cp_async_wait<0>();
}

template <typename T, int L, int CPL>
cudaError_t launch_typed(const void* probe_ids, const void* queries, const void* vectors,
                         const void* norms, const void* alpha, const void* gamma, void* out,
                         int q, int np_, int pmax, int d, int npb, int tile_rows, int pitch,
                         cudaStream_t stream) {
  const int smem = 2 * tile_rows * pitch;
  auto kernel = flat_scan_kernel<T, L, CPL>;
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const bool vec = pitch == d * static_cast<int>(sizeof(T)) &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(q) * ((np_ + npb - 1) / npb);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(probe_ids), static_cast<const float*>(queries),
      static_cast<const T*>(vectors), static_cast<const float*>(norms),
      static_cast<const float*>(alpha), static_cast<const float*>(gamma),
      static_cast<float*>(out), np_, pmax, d, npb, tile_rows, pitch, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lanes(const void* probe_ids, const void* queries, const void* vectors,
                         const void* norms, const void* alpha, const void* gamma, void* out,
                         int q, int np_, int pmax, int d, int npb, int tile_rows, int pitch,
                         int lanes, int cpl, cudaStream_t stream) {
#define LAUNCH(L, C)                                                                        \
  return launch_typed<T, L, C>(probe_ids, queries, vectors, norms, alpha, gamma, out, q, np_, \
                               pmax, d, npb, tile_rows, pitch, stream)
  if (lanes == 8 && cpl == 4) LAUNCH(8, 4);
  if (lanes == 16 && cpl == 4) LAUNCH(16, 4);
  if (lanes == 32 && cpl == 4) LAUNCH(32, 4);
  if (lanes == 32 && cpl == 16) LAUNCH(32, 16);
#undef LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one block: two stages of tile_rows rows at
// `pitch` bytes. The wrapper's ops/flat_scan.py pair_geometry computes
// the same.
extern "C" int ivf_flat_scan_smem_bytes(int tile_rows, int pitch) {
  return 2 * tile_rows * pitch;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// bf16 != 0: vectors hold bfloat16, else float32. Geometry from the
// wrapper: npb probes a block, tile_rows rows a stage (a multiple of
// 8 x 32 / lanes), pitch bytes a staged row (D x the element size
// rounded up to 16), lanes x cpl chunks of 16 bytes covering a row.
extern "C" int ivf_flat_scan_launch(
    const void* probe_ids, const void* queries, const void* vectors, const void* norms,
    const void* alpha, const void* gamma, void* out,
    int q, int np_, int pmax, int d, int bf16, int npb, int tile_rows, int pitch, int lanes,
    int cpl, void* stream) {
  const int esize = bf16 ? 2 : 4;
  const int need = (d * esize + 15) / 16 * 16;
  if (npb < 1 || lanes < 1 || tile_rows < 1 || tile_rows % (kWarps * (32 / lanes)) != 0 ||
      pitch != need || (pitch / 16) > lanes * cpl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q == 0 || np_ == 0 || pmax == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_lanes<__nv_bfloat16>(probe_ids, queries, vectors, norms, alpha, gamma, out,
                                         q, np_, pmax, d, npb, tile_rows, pitch, lanes, cpl, s)
           : launch_lanes<float>(probe_ids, queries, vectors, norms, alpha, gamma, out, q, np_,
                                 pmax, d, npb, tile_rows, pitch, lanes, cpl, s);
  return static_cast<int>(e);
}

extern "C" const char* ivf_flat_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

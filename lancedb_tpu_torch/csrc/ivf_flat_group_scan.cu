// Query-grouped IVF_FLAT probe scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ivf_flat_grouped_scan_pallas
// (lancedb_tpu/ops/pallas_group_scan.py, cell _group_cell_kernel). For
// every (query q, probe j, slot p) with pid = probe_ids[q, j]:
//
//   out[q, j, p] = alpha[q] * (queries[q] . vectors[pid, p]) + norms[pid, p] + gamma[q]
//
// in f32 (no TF32, no tensor cores: the reference holds this product to
// full f32, and TF32 would reorder near-ties). The (query, probe) pairs
// arrive grouped by partition (the plan of csrc/group_plan.cu, or its
// plain version ops/util.py grouped_plan_reference): group g covers
// partition gpid[g] and up to qpc pairs, pair_of_slot[g * qpc + i] =
// q * NP + j, or -1 on padding, real slots first. Padding, filter and
// delete penalties arrive through norms (+3e38, or inf where two add up).
//
// Bound: device-memory bytes. The function must read each probed
// partition block once (pmax x D storage elements, 518 MB on the main
// path's 827 blocks) and write the (Q, NP, pmax) f32 output; its 2D FMAs
// per output (about 1.1 GFLOP per call) are far below the card's f32
// rate. So the loads must overlap the FMAs: a tile staged through
// registers with 4-byte loads between two barriers leaves the memory idle
// while it is summed. This design keeps bytes in flight:
//   - one block of 128 threads per (group, 256-slot tile); each thread
//     owns 2 slots (rows t and t + 128) and all of the group's queries,
//     a register tile of 2 x qpc sums, so one shared-memory read of a
//     query feeds 8 FMAs and one of a row feeds 4 x (live queries);
//   - the tile streams through a ring of 2 shared-memory stages of 64
//     bytes per row (16 f32 or 32 bf16 dimensions) with 16-byte cp.async
//     copies (zero-filled past the block's rows and the last dimension),
//     so the next slab loads while the current one is summed (a third
//     stage made blocks larger, fewer per SM, and the kernel slower); the
//     group's query slabs ride in the same stages. Each copy asks L2 for
//     the whole 128-byte line (.L2::128B), so the slab after it finds
//     its half of the line in L2 rather than in device memory;
//   - rows sit 80 bytes apart, so the 16-byte reads of 8 neighbouring
//     rows fall in distinct banks; bf16 rows widen to f32 as they are
//     read from shared memory (no converted copy of the table);
//   - only the group's live queries are summed (the main path averages
//     3.8 per group at qpc 8), and a group of padding only returns at
//     once after one load per thread.
// Where D x the element size is not a multiple of 16 bytes (or a pointer
// is not 16-byte aligned) the same ring is filled with plain loads.
// Each real slot's row goes straight to out[q, j]; padded slots are
// never written. A partition probed by more than qpc queries is read
// once per group; its later groups usually find it in L2.
//
// nvcc -Xptxas -v (cuda_build.build_logs, CUDA 12.9, sm_90a): 80-168
// registers across the 16 instantiations (f32 storage with 16-byte
// copies, the main path's: 110 / 124 / 125 / 138 at qpc <= 4 / 8 / 16 /
// 32; with plain loads 80 / 96 / 128 / 168), no spills, 512
// bytes of static shared memory; the two stages take 2 x (256 x 80 +
// qmax x 64) bytes of dynamic shared memory for f32 (41,984 at qpc 8) and
// 2 x (256 x 80 + qmax x 128) for bf16 (49,152 at qpc 32, which opts in
// above 48 KB).
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2 * kThreads;   // slots of one tile, 2 per thread
constexpr int kRowBytes = 64;         // bytes of a row in one stage
constexpr int kVecs = kRowBytes / 16;  // 16-byte vectors of a row in one stage
constexpr int kPitch = kRowBytes + 16;  // 80 B apart: conflict-free 16-byte reads
constexpr int kStages = 2;
constexpr int kMaxQpc = 32;

template <typename T>
__host__ __device__ constexpr int dims_per_stage() { return kRowBytes / static_cast<int>(sizeof(T)); }

template <typename T, int QMAX>
__host__ __device__ constexpr int stage_bytes() {
  return kRows * kPitch + QMAX * dims_per_stage<T>() * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
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

// Fill one stage with slab `slab` (dimensions slab * DC ...) of the tile
// and of the live queries, zero past the tile's rows and past D.
template <typename T, int QMAX, bool VEC>
__device__ __forceinline__ void stage_slab(
    char* stage, const T* __restrict__ block, const float* __restrict__ queries,
    const int* qrow, int nq, int rows, int d, int slab) {
  constexpr int DC = dims_per_stage<T>();
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte vector
  const int t = threadIdx.x;
  const int d0 = slab * DC;
  float* qs = reinterpret_cast<float*>(stage + kRows * kPitch);
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < kRows * kVecs / kThreads; ++k) {
      const int c = t + k * kThreads;
      const int row = c / kVecs, v = c % kVecs;
      const int dim = d0 + v * EPV;
      const bool ok = row < rows && dim < d;
      cp_async16(stage + row * kPitch + v * 16,
                 ok ? block + static_cast<size_t>(row) * d + dim : block, ok ? 16 : 0);
    }
    for (int c = t; c < nq * (DC / 4); c += kThreads) {
      const int j = c / (DC / 4), v = c % (DC / 4);
      const int dim = d0 + v * 4;
      const bool ok = dim < d;
      const float* src = queries + static_cast<size_t>(qrow[j]) * d;
      cp_async16(qs + j * DC + v * 4, ok ? src + dim : src, ok ? 16 : 0);
    }
  } else {
    for (int c = t; c < kRows * DC; c += kThreads) {
      const int row = c / DC, e = c % DC;
      const bool ok = row < rows && d0 + e < d;
      reinterpret_cast<T*>(stage + row * kPitch)[e] =
          ok ? block[static_cast<size_t>(row) * d + d0 + e] : T(0.0f);
    }
    for (int c = t; c < nq * DC; c += kThreads) {
      const int j = c / DC, e = c % DC;
      qs[j * DC + e] = d0 + e < d ? queries[static_cast<size_t>(qrow[j]) * d + d0 + e] : 0.0f;
    }
  }
  (void)EPV;
}

// QMAX: the most queries of a group this instantiation sums (>= qpc)
template <typename T, int QMAX, bool VEC>
__global__ void __launch_bounds__(kThreads, 3) group_scan_kernel(
    const int32_t* __restrict__ gpid,          // (G,)
    const int32_t* __restrict__ pair_of_slot,  // (G * qpc,), -1 on padding
    const float* __restrict__ queries,         // (Q, D)
    const T* __restrict__ vectors,             // (P, pmax, D)
    const float* __restrict__ norms,           // (P, pmax)
    const float* __restrict__ alpha,           // (Q,)
    const float* __restrict__ gamma,           // (Q,)
    float* __restrict__ out,                   // (Q * NP, pmax)
    int qpc, int np_, int pmax, int d) {
  constexpr int DC = dims_per_stage<T>();
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) char smem[];
  __shared__ int pairs[kMaxQpc], qrow[kMaxQpc];
  __shared__ float al[kMaxQpc], ga[kMaxQpc];
  const int t = threadIdx.x;
  const int grp = blockIdx.x;
  const int p0 = blockIdx.y * kRows;
  // the plan first, in one round of loads: pid, and the group's pairs
  const int pid = gpid[grp];
  const int mine = t < qpc ? pair_of_slot[static_cast<size_t>(grp) * qpc + t] : -1;
  // slots fill each group front first: the live ones are 0 .. nq - 1
  const int nq = __syncthreads_count(mine >= 0);
  if (nq == 0) return;  // a group of padding only
  if (t < nq) {
    pairs[t] = mine;
    qrow[t] = mine / np_;
  }
  __syncthreads();

  const int rows = min(kRows, pmax - p0);
  const T* block = vectors + (static_cast<size_t>(pid) * pmax + p0) * d;
  float acc0[QMAX], acc1[QMAX];
#pragma unroll
  for (int j = 0; j < QMAX; ++j) acc0[j] = acc1[j] = 0.0f;

  const int nslab = (d + DC - 1) / DC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslab)
      stage_slab<T, QMAX, VEC>(smem + s * stage_bytes<T, QMAX>(), block, queries, qrow, nq,
                               rows, d, s);
    cp_async_commit();
  }
  if (t < nq) {  // needed in the epilogue only: loaded while the ring fills
    al[t] = alpha[qrow[t]];
    ga[t] = gamma[qrow[t]];
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab s is in; every thread is done with slab s - 1's stage
    const int nx = s + kStages - 1;
    if (nx < nslab)
      stage_slab<T, QMAX, VEC>(smem + (nx % kStages) * stage_bytes<T, QMAX>(), block, queries,
                               qrow, nq, rows, d, nx);
    cp_async_commit();

    const char* stage = smem + (s % kStages) * stage_bytes<T, QMAX>();
    const float* qs = reinterpret_cast<const float*>(stage + kRows * kPitch);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      float xa[EPV], xb[EPV];
      widen16(reinterpret_cast<const T*>(stage + t * kPitch + v * 16), xa);
      widen16(reinterpret_cast<const T*>(stage + (t + kThreads) * kPitch + v * 16), xb);
#pragma unroll
      for (int e = 0; e < EPV; e += 4) {
#pragma unroll
        for (int j = 0; j < QMAX; ++j) {
          if (j < nq) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + j * DC + v * EPV + e);
            acc0[j] = fmaf(qv.x, xa[e], acc0[j]);
            acc0[j] = fmaf(qv.y, xa[e + 1], acc0[j]);
            acc0[j] = fmaf(qv.z, xa[e + 2], acc0[j]);
            acc0[j] = fmaf(qv.w, xa[e + 3], acc0[j]);
            acc1[j] = fmaf(qv.x, xb[e], acc1[j]);
            acc1[j] = fmaf(qv.y, xb[e + 1], acc1[j]);
            acc1[j] = fmaf(qv.z, xb[e + 2], acc1[j]);
            acc1[j] = fmaf(qv.w, xb[e + 3], acc1[j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // alpha * dot + norms + gamma, rounded step by step as the plain version
  const float* nrow = norms + static_cast<size_t>(pid) * pmax + p0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t + h * kThreads;
    if (r >= rows) continue;
    const float nrm = nrow[r];
#pragma unroll
    for (int j = 0; j < QMAX; ++j) {
      if (j < nq) {
        const float a = h == 0 ? acc0[j] : acc1[j];
        out[static_cast<size_t>(pairs[j]) * pmax + p0 + r] =
            __fadd_rn(__fadd_rn(__fmul_rn(al[j], a), nrm), ga[j]);
      }
    }
  }
}

template <typename T, int QMAX, bool VEC>
cudaError_t launch_typed(const void* gpid, const void* pair_of_slot, const void* queries,
                         const void* vectors, const void* norms, const void* alpha,
                         const void* gamma, void* out, int g, int qpc, int np_, int pmax,
                         int d, cudaStream_t stream) {
  constexpr int smem = kStages * stage_bytes<T, QMAX>();
  // the opt-in above 48 KB holds per device, so it is set on every launch
  // (microseconds), as adc_scan.cu and group_plan.cu do
  const cudaError_t e = cudaFuncSetAttribute(
      group_scan_kernel<T, QMAX, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(g), (pmax + kRows - 1) / kRows);
  group_scan_kernel<T, QMAX, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(gpid), static_cast<const int32_t*>(pair_of_slot),
      static_cast<const float*>(queries), static_cast<const T*>(vectors),
      static_cast<const float*>(norms), static_cast<const float*>(alpha),
      static_cast<const float*>(gamma), static_cast<float*>(out), qpc, np_, pmax, d);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_qmax(const void* gpid, const void* pair_of_slot, const void* queries,
                        const void* vectors, const void* norms, const void* alpha,
                        const void* gamma, void* out, int g, int qpc, int np_, int pmax, int d,
                        cudaStream_t stream) {
#define LAUNCH(N)                                                                           \
  return launch_typed<T, N, VEC>(gpid, pair_of_slot, queries, vectors, norms, alpha, gamma, \
                                 out, g, qpc, np_, pmax, d, stream)
  if (qpc <= 4) LAUNCH(4);
  if (qpc <= 8) LAUNCH(8);
  if (qpc <= 16) LAUNCH(16);
  LAUNCH(32);
#undef LAUNCH
}

template <typename T>
cudaError_t launch_storage(const void* gpid, const void* pair_of_slot, const void* queries,
                           const void* vectors, const void* norms, const void* alpha,
                           const void* gamma, void* out, int g, int qpc, int np_, int pmax,
                           int d, cudaStream_t stream) {
  // 16-byte copies need 16-byte rows and 16-byte aligned bases
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  return vec ? launch_qmax<T, true>(gpid, pair_of_slot, queries, vectors, norms, alpha, gamma,
                                    out, g, qpc, np_, pmax, d, stream)
             : launch_qmax<T, false>(gpid, pair_of_slot, queries, vectors, norms, alpha, gamma,
                                     out, g, qpc, np_, pmax, d, stream);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// bf16 != 0: vectors hold bfloat16, else float32. qpc in [1, 32].
extern "C" int ivf_flat_group_scan_launch(
    const void* gpid, const void* pair_of_slot, const void* queries, const void* vectors,
    const void* norms, const void* alpha, const void* gamma, void* out,
    int g, int qpc, int np_, int pmax, int d, int bf16, void* stream) {
  if (qpc < 1 || qpc > kMaxQpc) return static_cast<int>(cudaErrorInvalidValue);
  if (g == 0 || pmax == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_storage<__nv_bfloat16>(gpid, pair_of_slot, queries, vectors, norms, alpha,
                                           gamma, out, g, qpc, np_, pmax, d, s)
           : launch_storage<float>(gpid, pair_of_slot, queries, vectors, norms, alpha, gamma,
                                   out, g, qpc, np_, pmax, d, s);
  return static_cast<int>(e);
}

extern "C" const char* ivf_flat_group_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

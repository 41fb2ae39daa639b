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
// arrive grouped by partition (ops/util.py group_probe_pairs, flattened
// by ops/flat_scan.py grouped_plan): group g covers partition gpid[g]
// and up to qpc pairs, pair_of_slot[g * qpc + i] = q * NP + j or -1 on
// padding. Padding, filter and delete penalties arrive through norms
// (+3e38, or inf where two add up).
//
// Bound: device-memory bytes. The function must read each probed
// partition block once (pmax x D storage elements) and write the
// (Q, NP, pmax) f32 output; its 2D FMAs per output are far below the
// card's f32 rate at D = 128. Design (simple first): one block per
// (group, 64-slot tile). The block stages the group's <= qpc query
// vectors and a 64 x 64 tile of its partition block in shared memory,
// one 64-dim slab at a time, so a block read from device memory serves
// every query of the group; bf16 storage widens to f32 on the way into
// shared memory (no converted copy of the table). Each thread owns one
// slot of the tile and ceil(qpc / 4) queries and accumulates their dots
// with f32 FMAs from float4 shared-memory reads (a row stride of 68
// floats keeps them free of bank conflicts). Each real slot's row goes
// straight to out[q, j]; padded slots are never written, and a group of
// padding only returns at once. A partition probed by more than qpc
// queries is read once per group; TMA staging and a ring of tiles are
// later work.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                  // slots of one tile
constexpr int kQLanes = kThreads / kRows;  // threads sharing one slot
constexpr int kDc = 64;                    // dimensions staged per pass
constexpr int kTileStride = kDc + 4;       // float4 reads without bank conflicts
constexpr int kMaxQpc = 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// QPT: queries per thread, ceil(qpc / kQLanes)
template <typename T, int QPT>
__global__ void __launch_bounds__(kThreads) group_scan_kernel(
    const int32_t* __restrict__ gpid,          // (G,)
    const int32_t* __restrict__ pair_of_slot,  // (G * qpc,), -1 on padding
    const float* __restrict__ queries,         // (Q, D)
    const T* __restrict__ vectors,             // (P, pmax, D)
    const float* __restrict__ norms,           // (P, pmax)
    const float* __restrict__ alpha,           // (Q,)
    const float* __restrict__ gamma,           // (Q,)
    float* __restrict__ out,                   // (Q * NP, pmax)
    int qpc, int np_, int pmax, int d) {
  __shared__ __align__(16) float tile[kRows * kTileStride];
  __shared__ __align__(16) float qs[kMaxQpc * kDc];
  __shared__ int pairs[kMaxQpc];
  const int t = threadIdx.x;
  const int grp = blockIdx.x;
  const int p0 = blockIdx.y * kRows;
  if (t < kMaxQpc) {
    pairs[t] = t < qpc ? pair_of_slot[static_cast<size_t>(grp) * qpc + t] : -1;
  }
  __syncthreads();
  // slots fill each group front first, so this is a group of padding only
  if (pairs[0] < 0) return;

  const int pid = gpid[grp];
  const int rows = min(kRows, pmax - p0);
  const T* block = vectors + (static_cast<size_t>(pid) * pmax + p0) * d;
  const int r = t % kRows;
  const int lane = t / kRows;
  float acc[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) acc[j] = 0.0f;

  for (int d0 = 0; d0 < d; d0 += kDc) {
    const int dc = min(kDc, d - d0);
    // a 64 x 64 slab of the block, zero past its edges (rows and dims)
    for (int i = t; i < kRows * kDc; i += kThreads) {
      const int rr = i / kDc, cc = i % kDc;
      tile[rr * kTileStride + cc] =
          (rr < rows && cc < dc) ? widen(block[static_cast<size_t>(rr) * d + d0 + cc]) : 0.0f;
    }
    for (int i = t; i < qpc * kDc; i += kThreads) {
      const int s = i / kDc, cc = i % kDc;
      const int pair = pairs[s];
      qs[i] = (pair >= 0 && cc < dc)
                  ? queries[static_cast<size_t>(pair / np_) * d + d0 + cc] : 0.0f;
    }
    __syncthreads();
    const float4* trow = reinterpret_cast<const float4*>(tile + r * kTileStride);
    const int n4 = (dc + 3) / 4;
    for (int c4 = 0; c4 < n4; ++c4) {
      const float4 x = trow[c4];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int s = lane + j * kQLanes;
        if (s < qpc) {
          const float4 qv = reinterpret_cast<const float4*>(qs + s * kDc)[c4];
          acc[j] = fmaf(qv.x, x.x, acc[j]);
          acc[j] = fmaf(qv.y, x.y, acc[j]);
          acc[j] = fmaf(qv.z, x.z, acc[j]);
          acc[j] = fmaf(qv.w, x.w, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  if (r >= rows) return;
  const float nrm = norms[static_cast<size_t>(pid) * pmax + p0 + r];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int s = lane + j * kQLanes;
    if (s < qpc && pairs[s] >= 0) {
      const int pair = pairs[s];
      const int q = pair / np_;
      // alpha * dot + norms + gamma, rounded step by step as the plain version
      out[static_cast<size_t>(pair) * pmax + p0 + r] =
          __fadd_rn(__fadd_rn(__fmul_rn(alpha[q], acc[j]), nrm), gamma[q]);
    }
  }
}

template <typename T, int QPT>
cudaError_t launch_typed(const void* gpid, const void* pair_of_slot, const void* queries,
                         const void* vectors, const void* norms, const void* alpha,
                         const void* gamma, void* out, int g, int qpc, int np_, int pmax,
                         int d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(g), (pmax + kRows - 1) / kRows);
  group_scan_kernel<T, QPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(gpid), static_cast<const int32_t*>(pair_of_slot),
      static_cast<const float*>(queries), static_cast<const T*>(vectors),
      static_cast<const float*>(norms), static_cast<const float*>(alpha),
      static_cast<const float*>(gamma), static_cast<float*>(out), qpc, np_, pmax, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_storage(const void* gpid, const void* pair_of_slot, const void* queries,
                           const void* vectors, const void* norms, const void* alpha,
                           const void* gamma, void* out, int g, int qpc, int np_, int pmax,
                           int d, cudaStream_t stream) {
  const int qpt = (qpc + kQLanes - 1) / kQLanes;
#define LAUNCH(N)                                                                      \
  return launch_typed<T, N>(gpid, pair_of_slot, queries, vectors, norms, alpha, gamma, \
                            out, g, qpc, np_, pmax, d, stream)
  if (qpt <= 1) LAUNCH(1);
  if (qpt <= 2) LAUNCH(2);
  if (qpt <= 4) LAUNCH(4);
  LAUNCH(8);
#undef LAUNCH
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// bf16 != 0: vectors hold bfloat16, else float32. qpc in [1, 32].
extern "C" int ivf_flat_group_scan_launch(
    const void* gpid, const void* pair_of_slot, const void* queries, const void* vectors,
    const void* norms, const void* alpha, const void* gamma, void* out,
    int g, int qpc, int np_, int pmax, int d, int bf16, void* stream) {
  if (qpc < 1 || qpc > kMaxQpc) return static_cast<int>(cudaErrorInvalidValue);
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

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
// once and write the (Q, NP, pmax) f32 output. This design does not
// reach that: every (query, probe) pair reads its whole block, so a
// block probed by n queries is read n times (from L2 where it stays
// there). Design (simple first): one block per (pair, 128-slot tile),
// one thread per slot; the query sits in shared memory and each thread
// walks the D dimensions of its own row with f32 FMAs. Neighbouring
// threads read rows D elements apart, so each load is served through
// L1 rather than as one coalesced transaction; staging the tile through
// shared memory as the grouped scan does is the fix if this kernel ever
// carries a path.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) flat_scan_kernel(
    const int32_t* __restrict__ probe_ids,  // (Q, NP)
    const float* __restrict__ queries,      // (Q, D)
    const T* __restrict__ vectors,          // (P, pmax, D)
    const float* __restrict__ norms,        // (P, pmax)
    const float* __restrict__ alpha,        // (Q,)
    const float* __restrict__ gamma,        // (Q,)
    float* __restrict__ out,                // (Q, NP, pmax)
    int np_, int pmax, int d) {
  extern __shared__ float qsh[];  // D
  const int pair = blockIdx.x;    // q * NP + j
  const int q = pair / np_;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    qsh[i] = queries[static_cast<size_t>(q) * d + i];
  }
  __syncthreads();

  const int p = blockIdx.y * kThreads + threadIdx.x;
  if (p >= pmax) return;
  const int pid = probe_ids[pair];
  const T* row = vectors + (static_cast<size_t>(pid) * pmax + p) * d;
  float acc = 0.0f;
  for (int c = 0; c < d; ++c) acc = fmaf(qsh[c], widen(row[c]), acc);
  // alpha * dot + norms + gamma, rounded step by step as the plain version
  out[static_cast<size_t>(pair) * pmax + p] = __fadd_rn(
      __fadd_rn(__fmul_rn(alpha[q], acc), norms[static_cast<size_t>(pid) * pmax + p]), gamma[q]);
}

template <typename T>
cudaError_t launch_typed(const void* probe_ids, const void* queries, const void* vectors,
                         const void* norms, const void* alpha, const void* gamma, void* out,
                         int q, int np_, int pmax, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flat_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(q) * np_, (pmax + kThreads - 1) / kThreads);
  flat_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(probe_ids), static_cast<const float*>(queries),
      static_cast<const T*>(vectors), static_cast<const float*>(norms),
      static_cast<const float*>(alpha), static_cast<const float*>(gamma),
      static_cast<float*>(out), np_, pmax, d);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// bf16 != 0: vectors hold bfloat16, else float32.
extern "C" int ivf_flat_scan_launch(
    const void* probe_ids, const void* queries, const void* vectors, const void* norms,
    const void* alpha, const void* gamma, void* out,
    int q, int np_, int pmax, int d, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_typed<__nv_bfloat16>(probe_ids, queries, vectors, norms, alpha, gamma, out,
                                         q, np_, pmax, d, s)
           : launch_typed<float>(probe_ids, queries, vectors, norms, alpha, gamma, out,
                                 q, np_, pmax, d, s);
  return static_cast<int>(e);
}

extern "C" const char* ivf_flat_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

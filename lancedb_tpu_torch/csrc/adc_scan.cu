// Fused IVF_PQ ADC probe scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ivf_pq_adc_scan_pallas
// (lancedb_tpu/ops/pallas_adc.py, cells _adc_cell_kernel_gather and
// _adc_cell_kernel_select). For every (query q, probe j, slot p):
//
//   pid          = probe_ids[q, j]
//   out[q, j, p] = qn2[q] - 2 * (qc[q, j] + sum_s dlut[q, s, codes[pid, s, p]])
//                  + rnorms[pid, p]
//
// in the order _adc_cell_kernel_select uses. Padding, filter and delete
// penalties arrive through rnorms (+3e38, or inf where two add up), so
// the kernel never branches on them. One kernel serves 4-bit (K = 16)
// and 8-bit (K = 256) codes; padded subvectors hold code 0 against zero
// LUT rows.
//
// Bound: device-memory bytes. Per (query, probe) pair the scan reads the
// partition's S x pmax code bytes and pmax rnorms, and writes pmax f32
// distances; the arithmetic is S adds per slot, far below the card's
// f32 rate. Design (simple first): one block per (pair, 256-slot tile),
// one thread per slot. The block stages the query's S x K f32 LUT in
// shared memory, so the per-subvector table lookups are shared-memory
// reads; each thread walks s reading codes[pid, s, p], which is
// coalesced along p in the (P, S, pmax) layout. Staging the LUT once per
// tile re-reads it from L2 for every tile; sharing one code block among
// the queries that probe it (the grouped shape of
// ivf_pq_adc_grouped_scan_pallas) and wider code loads are later work.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void adc_scan_kernel(
    const int32_t* __restrict__ probe_ids,  // (Q, NP)
    const float* __restrict__ dlut,         // (Q, S, K)
    const uint8_t* __restrict__ codes,      // (P, S, pmax)
    const float* __restrict__ rnorms,       // (P, pmax)
    const float* __restrict__ qc,           // (Q, NP)
    const float* __restrict__ qn2,          // (Q,)
    float* __restrict__ out,                // (Q, NP, pmax)
    int np_, int s_, int k_, int pmax) {
  extern __shared__ float lut[];  // S * K
  const int pair = blockIdx.x;    // q * NP + j
  const int q = pair / np_;
  const int sk = s_ * k_;
  const float* src = dlut + static_cast<size_t>(q) * sk;
  for (int i = threadIdx.x; i < sk; i += blockDim.x) lut[i] = src[i];
  __syncthreads();

  const int p = blockIdx.y * kThreads + threadIdx.x;
  if (p >= pmax) return;
  const int pid = probe_ids[pair];
  const uint8_t* c = codes + static_cast<size_t>(pid) * s_ * pmax + p;
  float acc = 0.0f;
  for (int s = 0; s < s_; ++s) {
    acc += lut[s * k_ + c[static_cast<size_t>(s) * pmax]];
  }
  const float qdotx = qc[pair] + acc;
  out[static_cast<size_t>(pair) * pmax + p] =
      qn2[q] - 2.0f * qdotx + rnorms[static_cast<size_t>(pid) * pmax + p];
}

}  // namespace

extern "C" int adc_scan_max_smem_bytes() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int adc_scan_launch(
    const void* probe_ids, const void* dlut, const void* codes, const void* rnorms,
    const void* qc, const void* qn2, void* out,
    int q, int np_, int s_, int k_, int pmax, void* stream) {
  const size_t smem = static_cast<size_t>(s_) * k_ * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(q) * np_, (pmax + kThreads - 1) / kThreads);
  adc_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe_ids), static_cast<const float*>(dlut),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(rnorms),
      static_cast<const float*>(qc), static_cast<const float*>(qn2),
      static_cast<float*>(out), np_, s_, k_, pmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adc_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

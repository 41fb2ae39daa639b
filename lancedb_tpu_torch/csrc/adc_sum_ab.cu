// The two inner-loop designs of the ADC scan, side by side, for Hopper
// (sm_90a): an A/B harness kernel, not on a search path.
//
// Replaces the TPU harness kernels of scripts/ab_adc8.py (`run`, with the
// cells of make_select and make_gather). For every cell c < ncells and
// slot p < pmax, with q = c mod Q and part = c mod P:
//
//   out[c, p] = sum_s dlut[q, s, codes[part, s, p]]     (f32, s = 0, 1, ...)
//
// in one of two designs, chosen by `design`:
//   0, select: per slot and subvector, a compare-select sweep over the K
//      codebook entries (v = code == k ? lut[s, k] : v), O(S*K) per slot.
//      Every thread reads the same LUT word at each step, so the
//      shared-memory reads are broadcasts and never conflict;
//   1, gather: the LUT looked up by code, O(S) per slot, at addresses that
//      differ per thread, so the reads can collide in shared-memory banks.
// Both sum in subvector order and give the same bits.
//
// Bound: device-memory bytes. The function reads each partition's S x pmax
// code bytes once, the LUTs once, and writes the (ncells, pmax) f32
// output; S adds per output are far below the card's f32 rate (select
// spends S*K compare-selects per output on top, which is what it
// measures). Design (simple first): one block per (cell, 256-slot tile),
// one thread per slot, the query's S x K f32 LUT staged in shared memory
// per block, as B1 (csrc/adc_scan.cu) does.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kSelect>
__global__ void __launch_bounds__(kThreads) adc_sum_kernel(
    const float* __restrict__ dlut,     // (Q, S, K)
    const uint8_t* __restrict__ codes,  // (P, S, pmax)
    float* __restrict__ out,            // (ncells, pmax)
    int q_, int p_, int s_, int k_, int pmax) {
  extern __shared__ float lut[];  // S * K
  const int cell = blockIdx.x;
  const int sk = s_ * k_;
  const float* src = dlut + static_cast<size_t>(cell % q_) * sk;
  for (int i = threadIdx.x; i < sk; i += kThreads) lut[i] = src[i];
  __syncthreads();

  const int p = blockIdx.y * kThreads + threadIdx.x;
  if (p >= pmax) return;
  const uint8_t* c = codes + static_cast<size_t>(cell % p_) * s_ * pmax + p;
  float acc = 0.0f;
  for (int s = 0; s < s_; ++s) {
    const int code = c[static_cast<size_t>(s) * pmax];
    const float* row = lut + s * k_;
    float v;
    if (kSelect) {
      v = 0.0f;
      for (int k = 0; k < k_; ++k) v = code == k ? row[k] : v;
    } else {
      v = row[code];
    }
    acc = __fadd_rn(acc, v);
  }
  out[static_cast<size_t>(cell) * pmax + p] = acc;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// design 0: select, 1: gather.
extern "C" int adc_sum_ab_launch(
    const void* dlut, const void* codes, void* out,
    int ncells, int q_, int p_, int s_, int k_, int pmax, int design, void* stream) {
  if (design != 0 && design != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(s_) * k_ * sizeof(float);
  void (*kernel)(const float*, const uint8_t*, float*, int, int, int, int, int) =
      design == 0 ? &adc_sum_kernel<true> : &adc_sum_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(ncells), (pmax + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dlut), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), q_, p_, s_, k_, pmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adc_sum_ab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

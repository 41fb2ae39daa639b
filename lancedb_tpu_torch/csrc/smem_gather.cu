// A table gather from shared memory for Hopper (sm_90a): a probe kernel,
// not on a search path.
//
// Replaces the TPU probe kernel of scripts/ab_gather_min.py (`try_shape`),
// which asks which shapes Mosaic's in-register lane gather
// (take_along_axis inside a Pallas kernel) accepts. Here it computes,
// for an (s, w) f32 table x and an (s, w) int32 index idx:
//
//   axis 1: out[i, j] = x[i, idx[i, j]]
//   axis 0: out[i, j] = x[idx[i, j], j]
//
// with the table staged in shared memory, which is where the ADC scans
// keep their LUTs on this card. Every index must lie in [0, w) (axis 1)
// or [0, s) (axis 0).
//
// Bound: device-memory bytes (x and idx read once, out written once),
// which at the probe's shapes (at most 128 KiB of table) is far below
// the launch's own cost. Design: one block of 1024 threads stages the
// whole table, then each thread gathers a strided share of the entries.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) smem_gather_kernel(
    const float* __restrict__ x,      // (s, w)
    const int32_t* __restrict__ idx,  // (s, w)
    float* __restrict__ out,          // (s, w)
    int s_, int w_, int axis) {
  extern __shared__ float tab[];
  const int n = s_ * w_;
  for (int i = threadIdx.x; i < n; i += kThreads) tab[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = idx[i];
    out[i] = axis == 1 ? tab[(i / w_) * w_ + j] : tab[j * w_ + i % w_];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int smem_gather_launch(
    const void* x, const void* idx, void* out, int s_, int w_, int axis, void* stream) {
  if (axis != 0 && axis != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(s_) * w_ * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        smem_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  smem_gather_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), s_, w_, axis);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smem_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

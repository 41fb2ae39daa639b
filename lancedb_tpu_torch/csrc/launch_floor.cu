// An empty kernel for Hopper (sm_90a): the floor of a launch on this card.
//
// Replaces no TPU kernel. The probes time it launched the way every kernel
// of the package is launched (ctypes, PyTorch's current stream, through
// lancedb_tpu_torch/ops/cuda_build.py `launch`), so a kernel whose time
// is near this one's is bound by its launch, not by its work.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches one block of one thread on `stream`; returns cudaGetLastError().
extern "C" int launch_floor_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* launch_floor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

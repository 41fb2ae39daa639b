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
// in the order _adc_cell_kernel_select uses: the f32 LUT entries summed
// in ascending s, then the affine epilogue. Padding, filter and delete
// penalties arrive through rnorms (+3e38, or inf where two add up), so
// the kernel never branches on them. One kernel serves 4-bit (K = 16)
// and 8-bit (K = 256) codes; padded subvectors hold code 0 against zero
// LUT rows.
//
// Bound: device-memory bytes. The function reads each probed partition's
// S x pmax code bytes and pmax rnorms once and writes pmax f32 distances
// per pair (about 41 MB at 8-bit x16 on the main path, 0.012 ms); its S
// adds per slot are far below the card's f32 rate. What costs is
// staging the query's S x K LUT into shared memory: staged once per
// (pair, 256-slot tile) it is 283 MB of L2 reads per 8-bit launch on the
// main path, against 17 MB of codes. This design:
//   - one block of 256 threads per (query, chunk of that query's
//     probes); the LUT belongs to the query, so the block stages it once
//     and walks every slot of every probe of its chunk. The chunks are
//     sized so that the grid holds about 8 blocks per SM;
//   - each thread owns 16 consecutive slots of one probe (4 where pmax
//     is not a multiple of 16, 1 where it is not one of 4): one 16-byte
//     load of codes[pid, s, p .. p + 15] per subvector, coalesced along
//     p in the (P, S, pmax) layout, 16 LUT lookups per load, and 16-byte
//     loads of rnorms and stores of the output;
//   - the block's (probe, slot group) items are numbered slot-fastest and
//     dealt to the threads in turn, so a warp reads 512 contiguous code
//     bytes per subvector and no thread idles on a short partition.
// At K = 256 the lookups of a warp fall on random banks of a 1 KB row
// (3-4 way conflicts), which sets the floor near 0.03-0.04 ms on the main
// path; at K = 16 a row spans 16 banks and the lookups do not conflict.
//
// nvcc -Xptxas -v (cuda_build.build_logs, CUDA 12.9, sm_90a): 46
// registers at 16 slots per thread, 40 at 4 and at 1, no spills, no
// static shared memory; the LUT takes S x K x 4 bytes of dynamic shared
// memory (16 KB at 8-bit x16, 2 KB at 4-bit x32).
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py). Do not
// compile with --use_fast_math: 3e38 + 3e38 must overflow to inf.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // grid target: query chunks fill the card this deep

template <int VS>
struct Codes;  // VS consecutive code bytes, loaded at once
template <>
struct Codes<16> {
  uint4 v;
  __device__ __forceinline__ void load(const uint8_t* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ int operator[](int i) const {
    const unsigned w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
    return (w >> (8 * (i & 3))) & 0xff;
  }
};
template <>
struct Codes<4> {
  unsigned v;
  __device__ __forceinline__ void load(const uint8_t* p) { v = *reinterpret_cast<const unsigned*>(p); }
  __device__ __forceinline__ int operator[](int i) const { return (v >> (8 * i)) & 0xff; }
};
template <>
struct Codes<1> {
  int v;
  __device__ __forceinline__ void load(const uint8_t* p) { v = *p; }
  __device__ __forceinline__ int operator[](int) const { return v; }
};

template <int VS>
__device__ __forceinline__ void load_f32(const float* p, float* dst) {
  if constexpr (VS == 1) {
    dst[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VS; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      dst[i] = v.x; dst[i + 1] = v.y; dst[i + 2] = v.z; dst[i + 3] = v.w;
    }
  }
}

template <int VS>
__device__ __forceinline__ void store_f32(float* p, const float* src) {
  if constexpr (VS == 1) {
    *p = src[0];
  } else {
#pragma unroll
    for (int i = 0; i < VS; i += 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
    }
  }
}

// VS: slots per thread (16, 4 or 1), a divisor of pmax
template <int VS>
__global__ void __launch_bounds__(kThreads) adc_scan_kernel(
    const int32_t* __restrict__ probe_ids,  // (Q, NP)
    const float* __restrict__ dlut,         // (Q, S, K)
    const uint8_t* __restrict__ codes,      // (P, S, pmax)
    const float* __restrict__ rnorms,       // (P, pmax)
    const float* __restrict__ qc,           // (Q, NP)
    const float* __restrict__ qn2,          // (Q,)
    float* __restrict__ out,                // (Q, NP, pmax)
    int np_, int s_, int k_, int pmax, int ppc) {
  extern __shared__ __align__(16) float lut[];  // S * K
  const int q = blockIdx.y;
  const int j0 = blockIdx.x * ppc;
  const int nj = min(ppc, np_ - j0);
  const int sk = s_ * k_;
  const float* src = dlut + static_cast<size_t>(q) * sk;
  if (sk % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = threadIdx.x; i < sk / 4; i += kThreads)
      reinterpret_cast<float4*>(lut)[i] = reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < sk; i += kThreads) lut[i] = src[i];
  }
  __syncthreads();

  const float q2 = qn2[q];
  const int nvec = pmax / VS;
  for (int w = threadIdx.x; w < nj * nvec; w += kThreads) {
    const int pair = q * np_ + j0 + w / nvec;
    const int p = (w % nvec) * VS;
    const int pid = probe_ids[pair];
    const uint8_t* c = codes + static_cast<size_t>(pid) * s_ * pmax + p;
    float acc[VS];
#pragma unroll
    for (int i = 0; i < VS; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < s_; ++s) {
      Codes<VS> cv;
      cv.load(c + static_cast<size_t>(s) * pmax);
      const float* row = lut + s * k_;
#pragma unroll
      for (int i = 0; i < VS; ++i) acc[i] += row[cv[i]];
    }
    const float qcv = qc[pair];
    float r[VS];
    load_f32<VS>(rnorms + static_cast<size_t>(pid) * pmax + p, r);
#pragma unroll
    for (int i = 0; i < VS; ++i) {
      const float qdotx = qcv + acc[i];
      r[i] = q2 - 2.0f * qdotx + r[i];
    }
    store_f32<VS>(out + static_cast<size_t>(pair) * pmax + p, r);
  }
}

template <int VS>
cudaError_t launch_vs(const void* probe_ids, const void* dlut, const void* codes,
                      const void* rnorms, const void* qc, const void* qn2, void* out, int q,
                      int np_, int s_, int k_, int pmax, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(s_) * k_ * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        adc_scan_kernel<VS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // chunks per query for about kBlocksPerSm blocks per SM, then even probes per chunk
  const int want = max(1, min(np_, (sms * kBlocksPerSm + q - 1) / q));
  const int ppc = (np_ + want - 1) / want;
  const dim3 grid((np_ + ppc - 1) / ppc, static_cast<unsigned>(q));
  adc_scan_kernel<VS><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(probe_ids), static_cast<const float*>(dlut),
      static_cast<const uint8_t*>(codes), static_cast<const float*>(rnorms),
      static_cast<const float*>(qc), static_cast<const float*>(qn2), static_cast<float*>(out),
      np_, s_, k_, pmax, ppc);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
  if (q == 0 || np_ == 0 || pmax == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool base16 = aligned16(codes) && aligned16(rnorms) && aligned16(out);
  cudaError_t e;
  if (base16 && pmax % 16 == 0) {
    e = launch_vs<16>(probe_ids, dlut, codes, rnorms, qc, qn2, out, q, np_, s_, k_, pmax, st);
  } else if (base16 && pmax % 4 == 0) {
    e = launch_vs<4>(probe_ids, dlut, codes, rnorms, qc, qn2, out, q, np_, s_, k_, pmax, st);
  } else {
    e = launch_vs<1>(probe_ids, dlut, codes, rnorms, qc, qn2, out, q, np_, s_, k_, pmax, st);
  }
  return static_cast<int>(e);
}

extern "C" const char* adc_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

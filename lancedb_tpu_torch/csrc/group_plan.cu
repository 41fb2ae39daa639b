// Grouping plan of the grouped probe scans (B2, B3) for Hopper (sm_90a).
//
// Replaces the reference's group_probe_pairs (lancedb_tpu/ops/util.py),
// which the grouped Pallas kernels take their plan from and which XLA
// computes in plain array ops; it is not a TPU kernel. Its plain torch
// version is grouped_plan_reference (lancedb_tpu_torch/ops/util.py),
// and this kernel equals it element for element.
//
// The S = Q * NP (query, probe) pairs, pair = q * NP + j, are sorted by
// partition id, stably, and each partition's run is padded to a multiple
// of qpc slots, so each group of qpc consecutive slots shares one
// partition. Outputs:
//   pair_of_slot (G * qpc,): the pair in each slot, -1 on padding;
//   gpid (G,): each group's partition; the groups past the last real one
//     (G is a bound from the shapes) repeat the largest probed pid.
//
// Bound: none of the card's rates. The plan moves 4 bytes per pair and
// per slot, some 70 KB on the main path, so what it costs is latency:
// the torch ops it replaces were about twenty launches and a bincount
// that read its size back to the host, 1.2-1.6 ms per call on the main
// path. Design: one launch of one block of 1024 threads, no host sync,
// no step that runs pair after pair:
//   1. fill pair_of_slot with -1 and count the pairs of each partition
//      with shared-memory atomics;
//   2. turn the counts, padded to qpc, into each partition's first slot:
//      an exclusive prefix sum over P, each thread over a contiguous range
//      and one block-wide scan over the threads, with warp shuffles;
//   3. every thread drops its pairs into their partition's run of a
//      scratch copy of the padded layout through an atomic cursor, in
//      whatever order the atomics come;
//   4. one thread per partition sorts its run by pair index (a pair's
//      place is the number of smaller indices in its run), writing the
//      run into pair_of_slot and its groups' pid into gpid; a run of more
//      than 16 pairs goes to the thread's whole warp, which counts with
//      shuffles. Pairs in ascending index within each partition are the
//      stable sort of the reference.
// The block runs on one SM, so what it costs is the instructions its 32
// warps issue: with one warp per partition each warp would walk 44 of
// the main path's 1402 in turn, where one thread per partition walks 2.
// Runs on the main path hold about 4 pairs. The counters (2 * P ints) and the scratch layout
// (G * qpc ints) live in dynamic shared memory, so step 4 waits on
// shared memory, not on L2; where
// either outgrows it, the wrapper hands over a global scratch array for
// it instead (the kernel reads both through generic pointers).
//
// nvcc -Xptxas -v (cuda_build.build_logs, CUDA 12.9, sm_90a): 31
// registers, no spills, 144 bytes of static shared memory; the dynamic
// part is 8 x P bytes of counters plus 4 x G x qpc of scratch layout where
// they fit (11,080 + 53,120 bytes for the main path's IVF_FLAT plan:
// P 1385 blocks, 3584 pairs, qpc 8).
//
// Probe ids must lie in [0, P); a pair outside is never placed.
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;  // ranks after every pair index
constexpr int kSmallRun = 16;      // longest run one thread sorts alone

__global__ void __launch_bounds__(kThreads) group_plan_kernel(
    const int32_t* __restrict__ probe_ids,  // (S,), pair q * NP + j
    int32_t* __restrict__ gpid,             // (G,)
    int32_t* __restrict__ pair_of_slot,     // (G * qpc,)
    int* counters,                          // (2 * P,) scratch, or null: shared memory
    int32_t* unsorted,                      // (G * qpc,) scratch, or null: shared memory
    int s_, int p_, int qpc, int g) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ int max_pid;
  int* count = counters != nullptr ? counters : smem;  // pairs per partition
  int* cursor = count + p_;  // first slot, then the next free slot
  int* runs = unsorted != nullptr ? unsorted : smem + (counters != nullptr ? 0 : 2 * p_);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // 1. counts per partition; every slot padding until placed
  for (int i = t; i < p_; i += kThreads) count[i] = 0;
  for (int i = t; i < g * qpc; i += kThreads) pair_of_slot[i] = -1;
  if (t == 0) max_pid = 0;
  __syncthreads();
  int mx = 0;
  for (int i = t; i < s_; i += kThreads) {
    const int pid = probe_ids[i];
    if (static_cast<unsigned>(pid) < static_cast<unsigned>(p_)) {
      atomicAdd(&count[pid], 1);
      mx = max(mx, pid);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  if (lane == 0) atomicMax(&max_pid, mx);
  __syncthreads();

  // 2. cursor[pid] = first slot of pid: exclusive prefix sum of the
  //    counts rounded up to qpc; each thread sums a contiguous range of
  //    partitions, one block-wide scan joins the ranges
  const int per = (p_ + kThreads - 1) / kThreads;
  const int lo = min(p_, t * per), hi = min(p_, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += (count[i] + qpc - 1) / qpc * qpc;
  int x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int next = (warp > 0 ? warp_sums[warp - 1] : 0) + x - own;
  for (int i = lo; i < hi; ++i) {
    cursor[i] = next;
    next += (count[i] + qpc - 1) / qpc * qpc;
  }
  __syncthreads();

  // 3. each pair into its partition's run, in atomic order
  for (int i = t; i < s_; i += kThreads) {
    const int pid = probe_ids[i];
    if (static_cast<unsigned>(pid) < static_cast<unsigned>(p_)) {
      runs[atomicAdd(&cursor[pid], 1)] = i;
    }
  }
  for (int i = t; i < g; i += kThreads) gpid[i] = max_pid;  // groups past the last real one
  __syncthreads();

  // 4. each run sorted by pair index, its groups given its pid: one
  //    thread per partition, a pair's place the count of smaller indices
  //    in the run; runs longer than kSmallRun go to the whole warp, which
  //    counts with shuffles, 32 pairs at a time
  for (int base = 0; base < p_; base += kThreads) {  // the same trips for every thread
    const int pid = base + t;
    const int n = pid < p_ ? count[pid] : 0;
    const int start = n > 0 ? cursor[pid] - n : 0;
    if (n > 0) {
      for (int grp = start / qpc; grp <= (start + n - 1) / qpc; ++grp) gpid[grp] = pid;
    }
    if (n > 0 && n <= kSmallRun) {
      for (int a = 0; a < n; ++a) {
        const int v = runs[start + a];
        int rank = 0;
        for (int b = 0; b < n; ++b) rank += runs[start + b] < v;
        pair_of_slot[start + rank] = v;
      }
    }
    for (unsigned big = __ballot_sync(kFull, n > kSmallRun); big != 0; big &= big - 1) {
      const int src = __ffs(big) - 1;
      const int bn = __shfl_sync(kFull, n, src);
      const int bstart = __shfl_sync(kFull, start, src);
      for (int c = 0; c < bn; c += 32) {
        const int v = c + lane < bn ? runs[bstart + c + lane] : kNone;
        int rank = 0;
        for (int c2 = 0; c2 < bn; c2 += 32) {
          const int w = c2 + lane < bn ? runs[bstart + c2 + lane] : kNone;
          const int m_end = min(32, bn - c2);
          for (int m = 0; m < m_end; ++m) rank += __shfl_sync(kFull, w, m) < v;
        }
        if (c + lane < bn) pair_of_slot[bstart + rank] = v;
      }
    }
  }
}

}  // namespace

// Shared memory the kernel asks for itself, beside its dynamic bytes.
extern "C" int group_plan_static_smem_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, group_plan_kernel) != cudaSuccess) return -1;
  return static_cast<int>(attr.sharedSizeBytes);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// counters: (2 * P,) int32 device scratch, unsorted: (G * qpc,) int32
// device scratch; either null to keep it in shared memory (what is kept
// there must fit the card's opt-in limit).
extern "C" int group_plan_launch(
    const void* probe_ids, void* gpid, void* pair_of_slot, void* counters, void* unsorted,
    int s_, int p_, int qpc, int g, void* stream) {
  if (qpc < 1 || s_ < 1 || p_ < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((counters != nullptr ? 0 : 2 * static_cast<size_t>(p_)) +
                       (unsorted != nullptr ? 0 : static_cast<size_t>(g) * qpc)) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  group_plan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe_ids), static_cast<int32_t*>(gpid),
      static_cast<int32_t*>(pair_of_slot), static_cast<int*>(counters),
      static_cast<int32_t*>(unsorted), s_, p_, qpc, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* group_plan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

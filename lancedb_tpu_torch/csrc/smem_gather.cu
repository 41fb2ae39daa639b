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
// with the part of the table that a block's outputs read staged in shared
// memory, which is where the ADC scans keep their LUTs on this card. The
// result equals torch.take_along_dim bit for bit (it moves floats, it
// adds none). Every index must lie in [0, w) (axis 1) or [0, s) (axis 0);
// the kernel does not check it.
//
// Bound: device-memory bytes (x and idx read once, out written once):
// 4-117 ns at the probe's shapes, far below any launch. So what a design
// can win is latency: the first design ran one block of 1024 threads
// that staged the whole table from one SM, then gathered with a division
// or a modulo an element. Design:
//
//   axis 1: a block takes one row and a tile of up to 1024 columns, a
//           thread 4 consecutive outputs of it. The thread loads its 4
//           indices before the row is staged (one 16-byte load where
//           w % 4 == 0 and the pointers are 16-byte aligned, else 4
//           loads, consecutive across the warp), so the two reads overlap;
//           the block stages the row (16-byte loads where aligned), then
//           each thread does 4 shared reads and one 16-byte store (or 4).
//   axis 0: a block takes a strip of 32 columns and a chunk of 64 output
//           rows; it stages the strip over all s rows as tab[r * 32 + c]
//           (a warp reads 4 rows' 32 columns with 16-byte loads where
//           w % 4 == 0 and x is 16-byte aligned, else one row's 128 bytes),
//           so the lookups tab[idx * 32 + lane] hit 32 distinct banks. Each
//           warp writes 8 of the chunk's rows, its 8 indices loaded before
//           the staging.
//
// The grid is (row, column tile) for axis 1 and (row chunk, strip) for
// axis 0; the loops hold no runtime division or modulo. A row (axis 1) or
// strip (axis 0) that does not fit the card's shared memory is read from
// device memory instead (the stageless instantiation), so no table is
// refused. lancedb_tpu_torch/ops/probe_kernels.py `smem_gather_geometry`
// computes the same geometry in Python; smem_gather_geometry below is the
// one the launch uses.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (lancedb_tpu_torch/ops/cuda_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowWarpsMax = 8;    // axis 1: warps a block at most
constexpr int kStripCols = 32;     // axis 0: columns a strip, one a lane
constexpr int kStripWarps = 8;     // axis 0: warps a block
constexpr int kWarpRows = 8;       // axis 0: output rows a warp writes
constexpr int kChunkRows = kStripWarps * kWarpRows;  // output rows a block writes
constexpr int kGridYMax = 65535;

struct Geometry {
  int threads;  // a block
  int tile;     // columns (axis 1) or output rows (axis 0) a block writes
  int gx, gy;   // grid: (row, column tile) or (row chunk, strip), gy capped
  int tiles;    // column tiles (axis 1) or strips (axis 0); gy <= tiles
  int smem;     // dynamic shared memory, bytes (0 when stageless)
  int staged;
};

Geometry geometry(int s_, int w_, int axis, int smem_limit) {
  Geometry g;
  if (axis == 1) {
    const int groups = (w_ + 3) / 4;  // 4 outputs a thread
    int warps = (groups + 31) / 32;
    if (warps > kRowWarpsMax) warps = kRowWarpsMax;
    g.threads = 32 * warps;
    g.tile = 4 * g.threads;
    g.tiles = (w_ + g.tile - 1) / g.tile;
    g.gx = s_;
    const long long row = 4LL * w_;
    g.staged = row <= smem_limit;
    g.smem = g.staged ? static_cast<int>(row) : 0;
  } else {
    g.threads = 32 * kStripWarps;
    g.tile = kChunkRows;
    g.tiles = (w_ + kStripCols - 1) / kStripCols;
    g.gx = (s_ + kChunkRows - 1) / kChunkRows;
    const long long strip = 4LL * kStripCols * s_;
    g.staged = strip <= smem_limit;
    g.smem = g.staged ? static_cast<int>(strip) : 0;
  }
  g.gy = g.tiles < kGridYMax ? g.tiles : kGridYMax;
  return g;
}

// axis 1, 16-byte path (w % 4 == 0, x and idx 16-byte aligned): thread t
// of tile c writes columns 4t .. 4t + 3 of the tile.
template <bool kStaged>
__global__ void __launch_bounds__(32 * kRowWarpsMax) gather_rows_vec(
    const float* __restrict__ x, const int32_t* __restrict__ idx, float* __restrict__ out,
    int w_, int tiles) {
  extern __shared__ __align__(16) float row[];
  const size_t base = static_cast<size_t>(blockIdx.x) * w_;
  const int step = 4 * blockDim.x;
  int j = blockIdx.y * step + 4 * threadIdx.x;
  int4 k = make_int4(0, 0, 0, 0);
  if (j < w_) k = __ldg(reinterpret_cast<const int4*>(idx + base + j));
  const float* tab = x + base;
  if (kStaged) {
    const float4* src = reinterpret_cast<const float4*>(x + base);
    float4* dst = reinterpret_cast<float4*>(row);
    for (int v = threadIdx.x; v < (w_ >> 2); v += blockDim.x) dst[v] = __ldg(src + v);
    __syncthreads();
    tab = row;
  }
  for (int c = blockIdx.y; c < tiles; c += gridDim.y) {
    if (c != static_cast<int>(blockIdx.y)) {
      j += gridDim.y * step;
      if (j < w_) k = __ldg(reinterpret_cast<const int4*>(idx + base + j));
    }
    if (j < w_) {
      float4 o;
      o.x = tab[k.x];
      o.y = tab[k.y];
      o.z = tab[k.z];
      o.w = tab[k.w];
      *reinterpret_cast<float4*>(out + base + j) = o;
    }
  }
}

// axis 1, any w and alignment: thread t of tile c writes columns
// t + e * blockDim.x, e < 4, so a warp's loads and stores stay consecutive.
template <bool kStaged>
__global__ void __launch_bounds__(32 * kRowWarpsMax) gather_rows_scalar(
    const float* __restrict__ x, const int32_t* __restrict__ idx, float* __restrict__ out,
    int w_, int tiles) {
  extern __shared__ __align__(16) float row[];
  const size_t base = static_cast<size_t>(blockIdx.x) * w_;
  const int step = 4 * blockDim.x;
  int j = blockIdx.y * step + threadIdx.x;
  int k[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int jj = j + e * blockDim.x;
    k[e] = jj < w_ ? __ldg(idx + base + jj) : 0;
  }
  const float* tab = x + base;
  if (kStaged) {
    for (int v = threadIdx.x; v < w_; v += blockDim.x) row[v] = __ldg(x + base + v);
    __syncthreads();
    tab = row;
  }
  for (int c = blockIdx.y; c < tiles; c += gridDim.y) {
    if (c != static_cast<int>(blockIdx.y)) {
      j += gridDim.y * step;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = j + e * blockDim.x;
        k[e] = jj < w_ ? __ldg(idx + base + jj) : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = j + e * blockDim.x;
      if (jj < w_) out[base + jj] = tab[k[e]];
    }
  }
}

// axis 0: block (chunk, strip) writes output rows chunk * 64 + warp + 8e,
// e < 8, of columns strip * 32 + lane. kVec (w % 4 == 0, x 16-byte
// aligned) stages with 16-byte loads, a warp 4 rows of the strip a load.
template <bool kStaged, bool kVec>
__global__ void __launch_bounds__(32 * kStripWarps) gather_cols(
    const float* __restrict__ x, const int32_t* __restrict__ idx, float* __restrict__ out,
    int s_, int w_, int strips) {
  extern __shared__ __align__(16) float tab[];  // (s, 32)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kChunkRows + warp;
  for (int strip = blockIdx.y; strip < strips; strip += gridDim.y) {
    const int j = strip * kStripCols + lane;
    const bool live = j < w_;
    int k[kWarpRows];
#pragma unroll
    for (int e = 0; e < kWarpRows; ++e) {
      const int r = r0 + e * kStripWarps;
      k[e] = live && r < s_ ? __ldg(idx + static_cast<size_t>(r) * w_ + j) : 0;
    }
    if (kStaged) {
      if (strip != static_cast<int>(blockIdx.y)) __syncthreads();  // the last strip's reads
      if (kVec) {
        // lane l loads columns 4 (l % 8) .. + 3 of row 4 warp + l / 8 (+ 32 a step)
        const int qc = (lane & 7) * 4;
        const int jq = strip * kStripCols + qc;
        const bool qlive = jq < w_;  // w % 4 == 0: a quad is live whole or not at all
#pragma unroll 8
        for (int r = warp * 4 + (lane >> 3); r < s_; r += kStripWarps * 4) {
          *reinterpret_cast<float4*>(tab + r * kStripCols + qc) =
              qlive ? __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(r) * w_ + jq))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
#pragma unroll 16
        for (int r = warp; r < s_; r += kStripWarps) {
          tab[r * kStripCols + lane] = live ? __ldg(x + static_cast<size_t>(r) * w_ + j) : 0.0f;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < kWarpRows; ++e) {
      const int r = r0 + e * kStripWarps;
      if (live && r < s_) {
        out[static_cast<size_t>(r) * w_ + j] =
            kStaged ? tab[k[e] * kStripCols + lane] : __ldg(x + static_cast<size_t>(k[e]) * w_ + j);
      }
    }
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// The launch geometry for a card whose blocks may use `smem_limit` bytes
// of shared memory: out = {threads, tile, gx, gy, tiles, smem, staged}.
extern "C" void smem_gather_geometry(int s_, int w_, int axis, int smem_limit, int* out) {
  const Geometry g = geometry(s_, w_, axis, smem_limit);
  out[0] = g.threads;
  out[1] = g.tile;
  out[2] = g.gx;
  out[3] = g.gy;
  out[4] = g.tiles;
  out[5] = g.smem;
  out[6] = g.staged;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int smem_gather_launch(
    const void* x, const void* idx, void* out, int s_, int w_, int axis, void* stream) {
  if ((axis != 0 && axis != 1) || s_ < 0 || w_ < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s_ == 0 || w_ == 0) return 0;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const Geometry g = geometry(s_, w_, axis, limit);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(g.gx, g.gy);
  const float* xf = static_cast<const float*>(x);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* of = static_cast<float*>(out);
  cudaError_t e = cudaSuccess;
  if (axis == 1) {
    const bool vec = (w_ & 3) == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                        reinterpret_cast<uintptr_t>(idx) |
                                        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (vec) {
      const auto kernel = g.staged ? gather_rows_vec<true> : gather_rows_vec<false>;
      e = opt_in(kernel, g.smem);
      if (e == cudaSuccess) kernel<<<grid, g.threads, g.smem, st>>>(xf, ix, of, w_, g.tiles);
    } else {
      const auto kernel = g.staged ? gather_rows_scalar<true> : gather_rows_scalar<false>;
      e = opt_in(kernel, g.smem);
      if (e == cudaSuccess) kernel<<<grid, g.threads, g.smem, st>>>(xf, ix, of, w_, g.tiles);
    }
  } else {
    const bool vec = (w_ & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const auto kernel = !g.staged ? gather_cols<false, false>
                        : vec     ? gather_cols<true, true>
                                  : gather_cols<true, false>;
    e = opt_in(kernel, g.smem);
    if (e == cudaSuccess) kernel<<<grid, g.threads, g.smem, st>>>(xf, ix, of, s_, w_, g.tiles);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smem_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

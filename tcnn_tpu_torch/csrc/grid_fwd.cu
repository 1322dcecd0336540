// Multiresolution grid lookup and interpolation, all levels in one launch,
// for Hopper (sm_90a).
//
// Replaces: the grid lookup of tcnn_tpu/encodings/grid.py
// (GridEncoding.apply :1354, per-sample branch :1645-1755 and :1829-2024),
// which the JAX package composes from XLA gathers (it is not a Pallas
// kernel); the reference's kernel_grid (encodings/grid.h) does the same job.
//
// What it computes, per (sample, level): the cell and the 2^d corner
// indices and weights of grid_common.cuh; the features read as fp32 from the
// flat parameters, rounded on read to fp16 or bf16 where the level table
// says so (the encoding's own table dtype, then the level's serve-time
// one); and the weighted sum in fp32, in corner order 0..2^d-1, with every
// product and sum rounded separately as in the plain version. Output column
// lvl*F + f; padding columns are written as zeros.
//
// What bounds it on this card: the flagship table is 708,592 fp32 values
// (2.8 MB), resident in the 50 MB L2, so the kernel is bound by random L2
// reads (one 32-byte sector per corner: 2^18 x 16 levels x 4 corners = 67 M
// sectors, 2.1 GB, per flagship call at B = 2^18) and their latency, not by
// HBM bandwidth (~22 MB of inputs and outputs); the card's fastest random
// 8-byte row gather takes 0.1121 ms for those 2^24 rows (PERF.md, the
// probes' floor). The earlier kernel took 2.8-3.1x that, and with every
// corner reading one row (all L1 hits) it kept 85-92% of its time
// (benchmarks/lookup_scatter_times.py --variants, NVIDIA H100 80GB HBM3,
// 700 W): its integer work (a 64-bit division of the thread index and
// eight 64-bit remainders a (sample, level), 1,456 SASS instructions) and
// its per-thread setup, not its reads, set its time.
//
// Design (tcnn_grid_forward): level-major warps. A block of kWarps warps
// owns kTile = 32 consecutive samples, one a lane; warp w takes levels w,
// w + kWarps, ..., so a warp's lanes are 32 neighbouring samples on one
// level: one level description and one index mode a warp (no divergence
// between hash modes), and the neighbouring cells of a stratified batch or
// a raster share table rows in L1. The level table sits in shared memory,
// read once a block. The index arithmetic is 32-bit with no division:
// grid_common.cuh's reduce() (a mask or a multiply by the level's
// reciprocal) and add_mod(). With the dims known at compile time (d = 2,
// 3) a thread computes every corner's row first and then issues all the
// row loads before any sum (4 or 8 in flight), a row as one float2 (F = 2)
// or float4 (F = 4, 8) load where the table is 16-byte aligned. The output
// rows of the tile are staged in shared memory (a padded row a sample) and
// written whole, word by word, a warp a row. The float arithmetic and its
// order are the earlier kernel's, so the output is bitwise the same.
// Measured (same tool and card; new / earlier kernel, ms, bf16 output):
// flagship stratified batch 0.0612 / 0.3132, uniform points 0.0874 /
// 0.3474 (B = 2^18; 0.55 and 0.78x the floor above: rows shared in L1),
// the 3D model 0.2665 / 0.7776, the 1024^2 raster 0.2268 / 1.2538; no
// division subroutine is left in the SASS (944 instructions at d = 2, F =
// 2, bf16).
//
// tcnn_grid_forward_v1 keeps the earlier kernel (one thread per (sample,
// level), level fastest, 64-bit index division and remainders, scalar
// reads) for chip_smoke.py's A/B and the on-card bitwise check; no path of
// the port calls it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

using namespace tcnn_grid;

namespace {

constexpr int kTile = 32;   // samples a block, one a lane
constexpr int kWarps = 8;   // warps a block
constexpr int kMaxLevels = 128;  // tcnn_tpu_torch/common.py MAX_N_LEVELS

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One (sample, level) of the cell `cell`: the F sums in corner order. D > 0:
// the dims at compile time (every corner's row first, then all loads, then
// the sums); D = 0: n_dims at run time, corner by corner.
template <int F, int D, bool kExtras>
__device__ __forceinline__ void interpolate(const Cell& cell, const float* __restrict__ params,
                                            const Level& lv, int n_dims, int interp, bool aligned, float (&acc)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  const int dims = D > 0 ? D : n_dims;
  const int n_corners = interp == kNearest ? 1 : 1 << dims;
  if constexpr (D > 0) {
    constexpr int C = 1 << D;
    uint32_t g[C];
    float w[C], v[C][F];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < n_corners) g[c] = lv.offset + corner<kExtras>(cell, lv, D, interp, c, &w[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < n_corners) load_row<F>(params, g[c], aligned, lv, v[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < n_corners) {
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w[c], v[c][f]));
      }
    }
  } else {
    for (int c = 0; c < n_corners; ++c) {
      float w, v[F];
      const uint32_t g = lv.offset + corner<kExtras>(cell, lv, dims, interp, c, &w);
      load_row<F>(params, g, aligned, lv, v);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
    }
  }
}

// Shared memory: the level table, then kTile staged output rows of
// `row_stride` 32-bit words each (the row's bytes in words, padded to an
// odd count so that the lanes' stores fall in distinct banks).
// x: fp32 positions, or the uint32 ones of fixed_point_pos (`fixed`).
// kExtras: the instantiation for uint32 positions and Rng levels; the
// other launches leave their code out (registers: PERF.md).
template <typename OutT, int F, int D, bool kExtras>
__global__ void __launch_bounds__(kWarps * 32)
    grid_forward_kernel(const void* __restrict__ x, const float* __restrict__ params,
                        const Level* __restrict__ levels, OutT* __restrict__ out, int batch, int n_dims,
                        int n_levels, int out_width, int interp, int row_stride, int aligned, int fixed) {
  extern __shared__ __align__(16) unsigned char smem[];
  Level* s_levels = reinterpret_cast<Level*>(smem);
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(smem + n_levels * sizeof(Level));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {
    const int* src = reinterpret_cast<const int*>(levels);
    int* dst = reinterpret_cast<int*>(s_levels);
    for (int i = tid; i < n_levels * (int)(sizeof(Level) / 4); i += blockDim.x) dst[i] = __ldg(src + i);
    if (out_width > n_levels * F) {  // padding columns: zeros
      for (int i = tid; i < kTile * row_stride; i += blockDim.x) s_rows[i] = 0u;
    }
  }
  __syncthreads();

  const int b0 = blockIdx.x * kTile;
  const int b = b0 + lane;
  const int dims = D > 0 ? D : n_dims;
  const float* xrow = static_cast<const float*>(x) + (size_t)b * dims;
  const uint32_t* xrow_fixed = static_cast<const uint32_t*>(x) + (size_t)b * dims;
  OutT* srow = reinterpret_cast<OutT*>(s_rows + lane * row_stride);
  if (b < batch) {
    for (int lvl = warp; lvl < n_levels; lvl += kWarps) {
      const Level& lv = s_levels[lvl];
      Cell cell;
      if constexpr (kExtras) {
        cell = fixed ? locate(xrow_fixed, lv, dims, interp) : locate(xrow, lv, dims, interp);
      } else {
        cell = locate(xrow, lv, dims, interp);
      }
      float acc[F];
      interpolate<F, D, kExtras>(cell, params, lv, n_dims, interp, aligned != 0, acc);
#pragma unroll
      for (int f = 0; f < F; ++f) store(srow + lvl * F + f, acc[f]);
    }
  }
  __syncthreads();

  // The tile's rows, a warp a row: consecutive lanes write consecutive
  // 32-bit words (elements where a row's bytes are no multiple of 4).
  const int rows = batch - b0 < kTile ? batch - b0 : kTile;
  if (out_width * sizeof(OutT) % 4 == 0) {
    const int row_words = out_width * (int)sizeof(OutT) / 4;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)b0 * out_width);
    for (int r = warp; r < rows; r += kWarps) {
      for (int w = lane; w < row_words; w += 32) dst[(size_t)r * row_words + w] = s_rows[r * row_stride + w];
    }
  } else {
    for (int r = warp; r < rows; r += kWarps) {
      const OutT* src = reinterpret_cast<const OutT*>(s_rows + r * row_stride);
      for (int e = lane; e < out_width; e += 32) out[(size_t)(b0 + r) * out_width + e] = src[e];
    }
  }
}

template <typename OutT, int F, int D>
cudaError_t launch_forward(unsigned blocks, size_t smem, cudaStream_t s, const void* x, const float* params,
                           const Level* levels, OutT* out, int batch, int n_dims, int n_levels, int out_width,
                           int interp, int row_stride, int aligned, int fixed, int rng_levels) {
  auto kernel = fixed || rng_levels ? grid_forward_kernel<OutT, F, D, true> : grid_forward_kernel<OutT, F, D, false>;
  // Above 48 KB a block's dynamic shared memory must be allowed first. The
  // attribute holds for the current device only, so every such launch sets it.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kWarps * 32, smem, s>>>(x, params, levels, out, batch, n_dims, n_levels, out_width, interp,
                                           row_stride, aligned, fixed);
  return cudaGetLastError();
}

template <typename OutT, int F>
cudaError_t launch_by_dims(unsigned blocks, size_t smem, cudaStream_t s, const void* x, const float* params,
                           const Level* levels, OutT* out, int batch, int n_dims, int n_levels, int out_width,
                           int interp, int row_stride, int aligned, int fixed, int rng_levels) {
  if (n_dims == 2)
    return launch_forward<OutT, F, 2>(blocks, smem, s, x, params, levels, out, batch, n_dims, n_levels, out_width,
                                      interp, row_stride, aligned, fixed, rng_levels);
  if (n_dims == 3)
    return launch_forward<OutT, F, 3>(blocks, smem, s, x, params, levels, out, batch, n_dims, n_levels, out_width,
                                      interp, row_stride, aligned, fixed, rng_levels);
  return launch_forward<OutT, F, 0>(blocks, smem, s, x, params, levels, out, batch, n_dims, n_levels, out_width,
                                    interp, row_stride, aligned, fixed, rng_levels);
}

template <typename OutT>
cudaError_t launch_by_features(int F, unsigned blocks, size_t smem, cudaStream_t s, const void* x,
                               const float* params, const Level* levels, OutT* out, int batch, int n_dims,
                               int n_levels, int out_width, int interp, int row_stride, int aligned, int fixed,
                               int rng_levels) {
#define TCNN_GRID_FWD_CASE(NF)                                                                                 \
  case NF:                                                                                                     \
    return launch_by_dims<OutT, NF>(blocks, smem, s, x, params, levels, out, batch, n_dims, n_levels, out_width, \
                                    interp, row_stride, aligned, fixed, rng_levels);
  switch (F) {
    TCNN_GRID_FWD_CASE(1)
    TCNN_GRID_FWD_CASE(2)
    TCNN_GRID_FWD_CASE(3)
    TCNN_GRID_FWD_CASE(4)
    TCNN_GRID_FWD_CASE(5)
    TCNN_GRID_FWD_CASE(6)
    TCNN_GRID_FWD_CASE(7)
    TCNN_GRID_FWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef TCNN_GRID_FWD_CASE
}

// ---- The earlier kernel, kept for the A/B (see the head of the file). ----

// Its cell and corner arithmetic: grid_common.cuh's locate() and corner()
// as they were, with 64-bit '%' by the level size.
__device__ __forceinline__ Cell locate_v1(const float* __restrict__ xrow, const Level& lv, int n_dims, int interp) {
  Cell cell;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      const float pos = __fadd_rn(__fmul_rn(__ldg(xrow + d), lv.scale), 0.5f);
      const float pf = floorf(pos);
      cell.pg[d] = (uint32_t)(int32_t)pf;
      float t = __fsub_rn(pos, pf);
      if (interp == kSmoothstep) {
        t = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.0f, __fmul_rn(2.0f, t)));
      }
      cell.w[d] = t;
    }
  }
  cell.base = 0;
  if (lv.mode == kQuad) {
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d < n_dims) cell.base += cell.pg[d] * lv.stride[d];
    }
    cell.base %= lv.size;
  }
  return cell;
}

__device__ __forceinline__ uint32_t corner_v1(const Cell& cell, const Level& lv, int n_dims, int interp, int c,
                                              float* weight) {
  float wt = 1.0f;
  uint32_t h = 0;
  uint64_t delta = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      const uint32_t bit = (c >> d) & 1;
      const uint32_t p = cell.pg[d] + bit;
      if (interp != kNearest) wt = __fmul_rn(wt, bit ? cell.w[d] : __fsub_rn(1.0f, cell.w[d]));
      switch (lv.mode) {
        case kFold: h += p * lv.stride[d]; break;
        case kQuad: delta += bit * lv.stride_mod[d]; break;
        case kXor: h ^= p * lv.stride[d]; break;
        default: h = (h + p) * 2531011u; break;  // kBaseConvert
      }
    }
  }
  *weight = wt;
  return lv.mode == kQuad ? (uint32_t)(((uint64_t)cell.base + delta % lv.size) % lv.size)
                          : h % lv.size;
}

template <typename OutT>
__global__ void grid_forward_v1_kernel(const float* __restrict__ x, const float* __restrict__ params,
                                       const Level* __restrict__ levels, OutT* __restrict__ out,
                                       int batch, int n_dims, int n_levels, int F, int out_width,
                                       int interp) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)batch * n_levels) return;
  const int64_t b = tid / n_levels;
  const int lvl = (int)(tid % n_levels);
  const Level lv = levels[lvl];
  const Cell cell = locate_v1(x + b * n_dims, lv, n_dims, interp);

  float acc[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) acc[f] = 0.0f;

  const int n_corners = interp == kNearest ? 1 : 1 << n_dims;
  for (int c = 0; c < n_corners; ++c) {
    float weight;
    const uint32_t idx = corner_v1(cell, lv, n_dims, interp, c, &weight);
    const float* row = params + ((uint64_t)lv.offset + idx) * F;
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) {
      if (f < F) acc[f] = __fadd_rn(acc[f], __fmul_rn(weight, read_rounded(row + f, lv)));
    }
  }

  OutT* orow = out + b * out_width;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) {
    if (f < F) store(orow + lvl * F + f, acc[f]);
  }
  if (lvl == 0) {
    for (int col = n_levels * F; col < out_width; ++col) store(orow + col, 0.0f);
  }
}

}  // namespace

// Both entry points return the cudaError_t of the launch (0 on success),
// launch on `stream` and do not synchronise. `levels` points to the device
// copy of the (n_levels, 32) int32 level table; out is (batch, out_width),
// bf16 when out_bf16 else fp32; x is (batch, n_dims) fp32, or uint32 when
// fixed_point (tcnn_grid_forward only); rng_levels: the table has an Rng
// level (tcnn_grid_forward only).
extern "C" int tcnn_grid_forward(const void* x, const void* params, const void* levels, void* out,
                                 int batch, int n_dims, int n_levels, int F, int out_width,
                                 int interp, int out_bf16, int fixed_point, int rng_levels, void* stream) {
  if (batch <= 0) return 0;
  const int elem = out_bf16 ? 2 : 4;
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF || n_levels < 1 || n_levels > kMaxLevels ||
      out_width < n_levels * F)
    return (int)cudaErrorInvalidValue;
  const int row_stride = (out_width * elem + 3) / 4 | 1;
  const size_t smem = n_levels * sizeof(Level) + (size_t)kTile * row_stride * 4;
  const unsigned blocks = (unsigned)((batch + kTile - 1) / kTile);
  const int aligned = reinterpret_cast<uintptr_t>(params) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(params);
  const Level* lv = static_cast<const Level*>(levels);
  const cudaError_t err =
      out_bf16 ? launch_by_features(F, blocks, smem, s, x, pf, lv, static_cast<__nv_bfloat16*>(out), batch, n_dims,
                                    n_levels, out_width, interp, row_stride, aligned, fixed_point, rng_levels)
               : launch_by_features(F, blocks, smem, s, x, pf, lv, static_cast<float*>(out), batch, n_dims,
                                    n_levels, out_width, interp, row_stride, aligned, fixed_point, rng_levels);
  return (int)err;
}

extern "C" int tcnn_grid_forward_v1(const void* x, const void* params, const void* levels, void* out,
                                    int batch, int n_dims, int n_levels, int F, int out_width,
                                    int interp, int out_bf16, int fixed_point, int rng_levels, void* stream) {
  if (batch <= 0) return 0;
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF || fixed_point || rng_levels)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t n = (int64_t)batch * n_levels;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* pf = static_cast<const float*>(params);
  const Level* lv = static_cast<const Level*>(levels);
  if (out_bf16) {
    grid_forward_v1_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        xf, pf, lv, static_cast<__nv_bfloat16*>(out), batch, n_dims, n_levels, F, out_width,
        interp);
  } else {
    grid_forward_v1_kernel<float><<<blocks, threads, 0, s>>>(
        xf, pf, lv, static_cast<float*>(out), batch, n_dims, n_levels, F, out_width, interp);
  }
  return (int)cudaGetLastError();
}

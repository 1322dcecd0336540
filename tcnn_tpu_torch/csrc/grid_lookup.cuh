// The grid lookup kernel (tcnn_grid_forward), shared by grid_fwd.cu (every
// instantiation of the lookup) and grid_sharded.cu (the windowed ones of a
// row-sharded table), so that grid_fwd.cu's build does not grow. What it
// computes, what bounds it and its design: the head of grid_fwd.cu.
//
// The windowed instantiations (kWindowed) read a rank's rows of a table
// whose every level is row-sharded (tcnn_tpu_torch/parallel/table_parallel.py:
// a rank holds rows [first, first + rows) of each level, at the level
// table's offset): a corner's level-local row r reads local row r - first
// where that lies below `rows` (one unsigned compare), and adds zero
// otherwise, as the JAX package's masked gather does
// (tcnn_tpu/parallel/table_parallel.py:_local_apply). The sum over the
// ranks of their outputs is the lookup of the whole table. A windowed
// launch's `levels` points to the level table followed by its (n_levels)
// windows (grid_common.cuh:Window), so the kernel's arguments stay those
// of the others. Every other instantiation compiles the kernel's text as
// it was before the windowed ones were added (the windowed code sits in
// discarded `if constexpr` branches), so its registers do not move.
//
// The sampled instantiations (kSampled; grid_bwd_modes.cu,
// tcnn_grid_forward_sampled) gather ONE corner a (sample, level): the
// corner that stochastic interpolation's table gradient sends that sample's
// dL/dy row to, chosen from the (batch, n_levels) uniforms u by the same
// code (grid_common.cuh:sampled_corner), read as the lookup reads its table
// (the level's rounding), with weight 1. The transpose of that table
// gradient: what a cotangent of the table gradient gives d/d(dL/dy)
// (tcnn_tpu/encodings/grid.py:_stochastic_combine_bwd, :145, whose
// cotangent the JAX package gathers through the lookup's own gather).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace {

using namespace tcnn_grid;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One (sample, level) of the cell `cell`: the F sums in corner order. D > 0:
// the dims at compile time (every corner's row first, an Rng level's keys
// for the whole cell at once, then all loads, then the sums); D = 0: n_dims
// at run time, corner by corner.
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
    if constexpr (kExtras) {
      uint32_t keys[C];
      if (lv.mode == kRng) rng_corners<D>(cell, keys);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) g[c] = lv.offset + corner_of<D>(cell, lv, interp, c, keys, &w[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) g[c] = lv.offset + corner<false>(cell, lv, D, interp, c, &w[c]);
      }
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

// interpolate() of a rank of a row-sharded table: a corner whose level-local
// row r lies outside the level's window reads zeros; one inside reads local
// row lv.offset + r - win.first.
template <int F, int D, bool kExtras>
__device__ __forceinline__ void interpolate_windowed(const Cell& cell, const float* __restrict__ params,
                                                     const Level& lv, Window win, int n_dims, int interp,
                                                     bool aligned, float (&acc)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  const int dims = D > 0 ? D : n_dims;
  const int n_corners = interp == kNearest ? 1 : 1 << dims;
  if constexpr (D > 0) {
    constexpr int C = 1 << D;
    uint32_t r[C];
    float w[C], v[C][F];
    if constexpr (kExtras) {
      uint32_t keys[C];
      if (lv.mode == kRng) rng_corners<D>(cell, keys);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) r[c] = corner_of<D>(cell, lv, interp, c, keys, &w[c]) - win.first;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) r[c] = corner<false>(cell, lv, D, interp, c, &w[c]) - win.first;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < n_corners) {
        if (r[c] < win.rows) {
          load_row<F>(params, lv.offset + r[c], aligned, lv, v[c]);
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) v[c][f] = 0.0f;
        }
      }
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
      const uint32_t r = corner<kExtras>(cell, lv, dims, interp, c, &w) - win.first;
      if (r < win.rows) {
        load_row<F>(params, lv.offset + r, aligned, lv, v);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.0f;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
    }
  }
}

// kSampled: the row of the corner that sampled_corner() picks for u, as
// the sampled table gradient's corner, read as load_row reads it.
template <int F, int D, bool kExtras>
__device__ __forceinline__ void gather_sampled(const Cell& cell, const float* __restrict__ table, const Level& lv,
                                               int n_dims, int interp, float u, bool aligned, float (&acc)[F]) {
  const int dims = D > 0 ? D : n_dims;
  float w;
  const uint32_t g = lv.offset + corner<kExtras>(cell, lv, dims, interp, sampled_corner(cell, dims, u), &w);
  load_row<F>(table, g, aligned, lv, acc);
}

// Shared memory: the level table, then kTile staged output rows of
// `row_stride` 32-bit words each (the row's bytes in words, padded to an
// odd count so that the lanes' stores fall in distinct banks).
// x: fp32 positions, or the uint32 ones of fixed_point_pos (`fixed`).
// kExtras: the instantiation for uint32 positions and Rng levels; the
// other launches leave their code out (registers: PERF.md). kWindowed: a
// rank of a row-sharded table, its level windows after the level table.
// kSampled: one sampled corner a (sample, level), u the (batch, n_levels)
// uniforms (null otherwise).
template <typename OutT, int F, int D, bool kExtras, bool kWindowed, bool kSampled = false>
__global__ void __launch_bounds__(kWarps * 32)
    grid_forward_kernel(const void* __restrict__ x, const float* __restrict__ params,
                        const Level* __restrict__ levels, OutT* __restrict__ out, int batch, int n_dims,
                        int n_levels, int out_width, int interp, int row_stride, int aligned, int fixed,
                        const float* __restrict__ u) {
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
      if constexpr (kSampled) {
        gather_sampled<F, D, kExtras>(cell, params, lv, n_dims, interp, __ldg(u + (size_t)b * n_levels + lvl),
                                      aligned != 0, acc);
      } else if constexpr (kWindowed) {
        interpolate_windowed<F, D, kExtras>(cell, params, lv,
                                            window_of(reinterpret_cast<const Window*>(levels + n_levels), lvl),
                                            n_dims, interp, aligned != 0, acc);
      } else {
        interpolate<F, D, kExtras>(cell, params, lv, n_dims, interp, aligned != 0, acc);
      }
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

// The operands of one lookup launch (a windowed one's `levels`: the level
// table followed by the windows).
struct LookupArgs {
  const void* x;
  const float* params;
  const Level* levels;
  int batch, n_dims, n_levels, out_width, interp, fixed, rng_levels;
  const float* u;  // kSampled: the (batch, n_levels) uniforms
};

template <typename OutT, int F, int D, bool kWindowed, bool kSampled>
cudaError_t launch_forward(const LookupArgs& a, OutT* out, cudaStream_t s) {
  const int row_stride = (a.out_width * (int)sizeof(OutT) + 3) / 4 | 1;
  const size_t smem = a.n_levels * sizeof(Level) + (size_t)kTile * row_stride * 4;
  const unsigned blocks = (unsigned)((a.batch + kTile - 1) / kTile);
  const int aligned = reinterpret_cast<uintptr_t>(a.params) % 16 == 0;
  auto kernel = a.fixed || a.rng_levels ? grid_forward_kernel<OutT, F, D, true, kWindowed, kSampled>
                                        : grid_forward_kernel<OutT, F, D, false, kWindowed, kSampled>;
  // Above 48 KB a block's dynamic shared memory must be allowed first. The
  // attribute holds for the current device only, so every such launch sets it.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kWarps * 32, smem, s>>>(a.x, a.params, a.levels, out, a.batch, a.n_dims, a.n_levels,
                                           a.out_width, a.interp, row_stride, aligned, a.fixed, a.u);
  return cudaGetLastError();
}

template <typename OutT, int F, bool kWindowed, bool kSampled>
cudaError_t launch_by_dims(const LookupArgs& a, OutT* out, cudaStream_t s) {
  if (a.n_dims == 2) return launch_forward<OutT, F, 2, kWindowed, kSampled>(a, out, s);
  if (a.n_dims == 3) return launch_forward<OutT, F, 3, kWindowed, kSampled>(a, out, s);
  return launch_forward<OutT, F, 0, kWindowed, kSampled>(a, out, s);
}

// The lookup with F (1-8) at compile time; the caller has checked the
// operands. Returns the launch's error.
template <typename OutT, bool kWindowed, bool kSampled = false>
cudaError_t lookup(int F, const LookupArgs& a, OutT* out, cudaStream_t s) {
  if (a.batch <= 0) return cudaSuccess;
  switch (F) {
    case 1: return launch_by_dims<OutT, 1, kWindowed, kSampled>(a, out, s);
    case 2: return launch_by_dims<OutT, 2, kWindowed, kSampled>(a, out, s);
    case 3: return launch_by_dims<OutT, 3, kWindowed, kSampled>(a, out, s);
    case 4: return launch_by_dims<OutT, 4, kWindowed, kSampled>(a, out, s);
    case 5: return launch_by_dims<OutT, 5, kWindowed, kSampled>(a, out, s);
    case 6: return launch_by_dims<OutT, 6, kWindowed, kSampled>(a, out, s);
    case 7: return launch_by_dims<OutT, 7, kWindowed, kSampled>(a, out, s);
    case 8: return launch_by_dims<OutT, 8, kWindowed, kSampled>(a, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The grid lookup's input gradient (G1) and double backward (G2), shared by
// grid_input_grad.cu (their instantiations for a whole table) and
// grid_sharded.cu (those of a rank of a row-sharded table, kWindowed), so
// that neither build carries the other's. What they compute, what bounds
// them and their design: the head of grid_input_grad.cu.
//
// kWindowed: a rank of a row-sharded table (tcnn_tpu_torch/parallel/
// table_parallel.py) holds the level-local rows [first, first + rows) of
// each level at the level table's offset; the windows follow the level
// table (grid_common.cuh:Window), as the windowed lookup reads them. A
// corner whose level-local row r lies outside the level's window reads
// zeros from the table and from cgp and adds nothing to the table gradient
// (one unsigned compare, r - first < rows), so each rank's d/dx and
// d/d(dL_dy) are its partials of the whole table's, which the caller sums
// over the ranks, and its table gradient that of its own rows. The other
// instantiations discard the windowed branches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "grid_table_grad.cuh"

namespace tcnn_grid {

// The per-level part of G1's and G2's shared memory: the level table and
// the class codes, then the warps' d/dx partials, [warp][dim][lane].
__device__ __forceinline__ float* stage_levels(unsigned char* smem, const Level* __restrict__ levels,
                                               const int* __restrict__ classes, int n_levels, int** s_classes) {
  Level* s_levels = reinterpret_cast<Level*>(smem);
  int* cls = reinterpret_cast<int*>(s_levels + n_levels);
  const int* src = reinterpret_cast<const int*>(levels);
  int* dst = reinterpret_cast<int*>(s_levels);
  for (int i = threadIdx.x; i < n_levels * (int)(sizeof(Level) / 4); i += blockDim.x) dst[i] = __ldg(src + i);
  for (int i = threadIdx.x; i < 2 * n_levels; i += blockDim.x)
    cls[i] = classes != nullptr ? __ldg(classes + i) : (i & 1 ? kAccF32 : kContribNone);
  *s_classes = cls;
  return reinterpret_cast<float*>(cls + 2 * n_levels);
}

// d/dx of the tile: the sum of the warps' partials in warp order, written
// as the tile's contiguous (rows, dims) block.
__device__ __forceinline__ void write_dx(const float* s_part, float* __restrict__ out, int b0, int rows, int dims) {
  for (int e = threadIdx.x; e < rows * dims; e += blockDim.x) {
    const int r = e / dims, k = e - r * dims;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, s_part[(w * dims + k) * kTile + r]);
    out[(size_t)b0 * dims + e] = s;
  }
}

template <typename DyT, int F>
__device__ __forceinline__ void load_dy(const DyT* __restrict__ row, bool valid, float (&g)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) g[f] = valid ? as_float(row[f]) : 0.0f;
}

// The window of level lvl (kWindowed: after the n_levels rows of the level
// table; else unread).
template <bool kWindowed>
__device__ __forceinline__ Window level_window(const Level* __restrict__ levels, int n_levels, int lvl) {
  if constexpr (kWindowed) return window_of(reinterpret_cast<const Window*>(levels + n_levels), lvl);
  return Window{0u, 0u};
}

// The table row of level-local row r: lv.offset + r; kWindowed: lv.offset
// + r - first where the rank holds r, else kNoRow.
template <bool kWindowed>
__device__ __forceinline__ uint32_t table_row(const Level& lv, Window win, uint32_t r) {
  if constexpr (kWindowed) {
    r -= win.first;
    return r < win.rows ? lv.offset + r : kNoRow;
  }
  return lv.offset + r;
}

// Row `row` of `table` as load_row reads it (rounded as level lv reads
// its table); kNoRow (a row the rank does not hold) reads zeros.
template <int F, bool kWindowed>
__device__ __forceinline__ void load_held(const float* __restrict__ table, uint32_t row, bool aligned,
                                          const Level& lv, float (&v)[F]) {
  if constexpr (kWindowed) {
    if (row == kNoRow) {
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = 0.0f;
      return;
    }
  }
  load_row<F>(table, row, aligned, lv, v);
}

// One corner of G1: acc[e] += dw_c[e] <g, T_c>.
template <int F, int K>
__device__ __forceinline__ void input_corner(const Cell& cell, const float (&d1)[K], const float (&d2)[K], int c,
                                             int dims, const float (&g)[F], const float (&t)[F], float (&acc)[K]) {
  float dw[K], h[K];
  corner_derivatives<K>(cell, d1, d2, d1, c, dims, false, dw, h);  // no Hessian: its cx (here d1) is not read
  float dot = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) dot = __fadd_rn(dot, __fmul_rn(g[f], t[f]));
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if (e < dims) acc[e] = __fadd_rn(acc[e], __fmul_rn(dw[e], dot));
  }
}

// G1. D > 0: the dims at compile time; D = 0: n_dims at run time, corner
// by corner.
template <typename DyT, int F, int D, bool kWindowed>
__global__ void __launch_bounds__(kWarps * 32)
    grid_backward_input_kernel(const float* __restrict__ x, const DyT* __restrict__ dy,
                               const float* __restrict__ params, const Level* __restrict__ levels,
                               float* __restrict__ dx, int batch, int n_dims, int n_levels, int dy_width, int interp,
                               int aligned) {
  constexpr int K = D > 0 ? D : kMaxDims;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_classes;
  float* s_part = stage_levels(smem, levels, nullptr, n_levels, &s_classes);
  const Level* s_levels = reinterpret_cast<const Level*>(smem);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dims = D > 0 ? D : n_dims;
  const int b0 = blockIdx.x * kTile, b = b0 + lane;
  const bool valid = b < batch;
  float xv[K], acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < dims) {
      xv[k] = valid ? __ldg(x + (size_t)b * dims + k) : 0.0f;
      acc[k] = 0.0f;
    }
  }
  const DyT* grow = dy + (size_t)(valid ? b : b0) * dy_width;
  const int n_corners = interp == kNearest ? 1 : 1 << dims;
  for (int lvl = warp; lvl < n_levels; lvl += kWarps) {
    const Level& lv = s_levels[lvl];
    const Window win = level_window<kWindowed>(levels, n_levels, lvl);
    float g[F], d1[K], d2[K];
    load_dy<DyT, F>(grow + lvl * F, valid, g);
    const Cell cell = cell_of(xv, lv, dims, interp);
    fraction_derivatives<K>(xv, lv, dims, interp, d1, d2);
    if constexpr (D > 0) {
      constexpr int C = 1 << D;
      uint32_t row[C];
      float t[C][F];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float w;
        if (c < n_corners) row[c] = table_row<kWindowed>(lv, win, corner(cell, lv, D, interp, c, &w));
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) load_held<F, kWindowed>(params, row[c], aligned, lv, t[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) input_corner<F, K>(cell, d1, d2, c, dims, g, t[c], acc);
      }
    } else {
      for (int c = 0; c < n_corners; ++c) {
        float w, t[F];
        load_held<F, kWindowed>(params, table_row<kWindowed>(lv, win, corner(cell, lv, dims, interp, c, &w)),
                                aligned, lv, t);
        input_corner<F, K>(cell, d1, d2, c, dims, g, t, acc);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < dims) s_part[(warp * dims + k) * kTile + lane] = acc[k];
  }
  __syncthreads();
  write_dx(s_part, dx, b0, min(batch - b0, kTile), dims);
}

// One corner of G2: its d/d(dL_dy) terms into gdy, its d/dx terms into ax;
// returns a_c = sum_e cgx_e dw_c[e].
template <int F, int K>
__device__ __forceinline__ float second_order_corner(const Cell& cell, const float (&d1)[K], const float (&d2)[K],
                                                     const float (&cx)[K], int c, int dims, bool has_cgx,
                                                     bool use_cgp, float w, const float (&g)[F], const float (&t)[F],
                                                     const float (&p)[F], float (&gdy)[F], float (&ax)[K]) {
  float dw[K], h[K];
  corner_derivatives<K>(cell, d1, d2, cx, c, dims, has_cgx, dw, h);
  float a = 0.0f;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if (e < dims) a = __fadd_rn(a, __fmul_rn(cx[e], dw[e]));
  }
  float dot = 0.0f, pdot = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    dot = __fadd_rn(dot, __fmul_rn(g[f], t[f]));
    gdy[f] = __fadd_rn(gdy[f], __fmul_rn(a, t[f]));
    if (use_cgp) {
      pdot = __fadd_rn(pdot, __fmul_rn(g[f], p[f]));
      gdy[f] = __fadd_rn(gdy[f], __fmul_rn(w, p[f]));
    }
  }
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if (e < dims) ax[e] = __fadd_rn(ax[e], __fadd_rn(__fmul_rn(h[e], dot), __fmul_rn(dw[e], pdot)));
  }
  return a;
}

// G2's table gradient for one corner: round(a_c * g_f) with the level's
// class added at table row `row` (kNoRow: this lane adds nothing). Lanes on
// equal rows merge first, then one vector atomic a row. Warp-uniform.
template <int F>
__device__ __forceinline__ void scatter_corner(uint32_t row, float a, const float (&g)[F], int contrib, bool half,
                                               float* __restrict__ grad32, __nv_bfloat16* __restrict__ grad16) {
  float v[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float t = round_contribution(__fmul_rn(a, g[f]), contrib);
    v[f] = row == kNoRow ? 0.0f : half ? bf16_round(t) : t;
  }
  if (!merge_runs<F>(row, v, half) || row == kNoRow) return;
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) any |= v[f] != 0.0f;
  if (!any) return;  // +-0 adds nothing
  if (half) {
    add_row_bf16<F>(grad16 + (size_t)row * F, v);
  } else {
    add_row_f32_global<F>(grad32 + (size_t)row * F, v);
  }
}

// G2. cgp / cgx may be null (zero cotangents); classes may be null (no
// class table: no level drops); grad32 null: no table scatter. Shared
// memory: the level table, the class codes, the d/dx partials, then the
// tile's d/d(dL_dy) rows (`row_stride` floats each, odd).
template <typename DyT, int F, int D, bool kWindowed>
__global__ void __launch_bounds__(kWarps * 32)
    grid_backward_backward_kernel(const float* __restrict__ x, const DyT* __restrict__ dy,
                                  const float* __restrict__ params, const float* __restrict__ cgp,
                                  const float* __restrict__ cgx, const Level* __restrict__ levels,
                                  const int* __restrict__ classes, float* __restrict__ grad32,
                                  __nv_bfloat16* __restrict__ grad16, float* __restrict__ d_x,
                                  float* __restrict__ d_dy, int batch, int n_dims, int n_levels, int dy_width,
                                  int interp, int aligned, int row_stride) {
  constexpr int K = D > 0 ? D : kMaxDims;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_classes;
  float* s_part = stage_levels(smem, levels, classes, n_levels, &s_classes);
  const Level* s_levels = reinterpret_cast<const Level*>(smem);
  const int dims = D > 0 ? D : n_dims;
  float* s_rows = s_part + kWarps * dims * kTile;
  if (dy_width > n_levels * F) {  // padding columns: zeros
    for (int i = threadIdx.x; i < kTile * row_stride; i += blockDim.x) s_rows[i] = 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kTile, b = b0 + lane;
  const bool valid = b < batch, has_cgx = cgx != nullptr;
  float xv[K], cx[K], ax[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < dims) {
      xv[k] = valid ? __ldg(x + (size_t)b * dims + k) : 0.0f;
      cx[k] = valid && has_cgx ? __ldg(cgx + (size_t)b * dims + k) : 0.0f;
      ax[k] = 0.0f;
    }
  }
  const DyT* grow = dy + (size_t)(valid ? b : b0) * dy_width;
  float* srow = s_rows + lane * row_stride;
  const int n_corners = interp == kNearest ? 1 : 1 << dims;
  for (int lvl = warp; lvl < n_levels; lvl += kWarps) {
    const Level& lv = s_levels[lvl];
    const Window win = level_window<kWindowed>(levels, n_levels, lvl);
    const int contrib = s_classes[2 * lvl], acc = s_classes[2 * lvl + 1];
    const bool use_cgp = cgp != nullptr && acc != kAccDrop;
    const bool scatter = grad32 != nullptr && acc != kAccDrop;
    const bool half = acc == kAccBf16;
    float g[F], gdy[F], d1[K], d2[K];
    load_dy<DyT, F>(grow + lvl * F, valid, g);
#pragma unroll
    for (int f = 0; f < F; ++f) gdy[f] = 0.0f;
    const Cell cell = cell_of(xv, lv, dims, interp);
    fraction_derivatives<K>(xv, lv, dims, interp, d1, d2);
    if constexpr (D > 0) {
      constexpr int C = 1 << D;
      uint32_t row[C];
      float w[C], t[C][F], p[C][F];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) row[c] = table_row<kWindowed>(lv, win, corner(cell, lv, D, interp, c, &w[c]));
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) {
          load_held<F, kWindowed>(params, row[c], aligned, lv, t[c]);
          if (use_cgp) load_held<F, kWindowed>(cgp, row[c], aligned, lv, p[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) {
          const float a = second_order_corner<F, K>(cell, d1, d2, cx, c, dims, has_cgx, use_cgp, w[c], g, t[c],
                                                    p[c], gdy, ax);
          if (scatter) scatter_corner<F>(valid ? row[c] : kNoRow, a, g, contrib, half, grad32, grad16);
        }
      }
    } else {
      for (int c = 0; c < n_corners; ++c) {
        float w, t[F], p[F];
        const uint32_t row = table_row<kWindowed>(lv, win, corner(cell, lv, dims, interp, c, &w));
        load_held<F, kWindowed>(params, row, aligned, lv, t);
        if (use_cgp) load_held<F, kWindowed>(cgp, row, aligned, lv, p);
        const float a = second_order_corner<F, K>(cell, d1, d2, cx, c, dims, has_cgx, use_cgp, w, g, t, p, gdy, ax);
        if (scatter) scatter_corner<F>(valid ? row : kNoRow, a, g, contrib, half, grad32, grad16);
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) srow[lvl * F + f] = gdy[f];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < dims) s_part[(warp * dims + k) * kTile + lane] = ax[k];
  }
  __syncthreads();
  const int rows = min(batch - b0, kTile);
  write_dx(s_part, d_x, b0, rows, dims);
  for (int r = warp; r < rows; r += kWarps) {
    for (int c = lane; c < dy_width; c += 32) d_dy[(size_t)(b0 + r) * dy_width + c] = s_rows[r * row_stride + c];
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed first. The
// attribute holds for the current device only, so every such launch sets it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One launch of G1 or G2 with F and D fixed; dispatch() picks them.
template <bool kWindowed>
struct InputLaunch {
  template <typename DyT, int F, int D>
  static cudaError_t run(unsigned blocks, size_t smem, cudaStream_t s, const float* x, const DyT* dy,
                         const float* params, const Level* lv, float* dx, int batch, int n_dims, int n_levels,
                         int dy_width, int interp, int aligned) {
    auto kernel = grid_backward_input_kernel<DyT, F, D, kWindowed>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kWarps * 32, smem, s>>>(x, dy, params, lv, dx, batch, n_dims, n_levels, dy_width, interp,
                                             aligned);
    return cudaGetLastError();
  }
};

template <bool kWindowed>
struct SecondOrderLaunch {
  template <typename DyT, int F, int D>
  static cudaError_t run(unsigned blocks, size_t smem, cudaStream_t s, const float* x, const DyT* dy,
                         const float* params, const float* cgp, const float* cgx, const Level* lv, const int* cls,
                         float* g32, __nv_bfloat16* g16, float* ox, float* ody, int batch, int n_dims, int n_levels,
                         int dy_width, int interp, int aligned, int row_stride) {
    auto kernel = grid_backward_backward_kernel<DyT, F, D, kWindowed>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kWarps * 32, smem, s>>>(x, dy, params, cgp, cgx, lv, cls, g32, g16, ox, ody, batch, n_dims,
                                             n_levels, dy_width, interp, aligned, row_stride);
    return cudaGetLastError();
  }
};

// Launch::run with F (1-8) and D (2, 3, else 0: the dims at run time) as
// compile-time constants.
template <typename Launch, typename DyT, typename... Args>
cudaError_t dispatch(int F, int n_dims, Args... args) {
#define TCNN_G_CASE(NF)                                                          \
  case NF:                                                                       \
    if (n_dims == 2) return Launch::template run<DyT, NF, 2>(args...);           \
    if (n_dims == 3) return Launch::template run<DyT, NF, 3>(args...);           \
    return Launch::template run<DyT, NF, 0>(args...);
  switch (F) {
    TCNN_G_CASE(1)
    TCNN_G_CASE(2)
    TCNN_G_CASE(3)
    TCNN_G_CASE(4)
    TCNN_G_CASE(5)
    TCNN_G_CASE(6)
    TCNN_G_CASE(7)
    TCNN_G_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef TCNN_G_CASE
}

// Bytes of G1's (row_stride 0) and G2's shared memory.
inline size_t second_order_smem(int n_levels, int n_dims, int row_stride) {
  return n_levels * (sizeof(Level) + 8) + (size_t)kWarps * n_dims * kTile * 4 + (size_t)kTile * row_stride * 4;
}

// Whether the operands' sizes are ones G1 and G2 take.
inline bool second_order_shapes_ok(int n_dims, int F, int n_levels, int dy_width) {
  return n_dims >= 1 && n_dims <= kMaxDims && F >= 1 && F <= kMaxF && n_levels >= 1 && n_levels <= kMaxLevels &&
         dy_width >= n_levels * F;
}

// G1's launch (the C entry points' body): dx (batch, n_dims) fp32 for dy
// (batch, dy_width) of type DyT.
template <bool kWindowed, typename DyT>
cudaError_t input_gradient(const void* x, const DyT* dy, const void* params, const void* levels, void* dx,
                           int batch, int n_dims, int n_levels, int F, int dy_width, int interp, cudaStream_t s) {
  if (!second_order_shapes_ok(n_dims, F, n_levels, dy_width)) return cudaErrorInvalidValue;
  if (batch <= 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((batch + kTile - 1) / kTile);
  const size_t smem = second_order_smem(n_levels, n_dims, 0);
  const int aligned = reinterpret_cast<uintptr_t>(params) % 16 == 0;
  return dispatch<InputLaunch<kWindowed>, DyT>(F, n_dims, blocks, smem, s, static_cast<const float*>(x), dy,
                                               static_cast<const float*>(params), static_cast<const Level*>(levels),
                                               static_cast<float*>(dx), batch, n_dims, n_levels, dy_width, interp,
                                               aligned);
}

// G2's launches (the C entry points' body): the zeroed table gradient, the
// kernel and the fold of the bf16 sums.
template <bool kWindowed, typename DyT>
cudaError_t double_backward(const void* x, const DyT* dy, const void* params, const void* cgp, const void* cgx,
                            const void* levels, const void* classes, void* grad32, void* grad16, void* d_x,
                            void* d_dy, int batch, int n_dims, int n_levels, int F, int dy_width, int interp,
                            int64_t n_values, cudaStream_t s) {
  if (!second_order_shapes_ok(n_dims, F, n_levels, dy_width)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (grad32 != nullptr) err = cudaMemsetAsync(grad32, 0, n_values * 4, s);
  if (err == cudaSuccess && grad16 != nullptr) err = cudaMemsetAsync(grad16, 0, n_values * 2, s);
  if (err != cudaSuccess) return err;
  if (batch > 0) {
    const unsigned blocks = (unsigned)((batch + kTile - 1) / kTile);
    const int row_stride = dy_width | 1;
    const size_t smem = second_order_smem(n_levels, n_dims, row_stride);
    const int aligned = reinterpret_cast<uintptr_t>(params) % 16 == 0 && reinterpret_cast<uintptr_t>(cgp) % 16 == 0;
    err = dispatch<SecondOrderLaunch<kWindowed>, DyT>(
        F, n_dims, blocks, smem, s, static_cast<const float*>(x), dy, static_cast<const float*>(params),
        static_cast<const float*>(cgp), static_cast<const float*>(cgx), static_cast<const Level*>(levels),
        static_cast<const int*>(classes), static_cast<float*>(grad32), static_cast<__nv_bfloat16*>(grad16),
        static_cast<float*>(d_x), static_cast<float*>(d_dy), batch, n_dims, n_levels, dy_width, interp, aligned,
        row_stride);
    if (err != cudaSuccess) return err;
  }
  if (grad32 != nullptr && grad16 != nullptr) {
    fold_bf16_kernel<<<blocks_for(n_values), kThreads, 0, s>>>(
        static_cast<float*>(grad32), static_cast<const __nv_bfloat16*>(grad16), n_values);
  }
  return cudaGetLastError();
}

}  // namespace tcnn_grid

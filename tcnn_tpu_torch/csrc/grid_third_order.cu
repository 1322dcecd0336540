// The grid encoding's third order (G3) for Hopper (sm_90a): the gradients
// of the double backward (G2, grid_input_grad.cu), for a whole table
// (tcnn_grid_backward3) and for a rank of a row-sharded table
// (tcnn_grid_backward3_windowed). The kernel, grid_third_order_kernel,
// lives in grid_input_grad.cuh beside G1's and G2's; this translation unit
// holds only its instantiations, so that grid_input_grad.cu's and
// grid_sharded.cu's builds do not grow.
//
// Replaces: XLA autodiff of tcnn_tpu/encodings/grid.py:GridEncoding.apply
// (:1354) taken three times (jax.grad of a loss holding a Hessian-vector
// product, as a curvature regulariser of an SDF), which has no Pallas
// kernel; the port took it by autograd of the plain G2 (a loop over levels
// of torch ops, several hundred small kernels a step) until this kernel.
//
// What it computes (ops/grid_encode.py:grid_third_order_plain): for the
// cotangents (g_params, g_x, g_dy) of G2's (P, X, Y), per level and corner,
// with a_c = cgx . dw_c, e_c = g_x . dw_c, h_c = g_x^T H_c cgx and T_c, p_c,
// q_c the rows of the table, cgp and g_params at idx_c:
// - d/dparams += round(h_c g + a_c gy) at idx_c with the level's class;
// - d/dcgp += round(e_c g + w_c gy) at idx_c with the level's class;
// - d/d(dL_dy) += a_c q_c + e_c p_c + h_c T_c;
// - d/dcgx += dw_c <g, q_c> + (H_c g_x) <g, T_c> + dw_c <gy, T_c>;
// - d/dx += (H_c cgx) <g, q_c> + (H_c g_x) <g, p_c> + T3_c[g_x, cgx] <g, T_c>
//   + dw_c <gy, p_c> + (H_c cgx) <gy, T_c>,
// T3_c the third derivatives of the d-linear (or smoothstep) weight: a
// product of d factors with one, two or three of them replaced by their
// first, second or third derivatives (Linear: only three distinct dims;
// Smoothstep: s''' = -12). The class scatters are the JAX package's: its
// lookup gathers through a linear pair whose transpose is the level's class
// scatter at every order (tcnn_tpu/ops/scatter_rows.py:gather_rows), so the
// third order's table gradient is rounded, summed in bf16 or dropped as the
// first order's is, and p_c, q_c are read rounded as the table is.
//
// What bounds it: like G2, B * L * 2^d random table rows read (the 3D
// model: 16 levels, 8 corners, 8-byte rows in a 52 MB table) and as many
// rows added into the table gradient; beyond G2 it computes per corner the
// d^3 third-derivative products and two Hessian contractions (at d = 3:
// 3 + 9 + 27 products of 3 factors).
//
// Design: G2's, one kernel for every combination of operands: a block of
// kWarps warps owns kTile = 32 samples, one a lane, warp w levels w, w +
// kWarps, ...; F and d (2, 3) compile-time constants, any other d at run
// time; every corner's row and weight first, the table rows of all corners
// loaded before any is used (cgp and g_params rows, absent on the
// curvature path, per corner); d/dx and d/dcgx summed in registers a warp
// and in warp order over the block and d/d(dL_dy) staged as rows in shared
// memory, so the three are bitwise repeatable; the two table-shaped outputs
// scattered as G2 scatters its table gradient (lanes on equal rows merged,
// one vector atomic a row, bf16 atomics into scratch where a level sums in
// bf16, folded at the end), after the corners' terms, in a loop over the
// corners that is not unrolled (one copy of their merges and atomics).
// Every operand and output is optional (a null pointer) and gates its own
// loads, terms and scatters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_common.cuh"
#include "grid_input_grad.cuh"

using namespace tcnn_grid;

// Both entry points return the cudaError_t of their launches (0 on
// success), launch on `stream` and do not synchronise. x (batch, n_dims)
// fp32; cgp, g_params (n_values,) and cgx, g_x (batch, n_dims) fp32, g_dy
// (batch, dy_width) fp32, each null for zero; the outputs d_params, d_cgp
// (n_values,), d_x, d_cgx (batch, n_dims) and d_dy (batch, dy_width) fp32,
// each null where it is not wanted (d_params and d_cgp zeroed here).

// A whole table: dy bf16 when dy_bf16, else fp32; `classes` (null: every
// level fp32) the (n_levels, 2) class table; params16, cgp16: bf16 scratch
// of n_values each, needed where a level sums in bf16 (null otherwise).
extern "C" int tcnn_grid_backward3(const void* x, const void* dy, const void* params, const void* cgp,
                                   const void* cgx, const void* g_params, const void* g_x, const void* g_dy,
                                   const void* levels, const void* classes, void* d_params, void* d_x, void* d_dy,
                                   void* d_cgp, void* d_cgx, void* params16, void* cgp16, int batch, int n_dims,
                                   int n_levels, int F, int dy_width, int interp, int dy_bf16, int64_t n_values,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto* dy_typed) {
    using DyT = std::remove_const_t<std::remove_pointer_t<decltype(dy_typed)>>;
    return ThirdArgs<DyT>{static_cast<const float*>(x), dy_typed, static_cast<const float*>(params),
                          static_cast<const float*>(cgp), static_cast<const float*>(cgx),
                          static_cast<const float*>(g_params), static_cast<const float*>(g_x),
                          static_cast<const float*>(g_dy), static_cast<const Level*>(levels),
                          static_cast<const int*>(classes), static_cast<float*>(d_params), static_cast<float*>(d_x),
                          static_cast<float*>(d_dy), static_cast<float*>(d_cgp), static_cast<float*>(d_cgx),
                          static_cast<__nv_bfloat16*>(params16), static_cast<__nv_bfloat16*>(cgp16), batch, n_dims,
                          n_levels, dy_width, interp, 0, 0};
  };
  return (int)(dy_bf16 ? third_order<false>(args(static_cast<const __nv_bfloat16*>(dy)), F, n_values, s)
                       : third_order<false>(args(static_cast<const float*>(dy)), F, n_values, s));
}

// A rank of a row-sharded table: params, cgp, g_params, d_params and
// d_cgp its local rows (fp32 sums, no rounding: the windowed table
// gradient's class); `windows`, the (n_levels, 2) int32 windows, must
// follow the level table in memory (grid_sharded.cu); dy fp32. d_x, d_dy
// and d_cgx are the rank's partials.
extern "C" int tcnn_grid_backward3_windowed(const void* x, const void* dy, const void* params, const void* cgp,
                                            const void* cgx, const void* g_params, const void* g_x,
                                            const void* g_dy, const void* levels, const void* windows,
                                            void* d_params, void* d_x, void* d_dy, void* d_cgp, void* d_cgx,
                                            int batch, int n_dims, int n_levels, int F, int dy_width, int interp,
                                            int64_t n_values, void* stream) {
  if (windows != static_cast<const char*>(levels) + (size_t)n_levels * sizeof(Level))
    return (int)cudaErrorInvalidValue;
  const ThirdArgs<float> a{static_cast<const float*>(x), static_cast<const float*>(dy),
                           static_cast<const float*>(params), static_cast<const float*>(cgp),
                           static_cast<const float*>(cgx), static_cast<const float*>(g_params),
                           static_cast<const float*>(g_x), static_cast<const float*>(g_dy),
                           static_cast<const Level*>(levels), nullptr, static_cast<float*>(d_params),
                           static_cast<float*>(d_x), static_cast<float*>(d_dy), static_cast<float*>(d_cgp),
                           static_cast<float*>(d_cgx), nullptr, nullptr, batch, n_dims, n_levels, dy_width, interp,
                           0, 0};
  return (int)third_order<true>(a, F, n_values, static_cast<cudaStream_t>(stream));
}

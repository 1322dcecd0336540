// The grid encoding's input gradient (G1) and double backward (G2) for
// Hopper (sm_90a), their instantiations for a whole table. The kernels live
// in grid_input_grad.cuh, shared with grid_sharded.cu (the instantiations
// of a rank of a row-sharded table); this translation unit holds only
// these, so that grid_bwd.cu (the table gradient and the row scatter)
// builds without them.
//
// Replaces: XLA autodiff of tcnn_tpu/encodings/grid.py:GridEncoding.apply
// (:1354), which has no Pallas kernel; the reference's counterparts are
// kernel_grid_backward_input and kernel_grid_backward_input_backward_grid
// (encodings/grid.h).
//
// What it computes. G1: dL/dx_e = sum_l sum_c dw_c/dx_e * <dL_dy[b, l],
// T[idx_c]>, the table read rounded as the level table says (the lookup's
// reads). G2, for the cotangents (cgp, cgx) of the first backward's
// (dparams, dx): d/d(dL_dy)[b, l] = sum_c w_c cgp[idx_c] + a_c T[idx_c] with
// a_c = sum_e cgx_e dw_c/dx_e (a gather); d/dx = sum_c dw_c/dx <dL_dy,
// cgp[idx_c]> + (cgx^T Hess w_c) <dL_dy, T[idx_c]> (the cross second
// derivatives of the d-linear weight are not zero); d/dparams +=
// round(a_c * dL_dy[b, l]) at idx_c with the level's class (the same
// scatter as the table gradient). cgp is read as the table is (rounded to
// the level's table dtype where the lookup rounds its reads), as the JAX
// package's autodiff reads it: the transpose of its table gradient's
// scatter is the lookup's gather (tcnn_tpu/ops/scatter_rows.py:gather_rows,
// a linear_call pair). Every term is exact, as jax.grad of jax.grad is in
// the JAX package. The third order is G3 (grid_third_order.cu), the fourth
// and beyond autograd of its plain version.
//
// What bounds it: G1 and G2 read B * L * 2^d random table rows (32.5 M
// 8-byte rows at the 3D model, B = 2^18, in a 52 MB table that does not fit
// the L2), and G2 adds as many rows into the table gradient. The earlier
// kernels (one thread per sample walking every level and corner in order,
// loops unrolled to kMaxDims with run-time guards, a kMaxDims^3 Hessian loop
// a corner, 115 and 158 registers, one scalar atomic a contribution;
// deleted since) took 0.8447 and 4.3971 ms there, and kept 88% (G1) and 91%
// (G2 without its table scatter) of it with every corner reading one row:
// arithmetic and latency, not the rows, set them; G2's scalar atomics took
// 2.02 ms more (benchmarks/grid_second_order_times.py, NVIDIA H100 80GB
// HBM3, 700 W).
//
// Design: level-major tiles, as the lookup: a block of kWarps warps owns
// kTile = 32 consecutive samples, one a lane; warp w takes levels w, w +
// kWarps, ..., so a warp's lanes are 32 samples on one level and the level
// table sits in shared memory. d (2, 3) and F are compile-time constants,
// so every corner's row and weight is computed first and all row loads
// issued before any is used, the weight derivatives take d^2 products of d
// factors a corner (27 at d = 3), and x and cgx are read once a lane. d/dx
// sums in registers a warp and in warp order over the block:
// deterministic, no atomics. G2 stages its d/d(dL_dy) rows in shared
// memory (a padded row a sample, padding columns zero) and writes them
// whole, and scatters its table gradient as the table gradient kernel
// does (lanes on equal rows merged first, one vector atomic a row). No
// level is privatised: a block's 32 samples leave nothing to amortise a
// private copy over. Measured at the 3D model (same tool and card; ms, new
// / earlier kernel in one call): G1 0.2598 / 0.8434 (the lookup over the
// same rows 0.2616), G2 with cgx 1.0898 / 4.3963 (without its scatter
// 0.3760), with cgx and cgp 1.6315 / 4.6378.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "grid_input_grad.cuh"

using namespace tcnn_grid;

// Both entry points return the cudaError_t of their launches (0 on
// success), launch on `stream` and do not synchronise.

// dx (batch, n_dims) fp32: the input gradient of the lookup for output
// gradient dy (batch, dy_width), bf16 when dy_bf16 else fp32; the table
// `params` is read rounded as the level table says, as the lookup reads it.
extern "C" int tcnn_grid_backward_input(const void* x, const void* dy, const void* params,
                                        const void* levels, void* dx, int batch, int n_dims,
                                        int n_levels, int F, int dy_width, int interp,
                                        int dy_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dy_bf16 ? input_gradient<false>(x, static_cast<const __nv_bfloat16*>(dy), params, levels, dx, batch,
                                               n_dims, n_levels, F, dy_width, interp, s)
                       : input_gradient<false>(x, static_cast<const float*>(dy), params, levels, dx, batch, n_dims,
                                               n_levels, F, dy_width, interp, s));
}

// The double backward of the lookup for the cotangents cgp (n_values,) and
// cgx (batch, n_dims) fp32 of the first backward's (dparams, dx), either
// null for zero: d_x (batch, n_dims) and d_dy (batch, dy_width) fp32, and,
// when grad32 is not null, the table gradient grad32 (n_values,) fp32 with
// the classes' rounding, zeroed here (grad16: bf16 scratch of its size,
// needed where a level sums in bf16, folded into grad32 at the end).
// `classes` (null: no level drops) is the (n_levels, 2) class table.
extern "C" int tcnn_grid_backward_backward(const void* x, const void* dy, const void* params,
                                           const void* cgp, const void* cgx, const void* levels,
                                           const void* classes, void* grad32, void* grad16,
                                           void* d_x, void* d_dy, int batch, int n_dims,
                                           int n_levels, int F, int dy_width, int interp,
                                           int dy_bf16, int64_t n_values,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dy_bf16 ? double_backward<false>(x, static_cast<const __nv_bfloat16*>(dy), params, cgp, cgx, levels,
                                                classes, grad32, grad16, d_x, d_dy, batch, n_dims, n_levels, F,
                                                dy_width, interp, n_values, s)
                       : double_backward<false>(x, static_cast<const float*>(dy), params, cgp, cgx, levels, classes,
                                                grad32, grad16, d_x, d_dy, batch, n_dims, n_levels, F, dy_width,
                                                interp, n_values, s));
}

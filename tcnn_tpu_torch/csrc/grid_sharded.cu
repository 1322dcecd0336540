// The grid lookup and its table gradient over a row-sharded table, for
// Hopper (sm_90a): every level of the table split by rows over the ranks
// of a model-parallel group, each rank holding ceil(S_l / n) consecutive
// rows of level l (tcnn_tpu_torch/parallel/table_parallel.py).
//
// Replaces: tcnn_tpu/parallel/table_parallel.py:TableParallelGrid._local_apply
// (:137-195), the per-rank body of the JAX package's sharded lookup (XLA:
// per-level index arithmetic, one masked gather of the local rows), and its
// transpose under autodiff, the table gradient (XLA's scatter-add of the
// cotangent into the local rows, in fp32). Neither is a Pallas kernel.
//
// What it computes, per (sample, level, corner): the cell, the corner's
// level-local row r and weight exactly as grid_fwd.cu computes them
// (grid_common.cuh; affine levels fold every corner, MODE_FOLD, hashed
// levels hash it, and r is the remainder by the level's GLOBAL size); the
// rank's window of the level, (first, rows) from a (n_levels, 2) int32
// array, says whether the rank holds r: local row r - first when that is
// below rows (one unsigned compare), and then
// - the lookup (tcnn_grid_forward_windowed) reads the row as fp32 and adds
//   w * row in corner order (a corner the rank does not hold adds w * 0),
//   into fp32 partial features (batch, n_levels * F); the sum of the
//   ranks' partials (one all_reduce in the caller) is the lookup of the
//   whole table;
// - the table gradient (tcnn_grid_backward_windowed) adds w * dL_dy into
//   the rank's local row in fp32, the class the JAX package's autodiff gives
//   it (no contribution rounding, fp32 sums); dL_dy is the same on every
//   rank of the group, so no collective runs in the backward for it;
// - the input gradient (tcnn_grid_backward_input_windowed, G1's kernel)
//   sums dw_c/dx <dL_dy, T[r]> over the corners the rank holds: its partial
//   of dL/dx, which the caller sums over the model group (one all_reduce,
//   the transpose of the forward's feature sum);
// - the double backward (tcnn_grid_backward_backward_windowed, G2's
//   kernel) reads T and the cotangent cgp of the rank's table gradient at
//   the rows it holds and adds a_c dL_dy into its own rows: its table
//   gradient is local, its d/dx and d/d(dL_dy) partials the caller sums
//   over the group.
//
// Design: the instantiations of the existing kernels with one compare a
// corner added (grid_lookup.cuh, grid_table_grad.cuh, grid_input_grad.cuh, template parameter
// kWindowed; the windows follow the level table in one buffer, so the
// kernels' arguments and every other instantiation stay as they were), so
// that the lookup keeps its level-major warps and division-free index
// arithmetic, and the table gradient its warp-merged runs, private shared-memory copies (levels privatised by their LOCAL row
// count: ops/grid_encode.py:backward_plan of the rank's level table) and
// vector atomics. Their own translation unit: grid_fwd.cu's and
// grid_bwd.cu's builds and instantiations do not change. Positions are
// fp32 (the JAX package's sharded lookup has no fixed_point_pos); the
// forward writes fp32 only, so G1 and G2 take an fp32 dL_dy only (the
// gradient of the fp32 features; half of their instantiations).
//
// As for a whole table (ops/grid_encode.py), the kernels take the first
// and second orders; the third is the windowed G3 (grid_third_order.cu),
// the fourth and beyond autograd of its plain version.
//
// What bounds it: as the unsharded kernels, random L2 reads and the
// atomics' latency, not bytes: every rank computes every corner's index
// (the replicated index work the JAX package's design trades for memory)
// and reads or adds only the rows it holds, about 1/n of them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "grid_input_grad.cuh"
#include "grid_lookup.cuh"
#include "grid_table_grad.cuh"

using namespace tcnn_grid;

namespace {

// The windowed table gradient: the dims at compile time for d = 2, 3 (an
// Rng level's keys a cell at once, as grid_bwd_rng.cu), else at run time
// with the extras' per-corner jump.
struct WindowedCells {
  template <typename DyT, int F>
  static cudaError_t run(unsigned blocks, const Plan& plan, cudaStream_t s, const void* x, const DyT* dy,
                         const Level* levels, const int* classes, const float* u, float* grad32,
                         __nv_bfloat16* grad16, int batch, int n_dims, int n_levels, int dy_width, int interp,
                         int fixed, int rng_levels) {
    auto kernel = n_dims == 2   ? launch_tiled<DyT, F, false, 2, float, false, true>
                  : n_dims == 3 ? launch_tiled<DyT, F, false, 3, float, false, true>
                                : launch_tiled<DyT, F, true, 0, float, false, true>;
    return kernel(blocks, plan, s, x, dy, levels, classes, u, grad32, grad16, batch, n_dims, n_levels, dy_width,
                  interp, fixed);
  }
};

// Whether `windows` follows the level table `levels` of n_levels rows, as
// the windowed kernels read it.
bool windows_follow(const void* levels, const void* windows, int n_levels) {
  return windows == static_cast<const char*>(levels) + (size_t)n_levels * sizeof(Level);
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success), launch on
// `stream` and do not synchronise. `levels` is the device copy of the
// rank's (n_levels, 32) int32 level table (each level's offset its first
// LOCAL row, its size the level's global size, no rounding of reads, no
// fixed-point columns) and `windows` that of the (n_levels, 2) int32
// windows, which must follow it in memory (one buffer; the kernels read
// them at levels + n_levels); x is (batch, n_dims) fp32.
//
// out: (batch, out_width) fp32 partial features; padding columns zeros.
extern "C" int tcnn_grid_forward_windowed(const void* x, const void* params, const void* levels,
                                          const void* windows, void* out, int batch, int n_dims, int n_levels,
                                          int F, int out_width, int interp, int rng_levels, void* stream) {
  if (batch <= 0) return 0;
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF || n_levels < 1 || n_levels > kMaxLevels ||
      out_width < n_levels * F || !windows_follow(levels, windows, n_levels))
    return (int)cudaErrorInvalidValue;
  const LookupArgs a{x, static_cast<const float*>(params), static_cast<const Level*>(levels), batch, n_dims,
                     n_levels, out_width, interp, 0, rng_levels, nullptr};
  return (int)lookup<float, true>(F, a, static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// grad32: the rank's (n_values,) fp32 table gradient, zeroed and filled
// here; dy (batch, dy_width), bf16 when dy_bf16 else fp32; `classes` the
// (n_levels, 2) int32 class table, every level (no rounding, fp32 sums) =
// (0, 0); `plan` the host array of ops/grid_encode.py:BackwardPlan for the
// rank's local rows.
extern "C" int tcnn_grid_backward_windowed(const void* x, const void* dy, const void* levels, const void* classes,
                                           const void* windows, void* grad32, int batch, int n_dims, int n_levels,
                                           int F, int dy_width, int interp, int dy_bf16, int rng_levels,
                                           int64_t n_values, const void* plan, void* stream) {
  if (!windows_follow(levels, windows, n_levels)) return (int)cudaErrorInvalidValue;
  return table_gradient<WindowedCells>(x, dy, levels, classes, nullptr, grad32, nullptr, batch, n_dims, n_levels, F,
                                       dy_width, interp, dy_bf16, 0, rng_levels, n_values, plan, stream);
}

// dx (batch, n_dims) fp32: the rank's partial of the input gradient for
// the fp32 output gradient dy (batch, dy_width), from the corners it holds
// (params: its local rows, read unrounded as its level table says).
extern "C" int tcnn_grid_backward_input_windowed(const void* x, const void* dy, const void* params,
                                                 const void* levels, const void* windows, void* dx, int batch,
                                                 int n_dims, int n_levels, int F, int dy_width, int interp,
                                                 void* stream) {
  if (!windows_follow(levels, windows, n_levels)) return (int)cudaErrorInvalidValue;
  return (int)input_gradient<true>(x, static_cast<const float*>(dy), params, levels, dx, batch, n_dims, n_levels, F,
                                   dy_width, interp, static_cast<cudaStream_t>(stream));
}

// The rank's double backward for the cotangents cgp (n_values,: of its
// local table gradient) and cgx (batch, n_dims) fp32, either null for zero:
// its partials d_x (batch, n_dims) and d_dy (batch, dy_width) fp32 and, when
// grad32 is not null, its local table gradient grad32 (n_values,) fp32
// (every level fp32, no rounding: the class of the windowed table
// gradient), zeroed here. dy fp32.
extern "C" int tcnn_grid_backward_backward_windowed(const void* x, const void* dy, const void* params,
                                                    const void* cgp, const void* cgx, const void* levels,
                                                    const void* windows, void* grad32, void* d_x, void* d_dy,
                                                    int batch, int n_dims, int n_levels, int F, int dy_width,
                                                    int interp, int64_t n_values, void* stream) {
  if (!windows_follow(levels, windows, n_levels)) return (int)cudaErrorInvalidValue;
  return (int)double_backward<true>(x, static_cast<const float*>(dy), params, cgp, cgx, levels, nullptr, grad32,
                                    nullptr, d_x, d_dy, batch, n_dims, n_levels, F, dy_width, interp, n_values,
                                    static_cast<cudaStream_t>(stream));
}

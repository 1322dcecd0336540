// The table gradient of a grid with Rng levels, fp32 positions and d = 2 or
// 3, for Hopper (sm_90a): grid_table_grad.cuh's kernel with the dims at
// compile time, so that an Rng level's 2^d keys come a cell at once from
// grid_common.cuh's rng_corners() (one jump over each coordinate field's
// own bits, a composition a dim, 2^d multiply-adds) and stay in registers
// through the unrolled corner loop. A library of its own: its 32
// instantiations (F 1-8, bf16 or fp32 dL/dy, d 2 and 3) build beside
// grid_bwd.cu's, not after them.
//
// Replaces: the Rng hash of tcnn_tpu/encodings/grid.py:_grid_hash (:89,
// via tcnn_tpu/ops/pcg32_jump.py:pcg32_jump_output; jnp, no pallas_call)
// inside the table gradient; everything else is tcnn_grid_backward's
// (grid_bwd.cu). What bounds it: the jumps' 64-bit multiply-adds (INT32
// instructions), then the atomics and their latency, as
// tcnn_grid_backward's. Flagship encoding with "hash": "Rng", uniform
// points, B = 2^18, bf16 dL/dy: 0.2103-0.2141 ms against 0.5642-0.5652 for
// grid_bwd.cu's kExtras instantiation (the per-corner jump, 72 registers,
// 3 blocks an SM) in the same call; 50 registers at d = 2, 64 at d = 3, no
// spill (benchmarks/grid_ab_times.py --ptxas, NVIDIA H100 80GB HBM3, 700
// W; the CoherentAdditive table gradient 0.214-0.221).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "grid_table_grad.cuh"

using namespace tcnn_grid;

namespace {

struct RngCells {
  template <typename DyT, int F>
  static cudaError_t run(unsigned blocks, const Plan& plan, cudaStream_t s, const void* x, const DyT* dy,
                         const Level* levels, const int* classes, const float* u, float* grad32,
                         __nv_bfloat16* grad16, int batch, int n_dims, int n_levels, int dy_width, int interp,
                         int fixed, int rng_levels) {
    return (n_dims == 2 ? launch_tiled<DyT, F, false, 2> : launch_tiled<DyT, F, false, 3>)(
        blocks, plan, s, x, dy, levels, classes, u, grad32, grad16, batch, n_dims, n_levels, dy_width, interp,
        fixed);
  }
};

}  // namespace

// tcnn_grid_backward's arguments and result (grid_bwd.cu); x fp32, u null,
// fixed_point 0 and n_dims 2 or 3, else cudaErrorInvalidValue.
extern "C" int tcnn_grid_backward_rng(const void* x, const void* dy, const void* levels, const void* classes,
                                      const void* u, void* grad32, void* grad16, int batch, int n_dims,
                                      int n_levels, int F, int dy_width, int interp, int dy_bf16, int fixed_point,
                                      int rng_levels, int64_t n_values, const void* plan, void* stream) {
  if (u != nullptr || fixed_point || (n_dims != 2 && n_dims != 3)) return (int)cudaErrorInvalidValue;
  return table_gradient<RngCells>(x, dy, levels, classes, u, grad32, grad16, batch, n_dims, n_levels, F, dy_width,
                                  interp, dy_bf16, fixed_point, rng_levels, n_values, plan, stream);
}

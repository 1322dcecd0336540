// The table gradient of two grid modes, for Hopper (sm_90a): uint32
// positions (fixed_point_pos), and stochastic interpolation's one sampled
// corner, each for a table without Rng levels and d = 2 or 3; and the
// transpose of the sampled one, tcnn_grid_forward_sampled (below).
// grid_table_grad.cuh's kernel with the dims, the position type and the
// sampled corner at compile time: the corner loop unrolls (a sampled call's
// runs once, its corner taken before it), the fixed-point and sampled
// branches are resolved by the compiler, and none of the Rng hash is
// compiled in. A library of its own: its 64 instantiations (F 1-8, bf16 or
// fp32 dL/dy, d 2 and 3, the two modes) build beside grid_bwd.cu's, not
// after them.
//
// Replaces: tcnn_tpu/encodings/grid.py:GridEncoding.apply under
// fixed_point_pos (:1580; XLA) and grid.py:_stochastic_combine (:130; a
// custom_vjp), inside the table gradient; everything else is
// tcnn_grid_backward's (grid_bwd.cu), whose kExtras instantiation (run-time
// dims, the two modes and the Rng jump as run-time branches: 72 registers,
// 3 blocks an SM) took both before.
//
// What bounds it: as tcnn_grid_backward, not bytes but the latency of the
// scattered atomics, so occupancy: these instantiations must stay at or
// under the common one's 63 registers (4 blocks of 256 an SM). A sampled
// call adds one row a (sample, level) instead of 2^d, so its floor is
// about a quarter of the table gradient's. Flagship encoding, uniform
// points, B = 2^18, bf16 dL/dy: uint32 positions 0.2034-0.2074 ms against
// 0.3239-0.3269 for kExtras in the same call and 0.2166-0.2216 for the
// CoherentAdditive table gradient of the same points as fp32; the sampled
// corner 0.0899-0.0900 against 0.1267-0.1319; 35 / 31 registers at F = 2,
// d = 2 (31-56 over all 64), no spill (benchmarks/grid_ab_times.py
// --ptxas, NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "grid_lookup.cuh"
#include "grid_table_grad.cuh"

using namespace tcnn_grid;

namespace {

template <typename PosT, bool kSampled>
struct ModeCells {
  template <typename DyT, int F>
  static cudaError_t run(unsigned blocks, const Plan& plan, cudaStream_t s, const void* x, const DyT* dy,
                         const Level* levels, const int* classes, const float* u, float* grad32,
                         __nv_bfloat16* grad16, int batch, int n_dims, int n_levels, int dy_width, int interp,
                         int fixed, int rng_levels) {
    return (n_dims == 2 ? launch_tiled<DyT, F, false, 2, PosT, kSampled>
                        : launch_tiled<DyT, F, false, 3, PosT, kSampled>)(
        blocks, plan, s, x, dy, levels, classes, u, grad32, grad16, batch, n_dims, n_levels, dy_width, interp,
        fixed);
  }
};

}  // namespace

// tcnn_grid_backward's arguments and result (grid_bwd.cu); x uint32
// (fixed_point 1), u null, no Rng level and n_dims 2 or 3, else
// cudaErrorInvalidValue.
extern "C" int tcnn_grid_backward_fixed(const void* x, const void* dy, const void* levels, const void* classes,
                                        const void* u, void* grad32, void* grad16, int batch, int n_dims,
                                        int n_levels, int F, int dy_width, int interp, int dy_bf16,
                                        int fixed_point, int rng_levels, int64_t n_values, const void* plan,
                                        void* stream) {
  if (u != nullptr || !fixed_point || rng_levels || (n_dims != 2 && n_dims != 3)) return (int)cudaErrorInvalidValue;
  return table_gradient<ModeCells<uint32_t, false>>(x, dy, levels, classes, u, grad32, grad16, batch, n_dims,
                                                    n_levels, F, dy_width, interp, dy_bf16, fixed_point, rng_levels,
                                                    n_values, plan, stream);
}

// The same for fp32 x with stochastic interpolation's (batch, n_levels)
// uniforms u (not null), no Rng level and n_dims 2 or 3.
extern "C" int tcnn_grid_backward_sampled(const void* x, const void* dy, const void* levels, const void* classes,
                                          const void* u, void* grad32, void* grad16, int batch, int n_dims,
                                          int n_levels, int F, int dy_width, int interp, int dy_bf16,
                                          int fixed_point, int rng_levels, int64_t n_values, const void* plan,
                                          void* stream) {
  if (u == nullptr || fixed_point || rng_levels || (n_dims != 2 && n_dims != 3)) return (int)cudaErrorInvalidValue;
  return table_gradient<ModeCells<float, true>>(x, dy, levels, classes, u, grad32, grad16, batch, n_dims,
                                                n_levels, F, dy_width, interp, dy_bf16, fixed_point, rng_levels,
                                                n_values, plan, stream);
}

// tcnn_grid_forward_sampled: per (sample, level) the row of `table` at the
// corner that stochastic interpolation's table gradient picks for the
// uniform u[b, level] (tcnn_grid_backward_sampled's corner, by the same
// sampled_corner()), read as the lookup reads its table (the level
// table's rounding), weight 1; the padding columns zeros.
// With `table` a cotangent of the sampled table gradient (cgp) this is
// d/d(dL_dy) of <cgp, table gradient>: the second derivative through that
// gradient (tcnn_tpu/encodings/grid.py:_stochastic_combine_bwd, :145,
// differentiated by the JAX package's autodiff; no Pallas kernel). It is
// the lookup kernel (grid_lookup.cuh) with kSampled set: level-major tiles,
// one row load a (sample, level) instead of 2^d, the output staged and
// written whole. What bounds it: one random 8-byte row a (sample, level)
// (16 levels x 2^18 samples: 4.2 M rows in a table that may exceed the
// L2), beside the (B, L) uniforms read and the (B, width) output written.
//
// x (batch, n_dims) fp32, or uint32 with fixed_point; `levels` the level
// table; u (batch, n_levels) fp32;
// out (batch, out_width) fp32. Returns the launch's cudaError_t.
extern "C" int tcnn_grid_forward_sampled(const void* x, const void* table, const void* levels, const void* u,
                                         void* out, int batch, int n_dims, int n_levels, int F, int out_width,
                                         int interp, int fixed_point, int rng_levels, void* stream) {
  if (batch <= 0) return 0;
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF || n_levels < 1 || n_levels > kMaxLevels ||
      out_width < n_levels * F || u == nullptr)
    return (int)cudaErrorInvalidValue;
  const LookupArgs a{x, static_cast<const float*>(table), static_cast<const Level*>(levels), batch, n_dims,
                     n_levels, out_width, interp, fixed_point, rng_levels, static_cast<const float*>(u)};
  return (int)lookup<float, false, true>(F, a, static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

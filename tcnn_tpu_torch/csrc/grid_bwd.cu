// Row scatter-add with per-contribution rounding, and the grid encoding's
// table gradient built on it, for Hopper (sm_90a). The lookup's input
// gradient and double backward (G1, G2) are grid_input_grad.cu's.
//
// Replaces: the Pallas scatters of tcnn_tpu/ops/scatter_rows.py --
// scatter_rows_factored_pallas (:259, body _factored_kernel :204; pair,
// single and stochastic rounding), scatter_rows_onehot (:68; bf16 operands,
// fp32 sums) and scatter_rows_serial (:133; fp32) -- which the JAX package
// uses as the transpose of the grid lookup (encodings/grid.py, via
// ops/scatter_rows.py:_factored_scatter_of :514) next to XLA's scatter-add
// emitter in fp32 or bf16. On this card the sum is what the reference does
// (encodings/grid.h atomics): every contribution is added atomically
// (straight into the result, or into a block's shared-memory copy).
//
// What it computes: out[idx[n], :] += round(rows[n, :]) (tcnn_scatter_rows),
// and for the grid (tcnn_grid_backward) the table gradient: per (sample,
// level) the corner indices and weights exactly as grid_fwd.cu computes them
// (grid_common.cuh: locate, corner), and round(w_c * dL_dy[b, lvl*F + f])
// added to table row offset + idx_c, feature f. round() is the contribution
// class of the level: none, round-to-nearest bf16, or value-hashed
// stochastic bf16 (tcnn_tpu/ops/scatter_rows.py:_sr_round_bits :187). The sum
// is in fp32 into an fp32 buffer, or, for the half classes, in bf16 with
// every add rounded to bf16 (into a bf16 buffer folded into the fp32 result
// at the end); a level of class "drop" adds nothing. Zero contributions are
// skipped, so an entry no sample touched stays an exact +0 (the optimizer's
// skip-zero-gradient test reads that). Nothing of size (B * L * 2^d, F) is
// materialised.
//
// What bounds it on this card: the table gradient at the flagship (B =
// 2^18, 16 levels x 4 corners x 2 features) adds 16.8 M row contributions
// into a 2.8 MB table that stays in the 50 MB L2, against ~20 MB of inputs. Not HBM and
// not arithmetic, but the atomics: their number, the L2's rate for them,
// and collisions, since adds to one address serialise in the L2. Training
// batches are stratified (sample j in raster tile j of a 512^2 partition):
// neighbouring samples fall in the same cells of the coarse levels, about
// 1,100 samples a cell at level 0, so a kernel that adds every contribution
// on its own sends long runs of adds to a few addresses. An earlier kernel
// (one thread per (sample, level), level fastest, a scalar atomic per
// contribution: 33.5 M at the flagship; deleted since) took
// 1.6043 ms on a stratified batch and 0.7465 ms on uniform points (NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke.py phase 13 and the training profile).
//
// Design (tcnn_grid_backward): level-major tiles. A block owns a run of
// consecutive samples (backward_plan's chunk, 512 at the flagship) and
// takes them 256 at a time, walking the levels with one sample per thread,
// so a warp's 32 lanes are 32 consecutive samples on one level and the
// level's constants sit in shared memory. Per corner:
// - lanes whose target rows are equal and adjacent (the runs a stratified
//   batch makes) first sum their contributions with a segmented shuffle
//   scan, in fp32 or with every add rounded to bf16; a warp whose lanes all
//   differ (uniform points) pays one shuffle and one ballot;
// - the run's first lane adds the row: into the block's private copy of the
//   level in shared memory where the plan privatised it (levels of at most
//   four rows a sample of the block: 0-2 at the flagship, fp32 or bf16 by
//   class, flushed at the end with one global add per non-zero row), else
//   into the table gradient with one vector atomic (float2 / float4 for
//   fp32, bf16x2 for bf16) where F allows.
// dy is read from global memory (a lane's F values 64 bytes from its
// neighbour's; a variant that staged the tile's rows in shared memory with
// 16-byte loads bought nothing and was removed). The plan's two choices
// were swept with benchmarks/grid_bwd_plans.py (NVIDIA H100 80GB HBM3, 700
// W): the kernel waits on latency more than on the atomics' rate, so the
// block count decides (stratified flagship batch: 128 blocks 0.5892-0.6173
// ms, 256 0.3236-0.3485, 512 0.2184-0.2282); privatising a level whose rows
// a block hits about once or less gains nothing (the flagship's level 3:
// +1-4%). Measured (chip_smoke.py phase 13; new / earlier kernel / one
// index_add_ of the precomputed fp32 (row, contribution) pairs, ms):
// stratified flagship batch 0.2263 / 1.7330 / 0.5533; uniform flagship
// points 0.2389 / 0.8735 / 0.4398; the 3D model in its training classes
// 0.6127 / 2.1709 / 0.5604. The flagship now runs below the card's
// random-row scatter rate (0.3314 ms for its 16.8 M rows): the merges and
// the private copies remove atomics.
// The contribution is still round(__fmul_rn(w_c, g_f)) with the level's
// class: the same terms bit for bit; only the order of the sums differs,
// which the fp32 and bf16 tolerances of the tests allow. The kernel and
// its helpers live in grid_table_grad.cuh, shared with grid_bwd_rng.cu,
// which launches it for tables with Rng levels (fp32 positions, d = 2, 3)
// with the dims at compile time: an Rng level's keys a cell at once
// (grid_common.cuh:rng_corners), and with grid_bwd_modes.cu, which
// launches it for uint32 positions and for a sampled corner (no Rng level,
// d = 2, 3) with the dims, the position type and the sampling at compile
// time.
//
// tcnn_scatter_rows (the generic row scatter, K5/K6) is bound by its
// atomics: into a small table every address takes a long serial run of
// adds in the L2 (2^18 rows of 4 into 64 slots: 4,096 adds an address; the
// earlier one-thread-an-element kernel and index_add_ both took ~0.1 ms
// there, against a bytes bound of 0.0016 ms). The host plan
// (ops/scatter_rows.py:scatter_rows_plan) picks the vector width and, for
// fp32 sums where the flushes would be at most an eighth of the adds with
// a block on every SM, private blocks: each adds into a shared-memory copy
// of the whole table and flushes it once with float4 atomics. Every other case
// (bf16 sums included: their every add rounds to bf16, which the private
// copy would have to repeat) adds one vector atomic a row chunk straight
// into the result, four chunks a thread in flight; index math is 32-bit.
// Measured (benchmarks/lookup_scatter_times.py, NVIDIA H100 80GB HBM3, 700
// W; device ms a call, kernel / index_add_): 64 slots 0.0187 / 0.1000, the
// P3 shapes 0.0126 / 0.0197 and 0.0122 / 0.0197, P19 0.0078 / 0.0085.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"
#include "grid_table_grad.cuh"

using namespace tcnn_grid;

namespace {

// The row scatter (tcnn_scatter_rows), laid out by the host's plan
// (ops/scatter_rows.py:scatter_rows_plan, ScatterRowsPlan.args), entry by
// entry.
enum ScatterArg { sN, sS, sR, sAcc, sPrivate, sVec, sPerRow, sPerRowShift, sThreads, sGrid, sSmem };
constexpr int kPrivateThreads = 1024;

// Item t of the scatter: row n = t / T and its VEC-wide chunk (T = R / VEC
// threads a row; a shift where T is a power of two).
__device__ __forceinline__ uint32_t item_row(uint32_t t, int T, int t_shift) {
  return t_shift >= 0 ? t >> t_shift : t / (uint32_t)T;
}

template <int VEC>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// out[idx[n], :] += round(rows[n, :]), 32-bit index math (N x R and S x R
// below 2^31, checked on the host). kIlp items a thread in flight
// (grid-stride), each an index and a VEC-wide row chunk loaded and rounded
// before any add. PRIVATE (fp32 sums only): the block zeroes its shared
// copy of the whole (S, R) result, adds into it with scalar shared atomics,
// then flushes every non-zero float4 of it with one vector atomic; the plan
// privatises only where the flushes are at most an eighth of the adds.
// Else one vector atomic a chunk straight into the result: float4 / float2
// for fp32 sums; for bf16 sums (every add rounded to bf16) bf16x2 atomics
// into the bf16 buffer, which stays on this global path (no private bf16
// copy), folded into the fp32 result afterwards. An all-zero chunk adds
// nothing.
template <int VEC, bool PRIVATE, bool BF16>
__global__ void __launch_bounds__(PRIVATE ? kPrivateThreads : kMaxThreads)
    scatter_rows_kernel(const int* __restrict__ idx, const float* __restrict__ rows, float* __restrict__ out32,
                        __nv_bfloat16* __restrict__ out16, uint32_t N, uint32_t S, int R, int T, int t_shift,
                        int contrib) {
  constexpr int kIlp = PRIVATE ? 2 : 4;
  extern __shared__ __align__(16) float acc[];
  const uint32_t n_acc = S * (uint32_t)R;
  if constexpr (PRIVATE) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (uint32_t e = threadIdx.x; e < n_acc / 4; e += blockDim.x) reinterpret_cast<float4*>(acc)[e] = zero;
    for (uint32_t e = n_acc / 4 * 4 + threadIdx.x; e < n_acc; e += blockDim.x) acc[e] = 0.0f;
    __syncthreads();
  }
  const uint32_t n_items = N * (uint32_t)T;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t0 = blockIdx.x * blockDim.x + threadIdx.x; t0 < n_items; t0 += kIlp * stride) {
    uint32_t r[kIlp], at[kIlp];
    float v[kIlp][VEC];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const uint32_t t = t0 + k * stride;
      r[k] = 0xFFFFFFFFu, at[k] = 0;
      if (t < n_items) {
        const uint32_t n = item_row(t, T, t_shift);
        const uint32_t c = (t - n * (uint32_t)T) * VEC;
        r[k] = (uint32_t)__ldg(idx + n);
        at[k] = c;
        load_chunk<VEC>(rows + n * (uint32_t)R + c, v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      if (r[k] >= S) continue;  // outside the table (or no item): no row to add to
      bool any = false;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] = round_contribution(v[k][j], contrib);
        any |= v[k][j] != 0.0f;
      }
      if (!any) continue;  // +-0 adds nothing
      const uint32_t e = r[k] * (uint32_t)R + at[k];
      if constexpr (PRIVATE) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (v[k][j] != 0.0f) atomicAdd(acc + e + j, v[k][j]);
      } else if constexpr (BF16) {
        add_row_bf16<VEC>(out16 + e, v[k]);
      } else {
        add_row_f32_global<VEC>(out32 + e, v[k]);
      }
    }
  }
  if constexpr (PRIVATE) {
    __syncthreads();
    for (uint32_t e = threadIdx.x; e < n_acc / 4; e += blockDim.x) {
      const float4 a = reinterpret_cast<const float4*>(acc)[e];
      if (a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f) atomicAdd(reinterpret_cast<float4*>(out32) + e, a);
    }
    for (uint32_t e = n_acc / 4 * 4 + threadIdx.x; e < n_acc; e += blockDim.x)
      if (acc[e] != 0.0f) atomicAdd(out32 + e, acc[e]);
  }
}

// The table gradient's instantiations with the dims at run time: the
// common one, and kExtras for uint32 positions, u or an Rng level where no
// compile-time-d instantiation takes them (ops/grid_encode.py:
// _backward_route; grid_bwd_rng.cu takes an Rng table with fp32 positions
// and d = 2, 3, grid_bwd_modes.cu uint32 positions or u without Rng levels
// at d = 2, 3).
struct CommonOrExtras {
  template <typename DyT, int F>
  static cudaError_t run(unsigned blocks, const Plan& plan, cudaStream_t s, const void* x, const DyT* dy,
                         const Level* levels, const int* classes, const float* u, float* grad32,
                         __nv_bfloat16* grad16, int batch, int n_dims, int n_levels, int dy_width, int interp,
                         int fixed, int rng_levels) {
    const bool extras = fixed || u != nullptr || rng_levels;
    return (extras ? launch_tiled<DyT, F, true, 0> : launch_tiled<DyT, F, false, 0>)(
        blocks, plan, s, x, dy, levels, classes, u, grad32, grad16, batch, n_dims, n_levels, dy_width, interp,
        fixed);
  }
};

}  // namespace

// Both entry points return the cudaError_t of their launches (0 on
// success), launch on `stream` and do not synchronise. They zero their
// outputs first. `out16`/`grad16` is bf16 scratch of the output's size,
// needed (non-null) only when some contribution accumulates in bf16; its
// sums are folded into the fp32 output at the end.

template <int VEC>
cudaError_t launch_scatter(const int32_t* p, cudaStream_t s, const int* idx, const float* rows, float* out32,
                           __nv_bfloat16* out16, int contrib) {
  const dim3 grid(p[sGrid]), block(p[sThreads]);
  const size_t smem = (size_t)p[sSmem];
  const uint32_t N = p[sN], S = p[sS];
  const int R = p[sR], T = p[sPerRow], ts = p[sPerRowShift];
  if (p[sPrivate] > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(scatter_rows_kernel<VEC, true, false>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    scatter_rows_kernel<VEC, true, false><<<grid, block, smem, s>>>(idx, rows, out32, out16, N, S, R, T, ts, contrib);
  } else if (p[sAcc] == kAccBf16) {
    scatter_rows_kernel<VEC, false, true><<<grid, block, 0, s>>>(idx, rows, out32, out16, N, S, R, T, ts, contrib);
  } else {
    scatter_rows_kernel<VEC, false, false><<<grid, block, 0, s>>>(idx, rows, out32, out16, N, S, R, T, ts, contrib);
  }
  return cudaGetLastError();
}

// out (S, R) fp32 = sum over n of round(rows[n]) at row idx[n]: `plan` is
// the host plan's int32 array (ScatterArg above), `contrib` the
// contribution rounding; out16 is bf16 scratch of the output's size for
// ACC_BF16 (else null).
extern "C" int tcnn_scatter_rows(const void* idx, const void* rows, void* out32, void* out16, int contrib,
                                 const int32_t* plan, void* stream) {
  const int32_t* p = plan;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int acc = p[sAcc], vec = p[sVec];
  const int64_t n_out = (int64_t)p[sS] * p[sR];
  if (acc == kAccBf16 && out16 == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out32, 0, n_out * 4, s);
  if (err == cudaSuccess && acc == kAccBf16) err = cudaMemsetAsync(out16, 0, n_out * 2, s);
  if (err != cudaSuccess) return (int)err;
  if (p[sN] > 0 && p[sGrid] > 0 && acc != kAccDrop) {
    const int* ix = static_cast<const int*>(idx);
    const float* rw = static_cast<const float*>(rows);
    float* o32 = static_cast<float*>(out32);
    __nv_bfloat16* o16 = static_cast<__nv_bfloat16*>(out16);
    err = vec == 4 ? launch_scatter<4>(p, s, ix, rw, o32, o16, contrib)
        : vec == 2 ? launch_scatter<2>(p, s, ix, rw, o32, o16, contrib)
                   : launch_scatter<1>(p, s, ix, rw, o32, o16, contrib);
    if (err != cudaSuccess) return (int)err;
  }
  if (acc == kAccBf16) {
    fold_bf16_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(static_cast<float*>(out32),
                                                             static_cast<const __nv_bfloat16*>(out16), n_out);
  }
  return (int)cudaGetLastError();
}

// grad32 (n_values,) fp32: the table gradient of the flat grid parameters
// for output gradient dy (batch, dy_width), bf16 when dy_bf16 else fp32, at
// positions x (batch, n_dims), fp32 or, with fixed_point, uint32.
// `classes` is the device copy of the (n_levels, 2) int32 table of
// (contribution rounding, accumulation) codes; `u` null or stochastic
// interpolation's (batch, n_levels) fp32 uniforms; `plan` is a host array
// of kPlanHeader + n_levels int32 (ops/grid_encode.py:BackwardPlan.array).
extern "C" int tcnn_grid_backward(const void* x, const void* dy, const void* levels, const void* classes,
                                  const void* u, void* grad32, void* grad16, int batch, int n_dims, int n_levels,
                                  int F, int dy_width, int interp, int dy_bf16, int fixed_point, int rng_levels,
                                  int64_t n_values, const void* plan, void* stream) {
  return table_gradient<CommonOrExtras>(x, dy, levels, classes, u, grad32, grad16, batch, n_dims, n_levels, F,
                                        dy_width, interp, dy_bf16, fixed_point, rng_levels, n_values, plan, stream);
}

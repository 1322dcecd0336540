// Row scatter-add with per-contribution rounding, and the grid encoding's
// derivatives built on it, for Hopper (sm_90a): the table gradient, the
// input gradient and the double backward of the lookup.
//
// Replaces: the Pallas scatters of tcnn_tpu/ops/scatter_rows.py --
// scatter_rows_factored_pallas (:259, body _factored_kernel :204; pair,
// single and stochastic rounding), scatter_rows_onehot (:68; bf16 operands,
// fp32 sums) and scatter_rows_serial (:133; fp32) -- which the JAX package
// uses as the transpose of the grid lookup (encodings/grid.py, via
// ops/scatter_rows.py:_factored_scatter_of :514) next to XLA's scatter-add
// emitter in fp32 or bf16. On this card the sum is what the reference does
// (encodings/grid.h atomics): every contribution is added atomically
// (straight into the result, or into a block's shared-memory copy). The
// input gradient (tcnn_grid_backward_input, G1) and the double backward
// (tcnn_grid_backward_backward, G2) replace XLA autodiff of
// tcnn_tpu/encodings/grid.py:GridEncoding.apply (:1354), which has no Pallas
// kernel; the reference's counterparts are kernel_grid_backward_input and
// kernel_grid_backward_input_backward_grid (encodings/grid.h).
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
// G1: dL/dx_e = sum_l sum_c dw_c/dx_e * <dL_dy[b, l], T[idx_c]>, the table
// read rounded as the level table says (the lookup's reads). G2, for the
// cotangents (cgp, cgx) of the first backward's (dparams, dx): d/d(dL_dy)[b,
// l] = sum_c w_c cgp[idx_c] + a_c T[idx_c] with a_c = sum_e cgx_e dw_c/dx_e
// (a gather); d/dx = sum_c dw_c/dx <dL_dy, cgp[idx_c]> + (cgx^T Hess w_c)
// <dL_dy, T[idx_c]> (the cross second derivatives of the d-linear weight
// are not zero); d/dparams += round(a_c * dL_dy[b, l]) at idx_c with the
// level's class (the same scatter as the table gradient). Every term is
// exact, as jax.grad of jax.grad is in the JAX package.
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
// which the fp32 and bf16 tolerances of the tests allow.
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
//
// G1 and G2 read B * L * 2^d random table rows (32.5 M 8-byte rows at the
// 3D model, B = 2^18, in a 52 MB table that does not fit the L2), and G2
// adds as many rows into the table gradient. The earlier kernels (one
// thread per sample walking every level and corner in order, loops
// unrolled to kMaxDims with run-time guards, a kMaxDims^3 Hessian loop a
// corner, 115 and 158 registers, one scalar atomic a contribution; deleted
// since) took 0.8447 and 4.3971 ms there, and kept 88% (G1) and 91% (G2
// without its table scatter) of it with every corner reading one row:
// arithmetic and latency, not the rows, set them; G2's scalar atomics took
// 2.02 ms more (benchmarks/grid_second_order_times.py, NVIDIA H100 80GB
// HBM3, 700 W).
//
// Design (G1, G2): level-major tiles, as the lookup: a block owns 32
// samples, warp w takes levels w, w + 8, ...; d (2, 3) and F are compile-
// time constants, so every corner's row and weight is computed first and
// all row loads issued before any is used, the weight derivatives take
// d^2 products of d factors a corner (27 at d = 3), and x and cgx are read
// once a lane. d/dx sums in registers a warp and in warp order over the
// block: deterministic, no atomics. G2 stages its d/d(dL_dy) rows in shared
// memory and writes them whole, and scatters its table gradient as the
// table gradient kernel does (merged runs, one vector atomic a row). No
// level is privatised: a block's 32 samples leave nothing to amortise a
// private copy over. Measured at the 3D model (same tool and card; ms, new
// / earlier kernel in one call): G1 0.2598 / 0.8434 (the lookup over the
// same rows 0.2616), G2 with cgx 1.0898 / 4.3963 (without its scatter
// 0.3760), with cgx and cgp 1.6315 / 4.6378.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

using namespace tcnn_grid;

namespace {

// Contribution rounding and accumulation codes:
// tcnn_tpu_torch/ops/scatter_rows.py CONTRIB_* and ACC_*.
enum { kContribNone = 0, kContribRN = 1, kContribSR = 2 };
enum { kAccF32 = 0, kAccBf16 = 1, kAccDrop = 2 };

__device__ __forceinline__ uint32_t sr_round_bits(uint32_t bits) {
  uint32_t h = bits * 0x9E3779B9u;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  return (bits + (h >> 16)) & 0xFFFF0000u;
}

__device__ __forceinline__ float round_contribution(float v, int mode) {
  if (mode == kContribRN) return __bfloat162float(__float2bfloat16_rn(v));
  if (mode == kContribSR) return __uint_as_float(sr_round_bits(__float_as_uint(v)));
  return v;
}

__device__ __forceinline__ void accumulate(float* out32, __nv_bfloat16* out16, int64_t i, float v,
                                           int acc) {
  if (v == 0.0f) return;  // +-0 adds nothing
  if (acc == kAccBf16) {
    atomicAdd(out16 + i, __float2bfloat16_rn(v));
  } else {
    atomicAdd(out32 + i, v);
  }
}

// The table gradient (tcnn_grid_backward): level-major tiles. A block owns
// `chunk` consecutive samples and takes them `threads` at a time; for each
// tile it walks the levels in order with one sample per thread, so a warp's
// 32 lanes are 32 consecutive samples on one level.
constexpr int kMaxLevels = 128;  // tcnn_tpu_torch/common.py MAX_N_LEVELS
constexpr int kMaxThreads = 256;
constexpr int kPlanHeader = 4;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kNoRow = 0xFFFFFFFFu;  // a lane without a sample

// The host's plan (ops/grid_encode.py:backward_plan), by value. Offsets are
// bytes into the dynamic shared memory.
struct Plan {
  int threads, chunk, levels_offset, smem_bytes;
  int priv_offset[kMaxLevels];  // the level's private copy, or -1
};

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sums the contributions of lanes whose rows are equal and whose lanes are
// neighbours (a run), in fp32 or, with `half`, rounding every add to bf16.
// Returns whether this lane holds its run's sum (the run's first lane).
// Warp-uniform: every lane calls it with the same `half`.
template <int F>
__device__ __forceinline__ bool merge_runs(uint32_t key, float (&v)[F], bool half) {
  const int lane = threadIdx.x & 31;
  const uint32_t prev = __shfl_up_sync(kFullMask, key, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || prev != key);
  if (heads == kFullMask) return true;  // no two neighbours share a row
  const unsigned later = heads & ~((2u << lane) - 1u);
  const int run_end = later ? __ffs(later) - 2 : 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float o = __shfl_down_sync(kFullMask, v[f], off);
      if (lane + off <= run_end) v[f] = half ? bf16_round(v[f] + o) : v[f] + o;
    }
  }
  return (heads >> lane) & 1u;
}

// Adds one row of F fp32 values at p: float4 / float2 vector atomics where F
// allows (global memory, compute capability 9.x), else scalar atomics.
template <int F>
__device__ __forceinline__ void add_row_f32_global(float* p, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int k = 0; k < F / 4; ++k)
      atomicAdd(reinterpret_cast<float4*>(p) + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int k = 0; k < F / 2; ++k) atomicAdd(reinterpret_cast<float2*>(p) + k, make_float2(v[2 * k], v[2 * k + 1]));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (v[f] != 0.0f) atomicAdd(p + f, v[f]);
  }
}

template <int F>
__device__ __forceinline__ void add_row_f32_shared(float* p, const float (&v)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f)
    if (v[f] != 0.0f) atomicAdd(p + f, v[f]);
}

// Adds one row of F bf16 values (each v[f] already a bf16 value) at p, in
// global or shared memory: bf16x2 atomics where F is even.
template <int F>
__device__ __forceinline__ void add_row_bf16(__nv_bfloat16* p, const float (&v)[F]) {
  if constexpr (F % 2 == 0) {
#pragma unroll
    for (int k = 0; k < F / 2; ++k)
      atomicAdd(reinterpret_cast<__nv_bfloat162*>(p) + k, __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (v[f] != 0.0f) atomicAdd(p + f, __float2bfloat16_rn(v[f]));
  }
}

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

// x: fp32 positions, or the uint32 ones of fixed_point_pos (`fixed`). u:
// null, or stochastic interpolation's (batch, n_levels) uniforms: per
// (sample, level) one corner, sampled_corner(), takes the whole dL_dy row
// with weight 1 (tcnn_tpu/encodings/grid.py:_stochastic_combine), so the
// corner loop runs once; the merges, private copies and atomics are the
// same. kExtras: the instantiation for those and for Rng levels; without
// it their code is left out, which keeps the common launch at its register
// count and occupancy (with it always compiled in, 72 registers instead of
// 63 gave 3 blocks an SM instead of 4, and the flagship's table gradient
// took 0.32 ms instead of 0.19: PERF.md).
template <typename DyT, int F, bool kExtras>
__global__ void __launch_bounds__(kMaxThreads, 2)
    grid_backward_kernel(const void* __restrict__ x, const DyT* __restrict__ dy, const Level* __restrict__ levels,
                         const int* __restrict__ classes, const float* __restrict__ u, float* __restrict__ grad32,
                         __nv_bfloat16* __restrict__ grad16, int batch, int n_dims, int n_levels, int dy_width,
                         int interp, int fixed, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  Level* s_levels = reinterpret_cast<Level*>(smem + plan.levels_offset);
  int* s_classes = reinterpret_cast<int*>(s_levels + n_levels);
  const int tid = threadIdx.x, T = blockDim.x;
  {
    const int* src = reinterpret_cast<const int*>(levels);
    int* dst = reinterpret_cast<int*>(s_levels);
    for (int i = tid; i < n_levels * (int)(sizeof(Level) / 4); i += T) dst[i] = __ldg(src + i);
    for (int i = tid; i < 2 * n_levels; i += T) s_classes[i] = __ldg(classes + i);
    uint4* priv = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < plan.levels_offset / 16; i += T) priv[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int64_t start = (int64_t)blockIdx.x * plan.chunk;
  const int64_t end = start + plan.chunk < batch ? start + plan.chunk : (int64_t)batch;
  const bool sampled_path = kExtras && u != nullptr;
  const int n_corners = sampled_path ? 1 : interp == kNearest ? 1 : 1 << n_dims;
  for (int64_t t0 = start; t0 < end; t0 += T) {
    const int64_t b = t0 + tid;
    const bool valid = b < end;
    for (int lvl = 0; lvl < n_levels; ++lvl) {
      const int acc = s_classes[2 * lvl + 1];
      if (acc == kAccDrop) continue;
      const int contrib = s_classes[2 * lvl];
      const bool half = acc == kAccBf16;
      const Level& lv = s_levels[lvl];
      const int priv = plan.priv_offset[lvl];
      Cell cell;
      float g[F];
      int sampled = 0;
      if (valid) {
        if constexpr (kExtras) {
          cell = fixed ? locate(static_cast<const uint32_t*>(x) + b * n_dims, lv, n_dims, interp)
                       : locate(static_cast<const float*>(x) + b * n_dims, lv, n_dims, interp);
          if (sampled_path) sampled = sampled_corner(cell, n_dims, __ldg(u + b * n_levels + lvl));
        } else {
          cell = locate(static_cast<const float*>(x) + b * n_dims, lv, n_dims, interp);
        }
#pragma unroll
        for (int f = 0; f < F; ++f)
          g[f] = as_float(__ldg(dy + b * dy_width + lvl * F + f));
      }
      for (int c = 0; c < n_corners; ++c) {
        uint32_t key = kNoRow;
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.0f;
        if (valid) {
          float weight;
          key = corner<kExtras>(cell, lv, n_dims, interp, sampled_path ? sampled : c, &weight);
          if (sampled_path) weight = 1.0f;
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float t = round_contribution(__fmul_rn(weight, g[f]), contrib);
            v[f] = half ? bf16_round(t) : t;
          }
        }
        if (!merge_runs<F>(key, v, half) || key == kNoRow) continue;
        bool any = false;
#pragma unroll
        for (int f = 0; f < F; ++f) any |= v[f] != 0.0f;
        if (!any) continue;  // +-0 adds nothing
        if (priv >= 0) {
          if (half) {
            add_row_bf16<F>(reinterpret_cast<__nv_bfloat16*>(smem + priv) + (int64_t)key * F, v);
          } else {
            add_row_f32_shared<F>(reinterpret_cast<float*>(smem + priv) + (int64_t)key * F, v);
          }
        } else {
          const int64_t row = ((int64_t)lv.offset + key) * F;
          if (half) {
            add_row_bf16<F>(grad16 + row, v);
          } else {
            add_row_f32_global<F>(grad32 + row, v);
          }
        }
      }
    }
  }
  __syncthreads();

  // Flush each privatised level's non-zero rows with one add each.
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int priv = plan.priv_offset[lvl];
    if (priv < 0) continue;
    const Level& lv = s_levels[lvl];
    const bool half = s_classes[2 * lvl + 1] == kAccBf16;
    for (uint32_t r = tid; r < lv.size; r += T) {
      float v[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[f] = half ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(smem + priv)[(int64_t)r * F + f])
                    : reinterpret_cast<const float*>(smem + priv)[(int64_t)r * F + f];
        any |= v[f] != 0.0f;
      }
      if (!any) continue;
      const int64_t row = ((int64_t)lv.offset + r) * F;
      if (half) {
        add_row_bf16<F>(grad16 + row, v);
      } else {
        add_row_f32_global<F>(grad32 + row, v);
      }
    }
  }
}

template <typename DyT, int F>
cudaError_t launch_tiled(unsigned blocks, const Plan& plan, cudaStream_t s, const void* x, const DyT* dy,
                         const Level* levels, const int* classes, const float* u, float* grad32,
                         __nv_bfloat16* grad16, int batch, int n_dims, int n_levels, int dy_width, int interp,
                         int fixed, int rng_levels) {
  // Above 48 KB a block's dynamic shared memory must be allowed first. The
  // attribute holds for the current device only, so every such launch sets it.
  const bool extras = fixed || u != nullptr || rng_levels;
  auto kernel = extras ? grid_backward_kernel<DyT, F, true> : grid_backward_kernel<DyT, F, false>;
  if (plan.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, plan.threads, plan.smem_bytes, s>>>(x, dy, levels, classes, u, grad32, grad16, batch, n_dims,
                                                       n_levels, dy_width, interp, fixed, plan);
  return cudaGetLastError();
}

template <typename DyT>
cudaError_t launch_by_features(int F, unsigned blocks, const Plan& plan, cudaStream_t s, const void* x, const DyT* dy,
                               const Level* levels, const int* classes, const float* u, float* grad32,
                               __nv_bfloat16* grad16, int batch, int n_dims, int n_levels, int dy_width, int interp,
                               int fixed, int rng_levels) {
#define TCNN_GRID_BWD_CASE(NF)                                                                                  \
  case NF:                                                                                                      \
    return launch_tiled<DyT, NF>(blocks, plan, s, x, dy, levels, classes, u, grad32, grad16, batch, n_dims,      \
                                 n_levels, dy_width, interp, fixed, rng_levels);
  switch (F) {
    TCNN_GRID_BWD_CASE(1)
    TCNN_GRID_BWD_CASE(2)
    TCNN_GRID_BWD_CASE(3)
    TCNN_GRID_BWD_CASE(4)
    TCNN_GRID_BWD_CASE(5)
    TCNN_GRID_BWD_CASE(6)
    TCNN_GRID_BWD_CASE(7)
    TCNN_GRID_BWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef TCNN_GRID_BWD_CASE
}

// G1 and G2: level-major tiles, as the lookup (grid_fwd.cu). A block of
// kWarps warps owns kTile = 32 consecutive samples, one a lane; warp w takes
// levels w, w + kWarps, ..., so a warp's lanes are 32 samples on one level
// and the level table sits in shared memory. A lane reads its sample's x
// (and cgx) once. With the dims at compile time (D = 2, 3) every corner's
// row is computed first and all its row loads (T, and cgp for G2) are
// issued before any is used. Each warp sums its levels' d/dx terms in
// registers, leaves them in shared memory, and the block adds the kWarps
// partials in warp order and writes the tile's d/dx rows whole: one fixed
// order, no atomics. G2 stages its d/d(dL_dy) rows in shared memory (a
// padded row a sample, padding columns zero) and writes them whole, and
// adds its table gradient as the table gradient kernel does: lanes on
// equal rows merged first (merge_runs), then one vector atomic a row.
constexpr int kTile = 32;
constexpr int kWarps = 8;

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
template <typename DyT, int F, int D>
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
        if (c < n_corners) row[c] = lv.offset + corner(cell, lv, D, interp, c, &w);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) load_row<F>(params, row[c], aligned, lv, t[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) input_corner<F, K>(cell, d1, d2, c, dims, g, t[c], acc);
      }
    } else {
      for (int c = 0; c < n_corners; ++c) {
        float w, t[F];
        load_row<F>(params, lv.offset + corner(cell, lv, dims, interp, c, &w), aligned, lv, t);
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
template <typename DyT, int F, int D>
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
        if (c < n_corners) row[c] = lv.offset + corner(cell, lv, D, interp, c, &w[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n_corners) {
          load_row<F>(params, row[c], aligned, lv, t[c]);
          if (use_cgp) load_row_raw<F>(cgp, row[c], aligned, p[c]);
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
        const uint32_t row = lv.offset + corner(cell, lv, dims, interp, c, &w);
        load_row<F>(params, row, aligned, lv, t);
        if (use_cgp) load_row_raw<F>(cgp, row, aligned, p);
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
struct InputLaunch {
  template <typename DyT, int F, int D>
  static cudaError_t run(unsigned blocks, size_t smem, cudaStream_t s, const float* x, const DyT* dy,
                         const float* params, const Level* lv, float* dx, int batch, int n_dims, int n_levels,
                         int dy_width, int interp, int aligned) {
    const cudaError_t err = allow_smem(grid_backward_input_kernel<DyT, F, D>, smem);
    if (err != cudaSuccess) return err;
    grid_backward_input_kernel<DyT, F, D><<<blocks, kWarps * 32, smem, s>>>(x, dy, params, lv, dx, batch, n_dims,
                                                                            n_levels, dy_width, interp, aligned);
    return cudaGetLastError();
  }
};

struct SecondOrderLaunch {
  template <typename DyT, int F, int D>
  static cudaError_t run(unsigned blocks, size_t smem, cudaStream_t s, const float* x, const DyT* dy,
                         const float* params, const float* cgp, const float* cgx, const Level* lv, const int* cls,
                         float* g32, __nv_bfloat16* g16, float* ox, float* ody, int batch, int n_dims, int n_levels,
                         int dy_width, int interp, int aligned, int row_stride) {
    const cudaError_t err = allow_smem(grid_backward_backward_kernel<DyT, F, D>, smem);
    if (err != cudaSuccess) return err;
    grid_backward_backward_kernel<DyT, F, D><<<blocks, kWarps * 32, smem, s>>>(
        x, dy, params, cgp, cgx, lv, cls, g32, g16, ox, ody, batch, n_dims, n_levels, dy_width, interp, aligned,
        row_stride);
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

// Bytes of G1's (rows 0) and G2's shared memory.
size_t second_order_smem(int n_levels, int n_dims, int row_stride) {
  return n_levels * (sizeof(Level) + 8) + (size_t)kWarps * n_dims * kTile * 4 + (size_t)kTile * row_stride * 4;
}

// Copies the bf16 sums into the fp32 output. An entry takes adds in one of
// the two buffers only (its level's class picks which), so a non-zero bf16
// sum lands on an fp32 zero and is stored, not added: the fp32 output is not
// read.
__global__ void fold_bf16_kernel(float* __restrict__ out32, const __nv_bfloat16* __restrict__ in16,
                                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float v = __bfloat162float(in16[i]);
    if (v != 0.0f) out32[i] = v;
  }
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

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
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF || n_levels < 1 || n_levels > kMaxLevels ||
      plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int* ph = static_cast<const int*>(plan);
  Plan p;
  p.threads = ph[0];
  p.chunk = ph[1];
  p.levels_offset = ph[2];
  p.smem_bytes = ph[3];
  for (int l = 0; l < kMaxLevels; ++l) p.priv_offset[l] = l < n_levels ? ph[kPlanHeader + l] : -1;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 || p.chunk < p.threads || p.chunk % p.threads ||
      p.levels_offset % 16 || p.smem_bytes < p.levels_offset + n_levels * (int)(sizeof(Level) + 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(grad32, 0, n_values * 4, s);
  if (err == cudaSuccess && grad16 != nullptr) err = cudaMemsetAsync(grad16, 0, n_values * 2, s);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const unsigned blocks = (unsigned)(((int64_t)batch + p.chunk - 1) / p.chunk);
    const Level* lv = static_cast<const Level*>(levels);
    const int* cls = static_cast<const int*>(classes);
    const float* uf = static_cast<const float*>(u);
    float* g32 = static_cast<float*>(grad32);
    __nv_bfloat16* g16 = static_cast<__nv_bfloat16*>(grad16);
    err = dy_bf16 ? launch_by_features(F, blocks, p, s, x, static_cast<const __nv_bfloat16*>(dy), lv, cls, uf, g32,
                                       g16, batch, n_dims, n_levels, dy_width, interp, fixed_point, rng_levels)
                  : launch_by_features(F, blocks, p, s, x, static_cast<const float*>(dy), lv, cls, uf, g32, g16,
                                       batch, n_dims, n_levels, dy_width, interp, fixed_point, rng_levels);
    if (err != cudaSuccess) return (int)err;
  }
  if (grad16 != nullptr) {
    fold_bf16_kernel<<<blocks_for(n_values), kThreads, 0, s>>>(
        static_cast<float*>(grad32), static_cast<const __nv_bfloat16*>(grad16), n_values);
  }
  return (int)cudaGetLastError();
}

// dx (batch, n_dims) fp32: the input gradient of the lookup for output
// gradient dy (batch, dy_width), bf16 when dy_bf16 else fp32; the table
// `params` is read rounded as the level table says, as the lookup reads it.
extern "C" int tcnn_grid_backward_input(const void* x, const void* dy, const void* params,
                                        const void* levels, void* dx, int batch, int n_dims,
                                        int n_levels, int F, int dy_width, int interp,
                                        int dy_bf16, void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF || n_levels < 1 || n_levels > kMaxLevels ||
      dy_width < n_levels * F)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const unsigned blocks = (unsigned)((batch + kTile - 1) / kTile);
  const size_t smem = second_order_smem(n_levels, n_dims, 0);
  const int aligned = reinterpret_cast<uintptr_t>(params) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* pf = static_cast<const float*>(params);
  const Level* lv = static_cast<const Level*>(levels);
  float* out = static_cast<float*>(dx);
  return (int)(dy_bf16 ? dispatch<InputLaunch, __nv_bfloat16>(F, n_dims, blocks, smem, s, xf,
                                                              static_cast<const __nv_bfloat16*>(dy), pf, lv, out,
                                                              batch, n_dims, n_levels, dy_width, interp, aligned)
                       : dispatch<InputLaunch, float>(F, n_dims, blocks, smem, s, xf, static_cast<const float*>(dy),
                                                      pf, lv, out, batch, n_dims, n_levels, dy_width, interp,
                                                      aligned));
}

// The double backward of the lookup for the cotangents cgp (n_values,) and
// cgx (batch, n_dims) fp32 of the first backward's (dparams, dx), either
// null for zero: d_x (batch, n_dims) and d_dy (batch, dy_width) fp32, and,
// when grad32 is not null, the table gradient grad32 (n_values,) fp32 with
// the classes' rounding (grad16: bf16 scratch as for tcnn_grid_backward).
// `classes` (null: no level drops) is the (n_levels, 2) class table.
extern "C" int tcnn_grid_backward_backward(const void* x, const void* dy, const void* params,
                                           const void* cgp, const void* cgx, const void* levels,
                                           const void* classes, void* grad32, void* grad16,
                                           void* d_x, void* d_dy, int batch, int n_dims,
                                           int n_levels, int F, int dy_width, int interp,
                                           int dy_bf16, int64_t n_values,
                                           void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF || n_levels < 1 || n_levels > kMaxLevels ||
      dy_width < n_levels * F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (grad32 != nullptr) err = cudaMemsetAsync(grad32, 0, n_values * 4, s);
  if (err == cudaSuccess && grad16 != nullptr) err = cudaMemsetAsync(grad16, 0, n_values * 2, s);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const unsigned blocks = (unsigned)((batch + kTile - 1) / kTile);
    const int row_stride = dy_width | 1;
    const size_t smem = second_order_smem(n_levels, n_dims, row_stride);
    const int aligned = reinterpret_cast<uintptr_t>(params) % 16 == 0 && reinterpret_cast<uintptr_t>(cgp) % 16 == 0;
    const float* xf = static_cast<const float*>(x);
    const float* pf = static_cast<const float*>(params);
    const float* cp = static_cast<const float*>(cgp);
    const float* cx = static_cast<const float*>(cgx);
    const Level* lv = static_cast<const Level*>(levels);
    const int* cls = static_cast<const int*>(classes);
    float* g32 = static_cast<float*>(grad32);
    __nv_bfloat16* g16 = static_cast<__nv_bfloat16*>(grad16);
    float* ox = static_cast<float*>(d_x);
    float* ody = static_cast<float*>(d_dy);
    err = dy_bf16 ? dispatch<SecondOrderLaunch, __nv_bfloat16>(
                        F, n_dims, blocks, smem, s, xf, static_cast<const __nv_bfloat16*>(dy), pf, cp, cx, lv, cls,
                        g32, g16, ox, ody, batch, n_dims, n_levels, dy_width, interp, aligned, row_stride)
                  : dispatch<SecondOrderLaunch, float>(F, n_dims, blocks, smem, s, xf, static_cast<const float*>(dy),
                                                       pf, cp, cx, lv, cls, g32, g16, ox, ody, batch, n_dims,
                                                       n_levels, dy_width, interp, aligned, row_stride);
    if (err != cudaSuccess) return (int)err;
  }
  if (grad32 != nullptr && grad16 != nullptr) {
    fold_bf16_kernel<<<blocks_for(n_values), kThreads, 0, s>>>(
        static_cast<float*>(grad32), static_cast<const __nv_bfloat16*>(grad16), n_values);
  }
  return (int)cudaGetLastError();
}

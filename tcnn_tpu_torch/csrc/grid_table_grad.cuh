// The grid's table gradient (tcnn_grid_backward), shared by grid_bwd.cu
// (the common and the extras' instantiations, and the row scatter, which
// uses its helpers, as G1 and G2 do: grid_input_grad.cuh), grid_bwd_rng.cu (the instantiations for
// tables with Rng levels) and grid_bwd_modes.cu (those for uint32 positions
// and for a sampled corner), the last two with the dims at compile time and
// each built as a library of its own so that grid_bwd.cu's build does not
// grow. What it computes, what bounds it and its design: the head of
// grid_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_common.cuh"

namespace tcnn_grid {

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

// The table gradient (tcnn_grid_backward): level-major tiles. A block owns
// `chunk` consecutive samples and takes them `threads` at a time; for each
// tile it walks the levels in order with one sample per thread, so a warp's
// 32 lanes are 32 consecutive samples on one level.
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

// x: fp32 positions, or the uint32 ones of fixed_point_pos (`fixed`). u:
// null, or stochastic interpolation's (batch, n_levels) uniforms: per
// (sample, level) one corner, sampled_corner(), takes the whole dL_dy row
// with weight 1 (tcnn_tpu/encodings/grid.py:_stochastic_combine), so the
// corner loop runs once; the merges, private copies and atomics are the
// same. The instantiations:
// - D = 0, !kExtras (the common one): fp32 positions, no u, no Rng level,
//   n_dims at run time; none of the extras' code is compiled in, which
//   keeps it at its register count and occupancy (with the extras always
//   compiled in, 72 registers instead of 63 gave 3 blocks an SM instead of
//   4, and the flagship's table gradient took 0.32 ms instead of 0.19:
//   PERF.md);
// - D = 0, kExtras: uint32 positions, u and Rng levels (the per-corner
//   jump) as run-time branches, n_dims at run time: what no instantiation
//   below takes;
// - D > 0 (2, 3), the dims at compile time and the corner loop unrolled,
//   PosT the position type (float, or uint32_t under fixed_point_pos) and
//   kSampled whether u is read:
//   - fp32 positions, no u (grid_bwd_rng.cu): a table with Rng levels; an
//     Rng level's keys come a cell at once from rng_corners() before the
//     loop and stay in registers;
//   - uint32 positions, no u, no Rng level (grid_bwd_modes.cu);
//   - fp32 positions with u, no Rng level (grid_bwd_modes.cu): the corner
//     is sampled before the loop, which runs once; no per-corner state.
// kWindowed (grid_sharded.cu): a rank of a row-sharded table adds only the
// contributions to its own rows, those of each level's window (the
// Window array that follows the level table at `levels + n_levels`), at
// local row r - first; the others are dropped as a lane without a sample
// is, and the levels are flushed by their local row count. The other
// instantiations discard the windowed branches, so they compile the kernel
// as it was.
template <typename DyT, int F, bool kExtras, int D, typename PosT = float, bool kSampled = false,
          bool kWindowed = false>
__global__ void __launch_bounds__(kMaxThreads, 2)
    grid_backward_kernel(const void* __restrict__ x, const DyT* __restrict__ dy, const Level* __restrict__ levels,
                         const int* __restrict__ classes, const float* __restrict__ u, float* __restrict__ grad32,
                         __nv_bfloat16* __restrict__ grad16, int batch, int n_dims, int n_levels, int dy_width,
                         int interp, int fixed, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  Level* s_levels = reinterpret_cast<Level*>(smem + plan.levels_offset);
  int* s_classes = reinterpret_cast<int*>(s_levels + n_levels);
  constexpr bool kFixed = std::is_same<PosT, uint32_t>::value;
  constexpr bool kRngCells = D > 0 && !kFixed && !kSampled;  // an Rng level's keys a cell at once
  static_assert(D == 0 || !kExtras, "kExtras takes the dims at run time");
  static_assert(D > 0 || (!kFixed && !kSampled), "at run-time dims, kExtras takes uint32 positions and u");
  static_assert(kFixed || std::is_same<PosT, float>::value, "positions are fp32 or uint32");
  static_assert(!(kFixed && kSampled), "kExtras takes uint32 positions with u");
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
  const bool sampled_path = kSampled || (kExtras && u != nullptr);
  const int dims = D > 0 ? D : n_dims;
  const int n_corners = sampled_path ? 1 : interp == kNearest ? 1 : 1 << dims;
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
      uint32_t keys[kRngCells ? 1 << D : 1];  // kRngCells: an Rng level's keys
      if (valid) {
        if constexpr (kExtras) {
          cell = fixed ? locate(static_cast<const uint32_t*>(x) + b * n_dims, lv, n_dims, interp)
                       : locate(static_cast<const float*>(x) + b * n_dims, lv, n_dims, interp);
          if (sampled_path) sampled = sampled_corner(cell, n_dims, __ldg(u + b * n_levels + lvl));
        } else {
          cell = locate(static_cast<const PosT*>(x) + b * dims, lv, dims, interp);
          if constexpr (kSampled) sampled = sampled_corner(cell, D, __ldg(u + b * n_levels + lvl));
          if constexpr (kRngCells) {
            if (lv.mode == kRng) rng_corners<D>(cell, keys);
          }
        }
#pragma unroll
        for (int f = 0; f < F; ++f)
          g[f] = as_float(__ldg(dy + b * dy_width + lvl * F + f));
      }
      // Corner c's contributions, merged with equal rows of the warp first.
      auto add_corner = [&](int c) {
        uint32_t key = kNoRow;
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.0f;
        if (valid) {
          float weight;
          if constexpr (kRngCells) {
            key = corner_of<D>(cell, lv, interp, c, keys, &weight);
          } else {
            key = corner<kExtras>(cell, lv, dims, interp, sampled_path ? sampled : c, &weight);
          }
          if (sampled_path) weight = 1.0f;
          if constexpr (kWindowed) {
            const Window win = window_of(reinterpret_cast<const Window*>(levels + n_levels), lvl);
            key -= win.first;
            if (key >= win.rows) key = kNoRow;
          }
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float t = round_contribution(__fmul_rn(weight, g[f]), contrib);
            v[f] = half ? bf16_round(t) : t;
          }
        }
        if (!merge_runs<F>(key, v, half) || key == kNoRow) return;
        bool any = false;
#pragma unroll
        for (int f = 0; f < F; ++f) any |= v[f] != 0.0f;
        if (!any) return;  // +-0 adds nothing
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
      };
      if constexpr (D > 0) {
#pragma unroll
        for (int c = 0; c < (kSampled ? 1 : 1 << D); ++c) {
          if (c < n_corners) add_corner(c);
        }
      } else {
        for (int c = 0; c < n_corners; ++c) add_corner(c);
      }
    }
  }
  __syncthreads();
  if constexpr (kWindowed) {
    // Every corner is placed: a level's size is its window's rows now.
    for (int lvl = tid; lvl < n_levels; lvl += T)
      s_levels[lvl].size = window_of(reinterpret_cast<const Window*>(levels + n_levels), lvl).rows;
    __syncthreads();
  }

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

// One launch of grid_backward_kernel<DyT, F, kExtras, D, PosT, kSampled,
// kWindowed>.
template <typename DyT, int F, bool kExtras, int D, typename PosT = float, bool kSampled = false,
          bool kWindowed = false>
cudaError_t launch_tiled(unsigned blocks, const Plan& plan, cudaStream_t s, const void* x, const DyT* dy,
                         const Level* levels, const int* classes, const float* u, float* grad32,
                         __nv_bfloat16* grad16, int batch, int n_dims, int n_levels, int dy_width, int interp,
                         int fixed) {
  auto kernel = grid_backward_kernel<DyT, F, kExtras, D, PosT, kSampled, kWindowed>;
  // Above 48 KB a block's dynamic shared memory must be allowed first. The
  // attribute holds for the current device only, so every such launch sets it.
  if (plan.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, plan.threads, plan.smem_bytes, s>>>(x, dy, levels, classes, u, grad32, grad16, batch, n_dims,
                                                       n_levels, dy_width, interp, fixed, plan);
  return cudaGetLastError();
}

// Choose::run<DyT, F>(args...) with F (1-8) a compile-time constant; Choose
// picks the instantiation.
template <typename Choose, typename DyT, typename... Args>
cudaError_t launch_by_features(int F, const Args&... args) {
#define TCNN_GRID_BWD_CASE(NF) \
  case NF:                     \
    return Choose::template run<DyT, NF>(args...);
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

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// The table gradient's C entry point, Choose::run<DyT, F> picking the
// kernel's instantiation: the operands' checks, the zeroed outputs, the
// launch and the fold of the bf16 sums (the arguments: tcnn_grid_backward
// in grid_bwd.cu).
template <typename Choose>
int table_gradient(const void* x, const void* dy, const void* levels, const void* classes, const void* u,
                   void* grad32, void* grad16, int batch, int n_dims, int n_levels, int F, int dy_width,
                   int interp, int dy_bf16, int fixed_point, int rng_levels, int64_t n_values,
                   const void* plan, void* stream) {
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
    err = dy_bf16 ? launch_by_features<Choose, __nv_bfloat16>(F, blocks, p, s, x,
                                                              static_cast<const __nv_bfloat16*>(dy), lv, cls, uf,
                                                              g32, g16, batch, n_dims, n_levels, dy_width, interp,
                                                              fixed_point, rng_levels)
                  : launch_by_features<Choose, float>(F, blocks, p, s, x, static_cast<const float*>(dy), lv, cls,
                                                      uf, g32, g16, batch, n_dims, n_levels, dy_width, interp,
                                                      fixed_point, rng_levels);
    if (err != cudaSuccess) return (int)err;
  }
  if (grad16 != nullptr) {
    fold_bf16_kernel<<<blocks_for(n_values), kThreads, 0, s>>>(
        static_cast<float*>(grad32), static_cast<const __nv_bfloat16*>(grad16), n_values);
  }
  return (int)cudaGetLastError();
}

}  // namespace tcnn_grid

// Row scatter-add with per-contribution rounding, and the grid encoding's
// table gradient built on it, for Hopper (sm_90a).
//
// Replaces: the Pallas scatters of tcnn_tpu/ops/scatter_rows.py --
// scatter_rows_factored_pallas (:259, body _factored_kernel :204; pair,
// single and stochastic rounding), scatter_rows_onehot (:68; bf16 operands,
// fp32 sums) and scatter_rows_serial (:133; fp32) -- which the JAX package
// uses as the transpose of the grid lookup (encodings/grid.py, via
// ops/scatter_rows.py:_factored_scatter_of :514) next to XLA's scatter-add
// emitter in fp32 or bf16. On this card the sum is what the reference does
// (encodings/grid.h atomics): every contribution is added atomically.
//
// What it computes: out[idx[n], :] += round(rows[n, :]) (tcnn_scatter_rows),
// and for the grid (tcnn_grid_backward) one thread per (sample, level)
// recomputes the level's corner indices and weights exactly as grid_fwd.cu
// (grid_common.cuh) and adds round(w_c * dL_dy[b, lvl*F + f]) to table row
// offset + idx_c, feature f. round() is the contribution class of the level:
// none, round-to-nearest bf16, or value-hashed stochastic bf16
// (tcnn_tpu/ops/scatter_rows.py:_sr_round_bits :187). The sum is fp32
// atomics into an fp32 buffer, or bf16 atomics into a bf16 buffer for the
// half classes (each add rounds to bf16), folded into the fp32 result at the
// end; a level of class "drop" adds nothing. Zero contributions are skipped,
// so an entry no sample touched stays an exact +0 (the optimizer's
// skip-zero-gradient test reads that). Nothing of size (B * L * 2^d, F) is
// materialised.
//
// What bounds it on this card: at the flagship (B = 2^18, 16 levels x 4
// corners x 2 features) 33.5 M atomic adds into a 2.8 MB table that stays in
// the 50 MB L2: the L2 atomic throughput and the collisions on the coarse
// levels' few rows bound it, not HBM (~3 MB of inputs). The order of the
// atomics varies from run to run, so fp32 sums differ from a sequential sum
// in their last bits.
//
// Design: one thread per (sample, level), level fastest as in the lookup;
// each thread adds its 2^d * F contributions with scalar atomicAdd. Warp-
// level pre-reduction of colliding rows and vector (bf16x2) atomics are
// later work.

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

__global__ void scatter_rows_kernel(const int* __restrict__ idx, const float* __restrict__ rows,
                                    float* __restrict__ out32, __nv_bfloat16* __restrict__ out16,
                                    int64_t n, int r_width, int64_t size, int contrib, int acc) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n * r_width) return;
  const int64_t row = tid / r_width;
  const int col = (int)(tid % r_width);
  const int target = __ldg(idx + row);
  if (target < 0 || target >= size) return;  // outside the table: no row to add to
  accumulate(out32, out16, (int64_t)target * r_width + col,
             round_contribution(__ldg(rows + tid), contrib), acc);
}

template <typename DyT>
__global__ void grid_backward_kernel(const float* __restrict__ x, const DyT* __restrict__ dy,
                                     const Level* __restrict__ levels,
                                     const int* __restrict__ classes, float* __restrict__ grad32,
                                     __nv_bfloat16* __restrict__ grad16, int batch, int n_dims,
                                     int n_levels, int F, int dy_width, int interp) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)batch * n_levels) return;
  const int64_t b = tid / n_levels;
  const int lvl = (int)(tid % n_levels);
  const int contrib = __ldg(classes + 2 * lvl);
  const int acc = __ldg(classes + 2 * lvl + 1);
  if (acc == kAccDrop) return;
  const Level lv = levels[lvl];
  const Cell cell = locate(x + b * n_dims, lv, n_dims, interp);

  float g[kMaxF];
  const DyT* grow = dy + b * dy_width + lvl * F;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) g[f] = f < F ? (float)grow[f] : 0.0f;

  const int n_corners = interp == kNearest ? 1 : 1 << n_dims;
  for (int c = 0; c < n_corners; ++c) {
    float weight;
    const uint32_t idx = corner(cell, lv, n_dims, interp, c, &weight);
    const int64_t row = ((int64_t)lv.offset + idx) * F;
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) {
      if (f < F) accumulate(grad32, grad16, row + f, round_contribution(__fmul_rn(weight, g[f]), contrib), acc);
    }
  }
}

__global__ void fold_bf16_kernel(float* __restrict__ out32, const __nv_bfloat16* __restrict__ in16,
                                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float v = __bfloat162float(in16[i]);
    if (v != 0.0f) out32[i] += v;
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

// out (size, r_width) fp32 = sum over n of round(rows[n]) at row idx[n].
extern "C" int tcnn_scatter_rows(const void* idx, const void* rows, void* out32, void* out16,
                                 int64_t n, int r_width, int64_t size, int contrib, int acc,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = size * r_width;
  if (acc == kAccBf16 && out16 == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out32, 0, n_out * 4, s);
  if (err == cudaSuccess && acc == kAccBf16) err = cudaMemsetAsync(out16, 0, n_out * 2, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && acc != kAccDrop) {
    scatter_rows_kernel<<<blocks_for(n * r_width), kThreads, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(rows), static_cast<float*>(out32),
        static_cast<__nv_bfloat16*>(out16), n, r_width, size, contrib, acc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (acc == kAccBf16) {
    fold_bf16_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
        static_cast<float*>(out32), static_cast<const __nv_bfloat16*>(out16), n_out);
  }
  return (int)cudaGetLastError();
}

// grad32 (n_values,) fp32: the table gradient of the flat grid parameters
// for output gradient dy (batch, dy_width), bf16 when dy_bf16 else fp32.
// `classes` is the device copy of the (n_levels, 2) int32 table of
// (contribution rounding, accumulation) codes.
extern "C" int tcnn_grid_backward(const void* x, const void* dy, const void* levels,
                                  const void* classes, void* grad32, void* grad16, int batch,
                                  int n_dims, int n_levels, int F, int dy_width, int interp,
                                  int dy_bf16, int64_t n_values, void* stream) {
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(grad32, 0, n_values * 4, s);
  if (err == cudaSuccess && grad16 != nullptr) err = cudaMemsetAsync(grad16, 0, n_values * 2, s);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const unsigned blocks = blocks_for((int64_t)batch * n_levels);
    const float* xf = static_cast<const float*>(x);
    const Level* lv = static_cast<const Level*>(levels);
    const int* cls = static_cast<const int*>(classes);
    float* g32 = static_cast<float*>(grad32);
    __nv_bfloat16* g16 = static_cast<__nv_bfloat16*>(grad16);
    if (dy_bf16) {
      grid_backward_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          xf, static_cast<const __nv_bfloat16*>(dy), lv, cls, g32, g16, batch, n_dims, n_levels, F,
          dy_width, interp);
    } else {
      grid_backward_kernel<float><<<blocks, kThreads, 0, s>>>(
          xf, static_cast<const float*>(dy), lv, cls, g32, g16, batch, n_dims, n_levels, F, dy_width,
          interp);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (grad16 != nullptr) {
    fold_bf16_kernel<<<blocks_for(n_values), kThreads, 0, s>>>(
        static_cast<float*>(grad32), static_cast<const __nv_bfloat16*>(grad16), n_values);
  }
  return (int)cudaGetLastError();
}

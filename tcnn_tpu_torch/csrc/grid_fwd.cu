// Multiresolution grid lookup and interpolation, all levels in one launch,
// for Hopper (sm_90a).
//
// Replaces: the grid lookup of tcnn_tpu/encodings/grid.py
// (GridEncoding.apply :1354, per-sample branch :1645-1755 and :1829-2024),
// which the JAX package composes from XLA gathers (it is not a Pallas
// kernel); the reference's kernel_grid (encodings/grid.h) does the same job.
//
// What it computes, per (sample, level): the cell and the 2^d corner
// indices and weights of grid_common.cuh; the features read as fp32 from the
// flat parameters, rounded on read to fp16 or bf16 where the level table
// says so (the encoding's own table dtype, then the level's serve-time
// one); and the weighted sum in fp32, in corner order 0..2^d-1, with every
// product and sum rounded separately as in the plain version. Output column
// lvl*F + f; padding columns are written as zeros.
//
// What bounds it on this card: the flagship table is 708,592 fp32 values
// (2.8 MB), resident in the 50 MB L2, so the kernel is bound by random L2
// reads (one 32-byte sector per corner: 2^18 x 16 levels x 4 corners = 67 M
// sectors, 2.1 GB, per flagship call at B = 2^18) and their latency, not by
// HBM bandwidth (~22 MB of inputs and outputs) and not by arithmetic.
//
// Design: one thread per (sample, level), level fastest, so a warp shares a
// couple of samples' coordinates and writes one contiguous output run; the
// per-level constants are one 104-byte struct read through the cache. Enough
// threads are in flight (B x L) to hide the L2 latency. Corner-shared loads
// (one row per cell for affine levels) are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_common.cuh"

using namespace tcnn_grid;

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename OutT>
__global__ void grid_forward_kernel(const float* __restrict__ x, const float* __restrict__ params,
                                    const Level* __restrict__ levels, OutT* __restrict__ out,
                                    int batch, int n_dims, int n_levels, int F, int out_width,
                                    int interp) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)batch * n_levels) return;
  const int64_t b = tid / n_levels;
  const int lvl = (int)(tid % n_levels);
  const Level lv = levels[lvl];
  const Cell cell = locate(x + b * n_dims, lv, n_dims, interp);

  float acc[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) acc[f] = 0.0f;

  const int n_corners = interp == kNearest ? 1 : 1 << n_dims;
  for (int c = 0; c < n_corners; ++c) {
    float weight;
    const uint32_t idx = corner(cell, lv, n_dims, interp, c, &weight);
    const float* row = params + ((uint64_t)lv.offset + idx) * F;
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) {
      if (f < F) acc[f] = __fadd_rn(acc[f], __fmul_rn(weight, read_rounded(row + f, lv)));
    }
  }

  OutT* orow = out + b * out_width;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) {
    if (f < F) store(orow + lvl * F + f, acc[f]);
  }
  if (lvl == 0) {
    for (int col = n_levels * F; col < out_width; ++col) store(orow + col, 0.0f);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. `levels` points to the device copy of
// the (n_levels, 26) int32 level table.
extern "C" int tcnn_grid_forward(const void* x, const void* params, const void* levels, void* out,
                                 int batch, int n_dims, int n_levels, int F, int out_width,
                                 int interp, int out_bf16, void* stream) {
  if (batch <= 0) return 0;
  if (n_dims < 1 || n_dims > kMaxDims || F < 1 || F > kMaxF) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t n = (int64_t)batch * n_levels;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* pf = static_cast<const float*>(params);
  const Level* lv = static_cast<const Level*>(levels);
  if (out_bf16) {
    grid_forward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        xf, pf, lv, static_cast<__nv_bfloat16*>(out), batch, n_dims, n_levels, F, out_width,
        interp);
  } else {
    grid_forward_kernel<float><<<blocks, threads, 0, s>>>(
        xf, pf, lv, static_cast<float*>(out), batch, n_dims, n_levels, F, out_width, interp);
  }
  return (int)cudaGetLastError();
}

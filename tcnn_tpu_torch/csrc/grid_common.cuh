// The grid encoding's level description and corner arithmetic, shared by
// the lookup (grid_fwd.cu) and its backward kernels (grid_bwd.cu), so that
// every backward recomputes exactly the corner indices and weights the
// forward used.
//
// Per (sample, level): pos = x * scale + 0.5 (two correctly rounded fp32
// operations: a fused multiply-add would move floor(pos) for points on
// cell boundaries), pos_grid = floor(pos), t = pos - pos_grid; the 2^d
// corner indices by the level's mode (affine fold, affine base + corner
// delta, XOR-prime hash or base-convert hash, all in wrapping uint32
// arithmetic, then mod the level size); the d-linear (or smoothstep, or
// nearest) weights, multiplied in dimension order.
//
// The input-gradient kernels also need the derivatives of the weights: the
// weight of corner c is prod_d f_cd with f_cd = w_d (upper neighbour in dim
// d) or 1 - w_d (lower), so d f_cd / d x_d = +-w_d'(x_d) and d^2 f_cd / d x_d^2
// = +-w_d''(x_d), with w_d' = scale * s'(t_d) and w_d'' = scale^2 * s''(t_d)
// (s = identity for Linear: s' = 1, s'' = 0; s(t) = t^2 (3 - 2t) for
// Smoothstep: s' = 6t(1 - t), s'' = 6 - 12t; floor() contributes nothing,
// and Nearest weights are constant). Every product is taken in dimension
// order from 1.0, each operation correctly rounded, as the plain versions in
// tcnn_tpu_torch/ops/grid_encode.py write them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tcnn_grid {

constexpr int kMaxDims = 10;
constexpr int kMaxF = 8;

// Layout of one row of the (L, 25) int32 level table built by
// tcnn_tpu_torch/ops/grid_encode.py:level_table.
struct Level {
  uint32_t offset;                 // first table row of the level
  uint32_t size;                   // rows in the level
  int32_t mode;                    // kFold / kQuad / kXor / kBaseConvert
  float scale;
  uint32_t stride[kMaxDims];       // per-dim factor, & 0xFFFFFFFF
  uint32_t stride_mod[kMaxDims];   // per-dim factor mod size (kQuad deltas)
  int32_t serve_round;             // serve-time rounding of this level's reads (kRound*)
};
static_assert(sizeof(Level) == 100, "Level must match the host table layout");

enum { kFold = 0, kQuad = 1, kXor = 2, kBaseConvert = 3 };
enum { kNearest = 0, kLinear = 1, kSmoothstep = 2 };

// A sample's cell on one level: grid position, interpolation fractions and
// (kQuad) the base index.
struct Cell {
  uint32_t pg[kMaxDims];
  float w[kMaxDims];
  uint32_t base;
};

__device__ __forceinline__ Cell locate(const float* __restrict__ xrow, const Level& lv, int n_dims,
                                       int interp) {
  Cell cell;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      const float pos = __fadd_rn(__fmul_rn(__ldg(xrow + d), lv.scale), 0.5f);
      const float pf = floorf(pos);
      cell.pg[d] = (uint32_t)(int32_t)pf;
      float t = __fsub_rn(pos, pf);
      if (interp == kSmoothstep) {
        t = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.0f, __fmul_rn(2.0f, t)));
      }
      cell.w[d] = t;
    }
  }
  cell.base = 0;
  if (lv.mode == kQuad) {
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
      if (d < n_dims) cell.base += cell.pg[d] * lv.stride[d];
    }
    cell.base %= lv.size;
  }
  return cell;
}

// Level-local row of corner c (bit d of c: upper neighbour in dim d) and
// its interpolation weight.
__device__ __forceinline__ uint32_t corner(const Cell& cell, const Level& lv, int n_dims, int interp,
                                           int c, float* weight) {
  float wt = 1.0f;
  uint32_t h = 0;
  uint64_t delta = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      const uint32_t bit = (c >> d) & 1;
      const uint32_t p = cell.pg[d] + bit;
      if (interp != kNearest) wt = __fmul_rn(wt, bit ? cell.w[d] : __fsub_rn(1.0f, cell.w[d]));
      switch (lv.mode) {
        case kFold: h += p * lv.stride[d]; break;
        case kQuad: delta += bit * lv.stride_mod[d]; break;
        case kXor: h ^= p * lv.stride[d]; break;
        default: h = (h + p) * 2531011u; break;  // kBaseConvert
      }
    }
  }
  *weight = wt;
  return lv.mode == kQuad ? (uint32_t)(((uint64_t)cell.base + delta % lv.size) % lv.size)
                          : h % lv.size;
}

enum { kRoundNone = 0, kRoundFp16 = 1, kRoundBf16 = 2 };

__device__ __forceinline__ float round_to(float v, int code) {
  if (code == kRoundFp16) return __half2float(__float2half_rn(v));
  if (code == kRoundBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// A table value as the lookup reads it: fp32, rounded to the encoding's
// table dtype, then to the level's serve-time dtype where it has one.
__device__ __forceinline__ float read_rounded(const float* p, int table_round, const Level& lv) {
  return round_to(round_to(__ldg(p), table_round), lv.serve_round);
}

// Per dim, the first (d1) and second (d2) derivative of the interpolation
// fraction w_d with respect to x_d.
__device__ __forceinline__ void fraction_derivatives(const float* __restrict__ xrow, const Level& lv,
                                                     int n_dims, int interp, float* d1, float* d2) {
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      const float pos = __fadd_rn(__fmul_rn(__ldg(xrow + d), lv.scale), 0.5f);
      const float t = __fsub_rn(pos, floorf(pos));
      float s1 = interp == kNearest ? 0.0f : 1.0f;
      float s2 = 0.0f;
      if (interp == kSmoothstep) {
        s1 = __fmul_rn(__fmul_rn(6.0f, t), __fsub_rn(1.0f, t));
        s2 = __fsub_rn(6.0f, __fmul_rn(12.0f, t));
      }
      d1[d] = __fmul_rn(s1, lv.scale);
      d2[d] = __fmul_rn(__fmul_rn(s2, lv.scale), lv.scale);
    }
  }
}

// The factor of dim d in corner c's weight, and a derivative of it: +v for
// the upper neighbour, -v for the lower.
__device__ __forceinline__ float factor(const Cell& cell, int c, int d) {
  return (c >> d) & 1 ? cell.w[d] : __fsub_rn(1.0f, cell.w[d]);
}
__device__ __forceinline__ float signed_by_bit(int c, int d, float v) { return (c >> d) & 1 ? v : -v; }

// dW[e] = d(weight of corner c) / d x_e: the weight's product with dim e's
// factor replaced by its derivative.
__device__ __forceinline__ void weight_gradient(const float* f, const float* d1, int c, int n_dims, float* dW) {
#pragma unroll
  for (int e = 0; e < kMaxDims; ++e) {
    if (e < n_dims) {
      float p = 1.0f;
#pragma unroll
      for (int d = 0; d < kMaxDims; ++d) {
        if (d < n_dims) p = __fmul_rn(p, d == e ? signed_by_bit(c, d, d1[d]) : f[d]);
      }
      dW[e] = p;
    }
  }
}

// d^2(weight of corner c) / d x_d d x_e: dims d and e replaced by their
// derivatives (d != e), or dim d by its second derivative (d == e).
__device__ __forceinline__ float weight_hessian(const float* f, const float* d1, const float* d2, int c,
                                                int n_dims, int d, int e) {
  float p = 1.0f;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    if (k < n_dims) {
      float v = f[k];
      if (k == d && d == e) {
        v = signed_by_bit(c, k, d2[k]);
      } else if (k == d || k == e) {
        v = signed_by_bit(c, k, d1[k]);
      }
      p = __fmul_rn(p, v);
    }
  }
  return p;
}

}  // namespace tcnn_grid

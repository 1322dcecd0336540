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
// The reductions mod the level size are 32-bit and take no hardware
// division: a power-of-two size masks, any other multiplies by the level
// table's reciprocal (reduce(): a high product and two shifts, exact for
// every uint32), and the affine quad corner adds its per-dim deltas (each
// already below the size) to the base with at most one subtraction each
// (add_mod()). The results are the plain remainders of the 64-bit and
// 32-bit '%' they replace, bit for bit.
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

// Layout of one row of the (L, 28) int32 level table built by
// tcnn_tpu_torch/ops/grid_encode.py:level_table.
struct Level {
  uint32_t offset;                 // first table row of the level
  uint32_t size;                   // rows in the level
  int32_t mode;                    // kFold / kQuad / kXor / kBaseConvert
  float scale;
  uint32_t stride[kMaxDims];       // per-dim factor, & 0xFFFFFFFF
  uint32_t stride_mod[kMaxDims];   // per-dim factor mod size (kQuad deltas)
  int32_t serve_round;             // serve-time rounding of this level's reads (kRound*)
  int32_t own_round;               // rounding of its reads to the encoding's table dtype (kRound*)
  uint32_t mod_magic;              // reduce()'s multiplier; 0 for a power-of-two size (a mask)
  uint32_t mod_shift;              // reduce()'s final shift
};
static_assert(sizeof(Level) == 112, "Level must match the host table layout");

enum { kFold = 0, kQuad = 1, kXor = 2, kBaseConvert = 3 };
enum { kNearest = 0, kLinear = 1, kSmoothstep = 2 };

// h mod lv.size for any uint32 h: a mask for a power-of-two size, else the
// round-up reciprocal method (q = floor(h / size) from one high product,
// t = ((h - hi) >> 1) + hi, q = t >> shift; the host's level_table computes
// magic = floor(2^(33 + s) / size) + 1 - 2^32 and shift = s, s =
// floor(log2 size)), then h - q size.
__device__ __forceinline__ uint32_t reduce(uint32_t h, const Level& lv) {
  if (lv.mod_magic == 0) return h & (lv.size - 1u);
  const uint32_t hi = __umulhi(h, lv.mod_magic);
  const uint32_t q = (((h - hi) >> 1) + hi) >> lv.mod_shift;
  return h - q * lv.size;
}

// (a + b) mod n for a, b < n, with the 32-bit sum's carry.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t n) {
  const uint32_t s = a + b;
  return s < a || s >= n ? s - n : s;
}

// A sample's cell on one level: grid position, interpolation fractions and
// (kQuad) the base index.
struct Cell {
  uint32_t pg[kMaxDims];
  float w[kMaxDims];
  uint32_t base;
};

// The cell of a sample on one level; coord(d) gives its coordinate d.
template <typename Coord>
__device__ __forceinline__ Cell cell_at(Coord coord, const Level& lv, int n_dims, int interp) {
  Cell cell;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      const float pos = __fadd_rn(__fmul_rn(coord(d), lv.scale), 0.5f);
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
    cell.base = reduce(cell.base, lv);
  }
  return cell;
}

// ... of the sample whose coordinates are in global memory at xrow.
__device__ __forceinline__ Cell locate(const float* __restrict__ xrow, const Level& lv, int n_dims, int interp) {
  return cell_at([xrow](int d) { return __ldg(xrow + d); }, lv, n_dims, interp);
}

// ... of the sample whose coordinates xv[0..n_dims-1] are at hand.
__device__ __forceinline__ Cell cell_of(const float* xv, const Level& lv, int n_dims, int interp) {
  return cell_at([xv](int d) { return xv[d]; }, lv, n_dims, interp);
}

// Level-local row of corner c (bit d of c: upper neighbour in dim d) and
// its interpolation weight.
__device__ __forceinline__ uint32_t corner(const Cell& cell, const Level& lv, int n_dims, int interp,
                                           int c, float* weight) {
  float wt = 1.0f;
  uint32_t h = 0, delta = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      const uint32_t bit = (c >> d) & 1;
      const uint32_t p = cell.pg[d] + bit;
      if (interp != kNearest) wt = __fmul_rn(wt, bit ? cell.w[d] : __fsub_rn(1.0f, cell.w[d]));
      switch (lv.mode) {
        case kFold: h += p * lv.stride[d]; break;
        case kQuad:
          if (bit) delta = add_mod(delta, lv.stride_mod[d], lv.size);
          break;
        case kXor: h ^= p * lv.stride[d]; break;
        default: h = (h + p) * 2531011u; break;  // kBaseConvert
      }
    }
  }
  *weight = wt;
  return lv.mode == kQuad ? add_mod(cell.base, delta, lv.size) : reduce(h, lv);
}

enum { kRoundNone = 0, kRoundFp16 = 1, kRoundBf16 = 2 };

__device__ __forceinline__ float round_to(float v, int code) {
  if (code == kRoundFp16) return __half2float(__float2half_rn(v));
  if (code == kRoundBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// A table value v as the lookup reads it on level lv: fp32, rounded to the
// encoding's table dtype where the level reads it so, then to the level's
// serve-time dtype where it has one.
__device__ __forceinline__ float rounded(float v, const Level& lv) {
  return round_to(round_to(v, lv.own_round), lv.serve_round);
}
__device__ __forceinline__ float read_rounded(const float* p, const Level& lv) { return rounded(__ldg(p), lv); }

// The F fp32 values of table row g: float2 / float4 loads where F and the
// table's alignment (`aligned`: 16 bytes) allow. load_row also rounds them
// as level lv reads them.
template <int F>
__device__ __forceinline__ void load_row_raw(const float* __restrict__ table, uint32_t g, bool aligned,
                                             float (&v)[F]) {
  const float* p = table + g * (uint32_t)F;
  if constexpr (F % 4 == 0) {
    if (aligned) {
#pragma unroll
      for (int k = 0; k < F / 4; ++k) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p) + k);
        v[4 * k] = t.x, v[4 * k + 1] = t.y, v[4 * k + 2] = t.z, v[4 * k + 3] = t.w;
      }
      return;
    }
  } else if constexpr (F == 2) {
    if (aligned) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = t.x, v[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = __ldg(p + f);
}

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ params, uint32_t g, bool aligned,
                                         const Level& lv, float (&v)[F]) {
  load_row_raw<F>(params, g, aligned, v);
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = rounded(v[f], lv);
}

// Per dim, the first (d1) and second (d2) derivative of the interpolation
// weight w_d with respect to x_d. K: the arrays' length (the dims at
// compile time, or kMaxDims).
template <int K>
__device__ __forceinline__ void fraction_derivatives(const float* xv, const Level& lv, int n_dims, int interp,
                                                     float (&d1)[K], float (&d2)[K]) {
#pragma unroll
  for (int d = 0; d < K; ++d) {
    if (d < n_dims) {
      const float pos = __fadd_rn(__fmul_rn(xv[d], lv.scale), 0.5f);
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

// The product of a corner's factors f_k in dimension order from 1.0, with
// dims e and e2 replaced by their signed derivatives s1 (dim e by its
// second derivative s2 where e = e2; e2 = -1: dim e alone by s1).
template <int K>
__device__ __forceinline__ float replaced_product(const float (&f)[K], const float (&s1)[K], const float (&s2)[K],
                                                  int e, int e2, int n_dims) {
  float p = 1.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n_dims) p = __fmul_rn(p, k == e && k == e2 ? s2[k] : k == e || k == e2 ? s1[k] : f[k]);
  }
  return p;
}

// Corner c's weight derivatives, from its factors f_k (w_k for the upper
// neighbour in dim k, 1 - w_k for the lower) and their signed derivatives:
// dw[e] = d w_c / d x_e and, with `hess`, h[e2] = sum_e cx[e] d^2 w_c / d x_e
// d x_e2 (h = 0 without). Sums run in index order, as the plain versions
// write them: n_dims^2 products of n_dims factors for the Hessian (27 at
// d = 3). K: the dims at compile time, where the loops unroll; K =
// kMaxDims (the dims at run time) loops.
template <int K>
__device__ __forceinline__ void corner_derivatives(const Cell& cell, const float (&d1)[K], const float (&d2)[K],
                                                   const float (&cx)[K], int c, int n_dims, bool hess,
                                                   float (&dw)[K], float (&h)[K]) {
  float f[K], s1[K], s2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n_dims) {
      const bool up = (c >> k) & 1;
      f[k] = up ? cell.w[k] : __fsub_rn(1.0f, cell.w[k]);
      s1[k] = up ? d1[k] : -d1[k];
      s2[k] = up ? d2[k] : -d2[k];
    }
  }
  auto hessian_row = [&](int e2) {
    float acc = 0.0f;
    if (hess) {
      for (int e = 0; e < n_dims; ++e) acc = __fadd_rn(acc, __fmul_rn(cx[e], replaced_product<K>(f, s1, s2, e, e2, n_dims)));
    }
    return acc;
  };
  if constexpr (K < kMaxDims) {
#pragma unroll
    for (int e = 0; e < K; ++e) {
      dw[e] = replaced_product<K>(f, s1, s2, e, -1, n_dims);
      h[e] = hessian_row(e);
    }
  } else {
#pragma unroll 1
    for (int e = 0; e < n_dims; ++e) {
      dw[e] = replaced_product<K>(f, s1, s2, e, -1, n_dims);
      h[e] = hessian_row(e);
    }
  }
}

}  // namespace tcnn_grid

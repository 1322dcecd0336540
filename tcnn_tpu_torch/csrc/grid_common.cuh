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
//
// Two inputs and one hash beside those (the JAX package's grid extras,
// tcnn_tpu/encodings/grid.py:89-107 and :1580-1592):
// - fixed_point_pos: positions are uint32 spanning [0, 1); per dim pos = x +
//   cell / 2 (wrapping), pos_grid = pos / cell, plus int(scale) where pos
//   wrapped, and t = float(pos - pos_grid * cell) * (scale / (2^32 - 1)) in
//   fp32, with the level table's fixed-point columns (reference:
//   grid.h:1143-1151). cell_at() takes the coordinate type as a template.
// - the Rng hash (kRng): the corner's coordinates XORed into one 64-bit
//   step, coordinate d shifted to bit d * (64 / n_dims), and the uint32
//   output of pcg32(1337) jumped ahead by that step (reference:
//   common_device.h:814-827): one 64-bit multiply and one multiply-add a
//   set bit of the step, the bit's (multiplier, increment) pair read from
//   __constant__ memory at the loop counter, the same address for every
//   lane (a broadcast). Only hashed levels of an encoding with "hash":
//   "Rng" take this mode; the others never enter its branch.
//   With the dims at compile time (D = 1, 2, 3) rng_corners() hashes a
//   whole cell at once. Every jump is a power of one LCG: the jumps commute,
//   J(a + b) = J(a) o J(b), with period 2^64. Where the corners' fields
//   stay apart (p_i + 1 < 2^(64 / D) for every field but the top one) and
//   no coordinate wraps (p_i + 1 < 2^32), the XOR of the shifted
//   coordinates is their sum, so corner c's jump is the product over dims
//   of J(p_i << s_i), times J(1 << s_i) (kPcgJump[s_i]) where bit i of c is
//   set: one loop over the fields' own bits (all D fields in it, each a
//   chain of its own), one composition a dim, then 2^D multiply-adds from
//   the seeded state (tests/test_torch_port_rng_fields.py models it with
//   Python integers). A cell outside that condition (negative or huge
//   coordinates) takes the per-corner jump. At the flagship's finest level
//   (p < 2^13, D = 2) that is 13 loop steps a cell instead of ~45 a corner.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tcnn_grid {

constexpr int kMaxDims = 10;
constexpr int kMaxF = 8;
constexpr int kMaxLevels = 128;  // tcnn_tpu_torch/common.py MAX_N_LEVELS
// The level-major tiles of the lookup (grid_lookup.cuh) and of the input
// gradient and double backward (grid_input_grad.cuh): a block owns kTile
// consecutive samples, one a lane, and its kWarps warps take the levels.
constexpr int kTile = 32;
constexpr int kWarps = 8;

// Layout of one row of the (L, 32) int32 level table built by
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
  uint32_t fp_cell;                // fixed_point_pos: cell width in uint32 units
  uint32_t fp_half;                // fp_cell / 2
  uint32_t fp_int_scale;           // int(scale)
  float fp_factor;                 // fp32(scale / (2^32 - 1))
};
static_assert(sizeof(Level) == 128, "Level must match the host table layout");

// A level's window in a row-sharded table: this rank holds the level-local
// rows [first, first + rows), at the level table's offset (the windowed
// lookup and table gradient read a (n_levels, 2) int32 array of them right
// after the level table: tcnn_tpu_torch/ops/grid_encode.py:windowed_tables).
struct Window {
  uint32_t first, rows;
};

__device__ __forceinline__ Window window_of(const Window* __restrict__ windows, int lvl) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(windows) + lvl);
  return Window{w.x, w.y};
}

enum { kFold = 0, kQuad = 1, kXor = 2, kBaseConvert = 3, kRng = 4 };
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

// The Rng hash's PCG32: the state of pcg32 seeded with 1337, and per bit b
// of a jump the (multiplier, increment) of 2^b steps of its LCG (s' = a s +
// c mod 2^64; tcnn_tpu_torch/ops/pcg32_jump.py:PCG32_JUMP_TABLE, which a
// CPU test holds this copy to).
struct PcgJump {
  uint64_t mult, plus;
};
constexpr uint64_t kPcgState0 = 0x4cfa1d1cde85af8full;
static __constant__ PcgJump kPcgJump[64] = {
    {0x5851f42d4c957f2dull, 0x0000000000000003ull}, {0x685f98a2018fade9ull, 0x08f5dc87e5c07d8aull},
    {0xfb4d3ae39272be11ull, 0x6321e2d2c0df0224ull}, {0xb59dda5f38413d21ull, 0xcfa27e6a8f4cde88ull},
    {0x8d5e2ddc895abe41ull, 0xf889c5f699c3f610ull}, {0x96481983e5188c81ull, 0xa5f6430626c55020ull},
    {0x4425ebbf6f4d5901ull, 0x21c2a9dfbb043040ull}, {0x8980d00b878bb201ull, 0x64a0ecb22e0ea080ull},
    {0x02078e0dd6db6401ull, 0xc5e75b7f2d364100ull}, {0x659acb4fecc6c801ull, 0xabf2b96726d08200ull},
    {0xaa1421b9d5cd9001ull, 0xfbbc643dbf310400ull}, {0x88f21a239c9b2001ull, 0x61514a9b44a20800ull},
    {0x469c6146fd364001ull, 0x1cc260c5a2441000ull}, {0x1dd8088d0a6c8001ull, 0x75700847a8882000ull},
    {0x7fa1b91654d90001ull, 0x4dcdef80e1104000ull}, {0x52ae921da9b20001ull, 0x3f597ac802208000ull},
    {0x902da3ff53640001ull, 0xadda64a904410000ull}, {0xb4bd470ea6c80001ull, 0x19da85b608820000ull},
    {0x04028a5d4d900001ull, 0x388bfcfc11040000ull}, {0xba2505ba9b200001ull, 0xe673c03822080000ull},
    {0x7cc9cf7536400001ull, 0xb256997044100000ull}, {0x1b92aeea6c800001ull, 0x7a6996e088200000ull},
    {0xbf219dd4d9000001ull, 0x4bc4bdc110400000ull}, {0x9e343ba9b2000001ull, 0xf34fbb8220800000ull},
    {0xbc2c775364000001ull, 0x55b8770441000000ull}, {0x7768eea6c8000001ull, 0x67d4ee0882000000ull},
    {0xeb11dd4d90000001ull, 0xc139dc1104000000ull}, {0xc723ba9b20000001ull, 0x48b3b82208000000ull},
    {0x5247753640000001ull, 0xaa67704410000000ull}, {0xb48eea6c80000001ull, 0xb8cee08820000000ull},
    {0xa91dd4d900000001ull, 0x019dc11040000000ull}, {0x523ba9b200000001ull, 0x433b822080000000ull},
    {0xa477536400000001ull, 0x8677044100000000ull}, {0x48eea6c800000001ull, 0x0cee088200000000ull},
    {0x91dd4d9000000001ull, 0x19dc110400000000ull}, {0x23ba9b2000000001ull, 0x33b8220800000000ull},
    {0x4775364000000001ull, 0x6770441000000000ull}, {0x8eea6c8000000001ull, 0xcee0882000000000ull},
    {0x1dd4d90000000001ull, 0x9dc1104000000000ull}, {0x3ba9b20000000001ull, 0x3b82208000000000ull},
    {0x7753640000000001ull, 0x7704410000000000ull}, {0xeea6c80000000001ull, 0xee08820000000000ull},
    {0xdd4d900000000001ull, 0xdc11040000000000ull}, {0xba9b200000000001ull, 0xb822080000000000ull},
    {0x7536400000000001ull, 0x7044100000000000ull}, {0xea6c800000000001ull, 0xe088200000000000ull},
    {0xd4d9000000000001ull, 0xc110400000000000ull}, {0xa9b2000000000001ull, 0x8220800000000000ull},
    {0x5364000000000001ull, 0x0441000000000000ull}, {0xa6c8000000000001ull, 0x0882000000000000ull},
    {0x4d90000000000001ull, 0x1104000000000000ull}, {0x9b20000000000001ull, 0x2208000000000000ull},
    {0x3640000000000001ull, 0x4410000000000000ull}, {0x6c80000000000001ull, 0x8820000000000000ull},
    {0xd900000000000001ull, 0x1040000000000000ull}, {0xb200000000000001ull, 0x2080000000000000ull},
    {0x6400000000000001ull, 0x4100000000000000ull}, {0xc800000000000001ull, 0x8200000000000000ull},
    {0x9000000000000001ull, 0x0400000000000000ull}, {0x2000000000000001ull, 0x0800000000000000ull},
    {0x4000000000000001ull, 0x1000000000000000ull}, {0x8000000000000001ull, 0x2000000000000000ull},
    {0x0000000000000001ull, 0x4000000000000000ull}, {0x0000000000000001ull, 0x8000000000000000ull},
};

// pcg32's output of state s (next_uint() reads the state before its step).
__device__ __forceinline__ uint32_t pcg32_output(uint64_t s) {
  const uint32_t xorshifted = (uint32_t)(((s >> 18) ^ s) >> 27);
  const uint32_t rot = (uint32_t)(s >> 59);
  return (xorshifted >> rot) | (xorshifted << ((32u - rot) & 31u));
}

// pcg32(1337).advance(step).next_uint(). The loop runs to the step's
// highest set bit; every lane reads the pair at the loop counter.
__device__ __forceinline__ uint32_t pcg32_jump_output(uint64_t step) {
  uint64_t acc_mult = 1, acc_plus = 0;
  const int top = 64 - __clzll((long long)step);
#pragma unroll 1
  for (int bit = 0; bit < top; ++bit) {
    const PcgJump j = kPcgJump[bit];
    if ((step >> bit) & 1) {
      acc_mult *= j.mult;
      acc_plus = acc_plus * j.mult + j.plus;
    }
  }
  return pcg32_output(acc_mult * kPcgState0 + acc_plus);
}

// A sample's cell on one level: grid position, interpolation fractions and
// (kQuad) the base index.
struct Cell {
  uint32_t pg[kMaxDims];
  float w[kMaxDims];
  uint32_t base;
};

// The Rng hash of corner c of a cell: its coordinates XORed into the step,
// coordinate d at bit d * (64 / n_dims), then the jump: a loop of its own,
// so that the 64-bit step is not live in corner()'s loop over the dims.
__device__ __forceinline__ uint32_t rng_hash(const Cell& cell, int n_dims, int c) {
  uint64_t step = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) step ^= (uint64_t)(cell.pg[d] + ((c >> d) & 1)) << (d * (64 / n_dims));
  }
  return pcg32_jump_output(step);
}

// The Rng keys of all 2^D corners of a cell (D = 1, 2, 3: the dims at
// compile time), key c as rng_hash(cell, D, c) gives it: the field-
// decomposed jump of the head of this file where the cell's fields stay
// apart, else corner by corner. The loop runs to the highest set bit of any
// coordinate; at step k every lane reads the pairs of bits s_i + k.
template <int D>
__device__ __forceinline__ void rng_corners(const Cell& cell, uint32_t (&keys)[1 << D]) {
  constexpr int kW = 64 / D;  // field width: field i starts at bit i * kW
  bool apart = true;
  uint32_t any = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const uint32_t p = cell.pg[d];
    apart &= p != 0xFFFFFFFFu;
    if constexpr (kW < 32) {
      if (d < D - 1) apart &= p + 1u < (1u << kW);
    }
    any |= p;
  }
  if (!apart) {
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) keys[c] = rng_hash(cell, D, c);
    return;
  }
  uint64_t mult[D], plus[D];  // J(p_i << s_i), field by field
#pragma unroll
  for (int d = 0; d < D; ++d) mult[d] = 1, plus[d] = 0;
  const int top = 32 - __clz(any);
#pragma unroll 1
  for (int k = 0; k < top; ++k) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int bit = d * kW + k;  // past bit 63 (the top field): the period
      if ((d < D - 1 || bit < 64) && ((cell.pg[d] >> k) & 1)) {
        const PcgJump j = kPcgJump[bit];
        mult[d] *= j.mult;
        plus[d] = plus[d] * j.mult + j.plus;
      }
    }
  }
  // The corners' states: dim d doubles them, lower and upper neighbour.
  uint64_t s[1 << D];
  s[0] = kPcgState0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const PcgJump one = kPcgJump[d * kW];
    const uint64_t up_mult = mult[d] * one.mult, up_plus = plus[d] * one.mult + one.plus;
#pragma unroll
    for (int c = 0; c < (1 << d); ++c) {
      s[c + (1 << d)] = up_mult * s[c] + up_plus;
      s[c] = mult[d] * s[c] + plus[d];
    }
  }
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) keys[c] = pcg32_output(s[c]);
}

// Grid position and fraction of one coordinate: fp32 positions, or the
// uint32 positions of fixed_point_pos.
__device__ __forceinline__ void fraction(float x, const Level& lv, uint32_t& pg, float& t) {
  const float pos = __fadd_rn(__fmul_rn(x, lv.scale), 0.5f);
  const float pf = floorf(pos);
  pg = (uint32_t)(int32_t)pf;
  t = __fsub_rn(pos, pf);
}
__device__ __forceinline__ void fraction(uint32_t x, const Level& lv, uint32_t& pg, float& t) {
  const uint32_t pos = x + lv.fp_half;
  pg = pos / lv.fp_cell + (pos < lv.fp_half ? lv.fp_int_scale : 0u);
  t = __fmul_rn(__uint2float_rn(pos - pg * lv.fp_cell), lv.fp_factor);
}

// The cell of a sample on one level; coord(d) gives its coordinate d (a
// float, or a uint32 under fixed_point_pos).
template <typename Coord>
__device__ __forceinline__ Cell cell_at(Coord coord, const Level& lv, int n_dims, int interp) {
  Cell cell;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims) {
      float t;
      fraction(coord(d), lv, cell.pg[d], t);
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

// ... of the sample whose coordinates (float, or uint32 under
// fixed_point_pos) are in global memory at xrow.
template <typename CoordT>
__device__ __forceinline__ Cell locate(const CoordT* __restrict__ xrow, const Level& lv, int n_dims, int interp) {
  return cell_at([xrow](int d) { return __ldg(xrow + d); }, lv, n_dims, interp);
}

// ... of the sample whose coordinates xv[0..n_dims-1] are at hand.
__device__ __forceinline__ Cell cell_of(const float* xv, const Level& lv, int n_dims, int interp) {
  return cell_at([xv](int d) { return xv[d]; }, lv, n_dims, interp);
}

// Level-local row of corner c (bit d of c: upper neighbour in dim d) and
// its interpolation weight. kRngMode false: the caller has no Rng level
// (no code for it).
template <bool kRngMode = true>
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
        case kRng: break;  // rng_hash() below, apart from this loop's live values
        default: h = (h + p) * 2531011u; break;  // kBaseConvert
      }
    }
  }
  *weight = wt;
  if constexpr (kRngMode) {
    if (lv.mode == kRng) h = rng_hash(cell, n_dims, c);
  }
  return lv.mode == kQuad ? add_mod(cell.base, delta, lv.size) : reduce(h, lv);
}

// Corner c's interpolation weight alone, as corner() computes it.
__device__ __forceinline__ float corner_weight(const Cell& cell, int n_dims, int interp, int c) {
  float wt = 1.0f;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims && interp != kNearest) wt = __fmul_rn(wt, (c >> d) & 1 ? cell.w[d] : __fsub_rn(1.0f, cell.w[d]));
  }
  return wt;
}

// corner() with the dims at compile time, for a cell whose Rng keys
// (rng_corners(); read on an Rng level only) are at hand.
template <int D>
__device__ __forceinline__ uint32_t corner_of(const Cell& cell, const Level& lv, int interp, int c,
                                              const uint32_t (&rng_keys)[1 << D], float* weight) {
  if (lv.mode != kRng) return corner<false>(cell, lv, D, interp, c, weight);
  *weight = corner_weight(cell, D, interp, c);
  return reduce(rng_keys[c], lv);
}

// Stochastic interpolation's corner of a cell for the uniform u: bit d set
// where u < w_d, the (smoothstepped) weight of the upper neighbour in dim d
// (reference: grid.h:284-299).
__device__ __forceinline__ int sampled_corner(const Cell& cell, int n_dims, float u) {
  int c = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d < n_dims && u < cell.w[d]) c |= 1 << d;
  }
  return c;
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

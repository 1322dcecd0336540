// Spherical-harmonics direction encoding and its input gradient, for Hopper
// (sm_90a).
//
// Replaces: the XLA computation of tcnn_tpu/encodings/spherical_harmonics.py:
// SphericalHarmonicsEncoding.apply (:106) and its autodiff; the reference
// computes the same basis in one CUDA kernel (encodings/spherical_harmonics.h,
// sh_enc / sh_enc_grad). The JAX package evaluates the real SH basis of
// degree 1-8 from the Sloan recurrences, unrolled: A_m + i B_m = (x + iy)^m,
// q_l^m = P_l^m(z) / sin^m(theta) with the Condon-Shortley sign folded into
// q_m^m = (-1)^m (2m-1)!!, and Y_lm = K q_l^|m| A_|m| (m > 0), K q_l^|m|
// B_|m| (m < 0), K q_l^0 (m = 0), with K = sqrt(2) K_l|m| for m != 0. Inputs
// in [0, 1]^3 are remapped to [-1, 1]^3; the padding columns come BEFORE the
// SH values (spherical_harmonics.h:53-63, the reference's layout).
//
// tcnn_sh_forward computes every product, sum and quotient on its own (the
// _rn intrinsics, no fused multiply-add) in the order of the plain version
// (tcnn_tpu_torch/ops/sh_encode.py:sh_enc), with its fp32 constants, so the
// two agree to the last bit wherever the plain version's arithmetic is
// plain fp32. tcnn_sh_backward_input carries the partial derivatives through
// the same recurrences in registers (forward mode: dA_m/dx = m A_{m-1},
// dA_m/dy = -m B_{m-1}, dB_m/dx = m B_{m-1}, dB_m/dy = m A_{m-1}; dq/dz by
// the recurrence's derivative) and contracts them with dL/dy, times 2 for
// the remap.
//
// What bounds it on this card: HBM. A sample reads 12 bytes of position and
// writes (n_to_pad + degree^2) values; at the NeRF path's 2^18 samples in
// bf16 (7 + 9 columns) that is 11.5 MB, ~3.4 us at 3.35 TB/s, against ~100
// fp32 operations a sample (~0.4 us at 67 TFLOP/s).
//
// Design: one thread per sample's arithmetic, the degree a template
// constant so that the recurrences unroll into registers. Two routes, chosen
// by the wrapper (ops/sh_encode.py:route):
//
// - vector (tcnn_sh_forward_vector, tcnn_sh_backward_input_vector), where a
//   row of padded_width values is a whole number of 16-byte vectors (at
//   most kMaxRowVectors) and the row-vector tensor (the forward's output, the
//   backward's dL/dy) starts on a 16-byte boundary. Then n_to_pad mod V (V =
//   8 bf16 or 4 fp32 values a vector) is fixed by the degree: the row is
//   n_to_pad / V whole vectors of padding (a run-time count of constant
//   vectors) and then a compile-time layout of vectors in which the first
//   kShift columns are padding (VectorRow). No register array is indexed by
//   a run-time value, and nothing waits at a block barrier or divides at run
//   time. A warp takes 32 consecutive rows at a time, a lane one of them;
//   in the forward a lane takes 1-2 such rows (forward_rows), all their
//   loads made before the first row's arithmetic. The forward's lanes
//   assemble their rows in the warp's stage in shared memory and, after
//   __syncwarp, the warp writes its rows' contiguous span as 16-byte
//   vectors, lane after lane, so each 32-byte sector is written whole (a
//   lane writing its own row's vectors would leave two half-written sectors
//   a row for L2 to merge). The backward's lanes read their own dL/dy rows
//   as 16-byte vectors (the two loads a 32-byte row fill whole sectors
//   between them in L1) and stage dL/dx so that the warp writes its 32 rows
//   as 24 float4s.
//   At the NeRF path's shapes a row is 16 bf16 values: two vectors.
// - staged (tcnn_sh_forward, tcnn_sh_backward_input), for every other width
//   or alignment: a block of 128 samples stages its degree^2 values a sample
//   in shared memory (a row stride of degree^2 | 1 words, so a warp's rows
//   fall in distinct banks), then the block writes its contiguous (128,
//   padded_width) output tile in one flat, coalesced loop, the padding
//   columns included. The backward stages the block's dL/dy SH columns the
//   same way before each thread contracts its own row.
//
// Positions are read with a row stride, so a column slice of a wider input
// needs no copy. Both routes compute the same values in the same order, so
// the forward's two routes give the same bits.
//
// tcnn_sh_backward_backward is the input gradient's own vjp, which a loss
// on dL/dx (a penalty on a gradient with respect to the directions)
// differentiates: given the cotangent c of dL/dx it writes d(dL/dy) = 2 J c
// (zeros in the padding columns) and d(x) = 4 sum_j g_j H_j c, J the
// Jacobian and H_j the Hessians of the SH values in the remapped position,
// g the SH columns of dL/dy. Holomorphy of (x + iy)^m gives the second
// partials of A_m, B_m in closed form (d2A_m/dx2 = -d2A_m/dy2 = m (m-1)
// A_{m-2}, d2A_m/dxdy = -m (m-1) B_{m-2}, and the same with B, A for B_m),
// and q'' follows from the recurrence of q' differentiated once more, so a
// thread holds q, q', q'' and A, B of its row in registers. The design is
// the staged route's: a block of 128 rows stages the SH columns of dL/dy in
// shared memory; each thread replaces its row's values by its d(dL/dy)
// values in place as it reads them; the block then writes its (128,
// padded_width) tile in one flat, coalesced loop. The compile-time flags
// NEED_X and NEED_DY skip the output not asked for (without NEED_X dL/dy
// is not read at all: d(dL/dy) does not depend on it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDegree = 8;

// fp32(K_l0) for m = 0 and fp32(sqrt(2) K_l|m|) for m != 0, at index
// l (l + 1) / 2 + |m|: the constants of the plain version, K_lm =
// sqrt((2l + 1) (l - |m|)! / (4 pi (l + |m|)!)) taken in double and rounded
// to fp32 (tests/test_torch_port_composite.py checks them against it).
__constant__ float kCoef[kMaxDegree * (kMaxDegree + 1) / 2] = {
    // l = 0
    2.820948e-01f,
    // l = 1
    4.8860252e-01f, 4.8860252e-01f,
    // l = 2
    6.3078314e-01f, 3.641828e-01f, 1.820914e-01f,
    // l = 3
    7.463527e-01f, 3.046972e-01f, 9.635372e-02f, 3.9336238e-02f,
    // l = 4
    8.462844e-01f, 2.6761863e-01f, 6.3078314e-02f, 1.6858388e-02f, 5.96034e-03f,
    // l = 5
    9.356026e-01f, 2.4157155e-01f, 4.5652732e-02f, 9.318825e-03f, 2.196468e-03f, 6.9458416e-04f,
    // l = 6
    1.0171072e+00f, 2.21951e-01f, 3.5093535e-02f, 5.8489223e-03f, 1.0678623e-03f, 2.2766899e-04f,
    6.572238e-05f,
    // l = 7
    1.0925485e+00f, 2.0647225e-01f, 2.8097313e-02f, 3.9735604e-03f, 5.9903675e-04f, 9.983946e-05f,
    1.9580128e-05f, 5.2330092e-06f,
};

__host__ __device__ constexpr int coef_index(int l, int m) { return l * (l + 1) / 2 + m; }

// Row stride of the shared-memory stage: odd, so that 32 threads' rows fall
// in 32 distinct banks.
template <int DEG>
__host__ __device__ constexpr int stage_stride() {
  return DEG * DEG + ((DEG * DEG) % 2 == 0 ? 1 : 0);
}

// (2m - 1)!! with the Condon-Shortley sign: q_m^m.
__host__ __device__ constexpr float qmm(int m) {
  float v = 1.0f;
  for (int k = 1; k < m; ++k) v *= static_cast<float>(2 * k + 1);
  return (m % 2) ? -v : v;
}

__device__ __forceinline__ float load_value(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_value(void* p, int64_t i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// [0, 1] -> [-1, 1], as the plain version computes it.
__device__ __forceinline__ float remap(float v) { return __fsub_rn(__fmul_rn(v, 2.0f), 1.0f); }

// The degree^2 SH values at (x, y, z) in [-1, 1]^3, level-major with m =
// -l..l, into out[l * l + l + m].
template <int DEG>
__device__ __forceinline__ void sh_values(float x, float y, float z, float* out) {
  float a[DEG], b[DEG];
  a[0] = 1.0f;
  b[0] = 0.0f;
#pragma unroll
  for (int m = 1; m < DEG; ++m) {
    a[m] = __fsub_rn(__fmul_rn(x, a[m - 1]), __fmul_rn(y, b[m - 1]));
    b[m] = __fadd_rn(__fmul_rn(x, b[m - 1]), __fmul_rn(y, a[m - 1]));
  }
#pragma unroll
  for (int m = 0; m < DEG; ++m) {
    float q[DEG];  // q[l] = q_l^m for l = m..DEG-1
    q[m] = qmm(m);
    if (m + 1 < DEG) q[m + 1] = __fmul_rn(__fmul_rn(static_cast<float>(2 * m + 1), z), q[m]);
#pragma unroll
    for (int l = m + 2; l < DEG; ++l) {
      q[l] = __fdiv_rn(__fsub_rn(__fmul_rn(__fmul_rn(static_cast<float>(2 * l - 1), z), q[l - 1]),
                                 __fmul_rn(static_cast<float>(l + m - 1), q[l - 2])),
                       static_cast<float>(l - m));
    }
#pragma unroll
    for (int l = m; l < DEG; ++l) {
      const float c = kCoef[coef_index(l, m)];
      if (m == 0) {
        out[l * l + l] = __fmul_rn(c, q[l]);
      } else {
        out[l * l + l + m] = __fmul_rn(__fmul_rn(c, q[l]), a[m]);
        out[l * l + l - m] = __fmul_rn(__fmul_rn(c, q[l]), b[m]);
      }
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
    sh_forward_kernel(const float* __restrict__ x, int64_t x_stride, void* __restrict__ out, int64_t batch,
                      int n_to_pad, int padded_width, float pad_value, int out_bf16) {
  constexpr int D2 = DEG * DEG;
  constexpr int S = stage_stride<DEG>();
  __shared__ float stage[kThreads * S];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kThreads), batch - row0));
  const int t = threadIdx.x;
  if (t < rows) {
    const float* p = x + (row0 + t) * x_stride;
    float v[D2];
    sh_values<DEG>(remap(p[0]), remap(p[1]), remap(p[2]), v);
#pragma unroll
    for (int j = 0; j < D2; ++j) stage[t * S + j] = v[j];
  }
  __syncthreads();
  // The block's output rows are one contiguous span of rows * padded_width.
  const int total = rows * padded_width;
  const int64_t base = row0 * padded_width;
  for (int i = t; i < total; i += kThreads) {
    const int r = i / padded_width;
    const int c = i - r * padded_width;
    const float v = c < n_to_pad ? pad_value : stage[r * S + (c - n_to_pad)];
    store_value(out, base + i, v, out_bf16);
  }
}

// dL/d(x, y, z) of the position (x0, y0, z0) in [-1, 1]^3 from the
// degree^2 SH columns g[0..degree^2) of its dL/dy row: the partial
// derivatives carried through the recurrences in registers, then contracted
// with g, times 2 for the remap. G is a pointer (the staged route's shared
// row) or a register array (the vector route's), indexed at compile time.
template <int DEG, typename G>
__device__ __forceinline__ float3 sh_input_grad(float x0, float y0, float z0, const G& g) {
  float a[DEG], b[DEG];
  a[0] = 1.0f;
  b[0] = 0.0f;
#pragma unroll
  for (int m = 1; m < DEG; ++m) {
    a[m] = x0 * a[m - 1] - y0 * b[m - 1];
    b[m] = x0 * b[m - 1] + y0 * a[m - 1];
  }
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int m = 0; m < DEG; ++m) {
    float q[DEG], dq[DEG];  // q_l^m and dq_l^m / dz
    q[m] = qmm(m);
    dq[m] = 0.0f;
    if (m + 1 < DEG) {
      q[m + 1] = static_cast<float>(2 * m + 1) * z0 * q[m];
      dq[m + 1] = static_cast<float>(2 * m + 1) * q[m];
    }
#pragma unroll
    for (int l = m + 2; l < DEG; ++l) {
      const float inv = 1.0f / static_cast<float>(l - m);
      q[l] = (static_cast<float>(2 * l - 1) * z0 * q[l - 1] - static_cast<float>(l + m - 1) * q[l - 2]) * inv;
      dq[l] = (static_cast<float>(2 * l - 1) * (q[l - 1] + z0 * dq[l - 1]) -
               static_cast<float>(l + m - 1) * dq[l - 2]) *
              inv;
    }
    // dA_m / dx = m A_{m-1}, dA_m / dy = -m B_{m-1}; dB_m / dx = m B_{m-1},
    // dB_m / dy = m A_{m-1}.
    const float fm = static_cast<float>(m);
    const float dax = m ? fm * a[m - 1] : 0.0f, day = m ? -fm * b[m - 1] : 0.0f;
    const float dbx = m ? fm * b[m - 1] : 0.0f, dby = m ? fm * a[m - 1] : 0.0f;
#pragma unroll
    for (int l = m; l < DEG; ++l) {
      const float c = kCoef[coef_index(l, m)];
      if (m == 0) {
        gz += g[l * l + l] * c * dq[l];
      } else {
        const float gp = g[l * l + l + m] * c, gn = g[l * l + l - m] * c;
        gx += q[l] * (gp * dax + gn * dbx);
        gy += q[l] * (gp * day + gn * dby);
        gz += dq[l] * (gp * a[m] + gn * b[m]);
      }
    }
  }
  // d(2x - 1) / dx = 2.
  return make_float3(2.0f * gx, 2.0f * gy, 2.0f * gz);
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
    sh_backward_input_kernel(const float* __restrict__ x, int64_t x_stride, const void* __restrict__ dy, int dy_bf16,
                             float* __restrict__ dx, int64_t batch, int n_to_pad, int padded_width) {
  constexpr int D2 = DEG * DEG;
  constexpr int S = stage_stride<DEG>();
  __shared__ float stage[kThreads * S];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kThreads), batch - row0));
  const int t = threadIdx.x;
  for (int i = t; i < rows * D2; i += kThreads) {
    const int r = i / D2;
    const int c = i - r * D2;
    stage[r * S + c] = load_value(dy, (row0 + r) * padded_width + n_to_pad + c, dy_bf16);
  }
  __syncthreads();
  if (t >= rows) return;
  const float* p = x + (row0 + t) * x_stride;
  const float3 d = sh_input_grad<DEG>(remap(p[0]), remap(p[1]), remap(p[2]), stage + t * S);
  float* o = dx + (row0 + t) * 3;
  o[0] = d.x;
  o[1] = d.y;
  o[2] = d.z;
}

// The input gradient's vjp at the position (x0, y0, z0) in [-1, 1]^3 with
// the cotangent (cx, cy, cz) of dL/dx: returns sum_j g_j H_j c (without the
// remap's factor 4) from the degree^2 SH columns of dL/dy in row[] (read
// only with NEED_X), and with NEED_DY replaces row[j] by 2 (J c)_j. The
// Hessian terms are summed over l first, for each m: with Q = sum_l q_l K
// g_l, D = sum_l q'_l K g_l and E = sum_l q''_l K g_l (one of each for the
// A and the B columns), the m's share of H c is Q (A_xx c_x + A_xy c_y) + D
// A_x c_z in x, Q (A_xy c_x - A_xx c_y) + D A_y c_z in y and D (A_x c_x +
// A_y c_y) + E A c_z in z, and the same with B.
template <int DEG, bool NEED_X, bool NEED_DY>
__device__ __forceinline__ float3 sh_second_order(float x0, float y0, float z0, float cx, float cy, float cz,
                                                  float* row) {
  float a[DEG], b[DEG];
  a[0] = 1.0f;
  b[0] = 0.0f;
#pragma unroll
  for (int m = 1; m < DEG; ++m) {
    a[m] = x0 * a[m - 1] - y0 * b[m - 1];
    b[m] = x0 * b[m - 1] + y0 * a[m - 1];
  }
  float hx = 0.0f, hy = 0.0f, hz = 0.0f;
#pragma unroll
  for (int m = 0; m < DEG; ++m) {
    float q[DEG], dq[DEG], ddq[DEG];  // q_l^m and its first two derivatives in z
    q[m] = qmm(m);
    dq[m] = 0.0f;
    ddq[m] = 0.0f;
    if (m + 1 < DEG) {
      q[m + 1] = static_cast<float>(2 * m + 1) * z0 * q[m];
      dq[m + 1] = static_cast<float>(2 * m + 1) * q[m];
      ddq[m + 1] = 0.0f;
    }
#pragma unroll
    for (int l = m + 2; l < DEG; ++l) {
      const float inv = 1.0f / static_cast<float>(l - m);
      const float k1 = static_cast<float>(2 * l - 1), k2 = static_cast<float>(l + m - 1);
      q[l] = (k1 * z0 * q[l - 1] - k2 * q[l - 2]) * inv;
      dq[l] = (k1 * (q[l - 1] + z0 * dq[l - 1]) - k2 * dq[l - 2]) * inv;
      ddq[l] = (k1 * (2.0f * dq[l - 1] + z0 * ddq[l - 1]) - k2 * ddq[l - 2]) * inv;
    }
    // First partials of A_m, B_m (as sh_input_grad), and second partials:
    // A_xx = m (m-1) A_{m-2} = -A_yy, A_xy = -m (m-1) B_{m-2}; B_xx = m (m-1)
    // B_{m-2} = -B_yy, B_xy = m (m-1) A_{m-2}.
    const float fm = static_cast<float>(m), fmm = static_cast<float>(m * (m - 1));
    const float ax = m ? fm * a[m - 1] : 0.0f, ay = m ? -fm * b[m - 1] : 0.0f;
    const float bx = m ? fm * b[m - 1] : 0.0f, by = m ? fm * a[m - 1] : 0.0f;
    const float axx = m >= 2 ? fmm * a[m - 2] : 0.0f, axy = m >= 2 ? -fmm * b[m - 2] : 0.0f;
    const float bxx = m >= 2 ? fmm * b[m - 2] : 0.0f, bxy = m >= 2 ? fmm * a[m - 2] : 0.0f;
    // J's A and B columns applied to (cx, cy): the same for every l.
    const float pa = ax * cx + ay * cy, pb = bx * cx + by * cy;
    float qa = 0.0f, qb = 0.0f, da = 0.0f, db = 0.0f, ea = 0.0f, eb = 0.0f;
#pragma unroll
    for (int l = m; l < DEG; ++l) {
      const float k = kCoef[coef_index(l, m)];
      if (m == 0) {
        if (NEED_X) {
          const float gp = row[l * l + l] * k;
          da += dq[l] * gp;
          ea += ddq[l] * gp;
        }
        if (NEED_DY) row[l * l + l] = 2.0f * k * (dq[l] * cz);
      } else {
        if (NEED_X) {
          const float gp = row[l * l + l + m] * k, gn = row[l * l + l - m] * k;
          qa += q[l] * gp;
          qb += q[l] * gn;
          da += dq[l] * gp;
          db += dq[l] * gn;
          ea += ddq[l] * gp;
          eb += ddq[l] * gn;
        }
        if (NEED_DY) {
          row[l * l + l + m] = 2.0f * k * (q[l] * pa + dq[l] * a[m] * cz);
          row[l * l + l - m] = 2.0f * k * (q[l] * pb + dq[l] * b[m] * cz);
        }
      }
    }
    if (NEED_X) {
      hx += qa * (axx * cx + axy * cy) + qb * (bxx * cx + bxy * cy) + (da * ax + db * bx) * cz;
      hy += qa * (axy * cx - axx * cy) + qb * (bxy * cx - bxx * cy) + (da * ay + db * by) * cz;
      hz += da * pa + db * pb + (ea * a[m] + eb * b[m]) * cz;
    }
  }
  return make_float3(hx, hy, hz);
}

template <int DEG, bool NEED_X, bool NEED_DY>
__global__ void __launch_bounds__(kThreads)
    sh_backward_backward_kernel(const float* __restrict__ x, int64_t x_stride, const void* __restrict__ dy,
                                int64_t dy_stride, int dy_bf16, const float* __restrict__ c, int64_t c_stride,
                                float* __restrict__ d_x, void* __restrict__ d_dy, int64_t batch, int n_to_pad,
                                int padded_width) {
  constexpr int D2 = DEG * DEG;
  constexpr int S = stage_stride<DEG>();
  __shared__ float stage[kThreads * S];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kThreads), batch - row0));
  const int t = threadIdx.x;
  if (NEED_X) {
    for (int i = t; i < rows * D2; i += kThreads) {
      const int r = i / D2;
      const int col = i - r * D2;
      stage[r * S + col] = load_value(dy, (row0 + r) * dy_stride + n_to_pad + col, dy_bf16);
    }
    __syncthreads();
  }
  if (t < rows) {
    const float* p = x + (row0 + t) * x_stride;
    const float* q = c + (row0 + t) * c_stride;
    const float3 h =
        sh_second_order<DEG, NEED_X, NEED_DY>(remap(p[0]), remap(p[1]), remap(p[2]), q[0], q[1], q[2], stage + t * S);
    if (NEED_X) {
      // d(2x - 1) / dx = 2, once for each of the two derivatives.
      float* o = d_x + (row0 + t) * 3;
      o[0] = 4.0f * h.x;
      o[1] = 4.0f * h.y;
      o[2] = 4.0f * h.z;
    }
  }
  if (NEED_DY) {
    __syncthreads();
    // The block's d(dL/dy) rows are one contiguous span of rows *
    // padded_width, zeros in the padding columns.
    const int total = rows * padded_width;
    const int64_t base = row0 * padded_width;
    for (int i = t; i < total; i += kThreads) {
      const int r = i / padded_width;
      const int col = i - r * padded_width;
      store_value(d_dy, base + i, col < n_to_pad ? 0.0f : stage[r * S + (col - n_to_pad)], dy_bf16);
    }
  }
}

// The vector route's row layout: V values a 16-byte vector; a row of
// n_to_pad + degree^2 values that is a whole number of vectors has
// n_to_pad = V * pad_vectors + kShift, so after pad_vectors vectors of
// padding come kVectors vectors whose first kShift columns are padding and
// the rest the degree^2 SH values.
template <int DEG, bool BF16>
struct VectorRow {
  static constexpr int kV = BF16 ? 8 : 4;
  static constexpr int kShift = (kV - (DEG * DEG) % kV) % kV;
  static constexpr int kVectors = (kShift + DEG * DEG) / kV;
};

// The vector route: a warp takes 32 consecutive rows at a time, a lane
// one row of them; the warps of a block take consecutive spans of
// 32 * rows_a_lane rows. At most kMaxRowVectors vectors a row: the
// forward's stage, kWarps x 32 rows, then fits in 48 KB.
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowVectors = 24;

// Rows a lane of the forward: each lane's positions are loaded for all its
// rows before the first row's arithmetic; one row where a row has more
// values to hold in registers. At the NeRF path's shapes 2 rows a lane make
// 1024 blocks, one wave; a trial on an H100 ranked 2 first from L2 and
// about even with 1 from HBM, ahead of 4 and 8. The backward takes one row
// a lane: there the trial ranked 1 first from both.
template <int DEG>
__host__ __device__ constexpr int forward_rows() {
  return DEG <= 6 ? 2 : 1;
}

// Two bf16 columns in one word, the first in the low half (little endian).
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Vector k of the row's SH part (after its whole padding vectors), from the
// SH values v and the padding value.
template <int DEG, bool BF16>
__device__ __forceinline__ uint4 row_vector(int k, const float (&v)[DEG * DEG], float pad_value) {
  using Row = VectorRow<DEG, BF16>;
  float e[Row::kV];
#pragma unroll
  for (int i = 0; i < Row::kV; ++i) {
    const int c = k * Row::kV + i - Row::kShift;
    e[i] = c < 0 ? pad_value : v[c < 0 ? 0 : c];
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (BF16) {
      w[i] = pack2(e[2 * i], e[2 * i + 1]);
    } else {
      w[i] = __float_as_uint(e[i]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool BF16>
__device__ __forceinline__ uint4 pad_vector(float pad_value) {
  uint32_t w;
  if constexpr (BF16) {
    w = pack2(pad_value, pad_value);
  } else {
    w = __float_as_uint(pad_value);
  }
  return make_uint4(w, w, w, w);
}

// The degree^2 SH columns of a dL/dy row from the 32-bit words of its
// kVectors SH vectors.
template <int DEG, bool BF16>
__device__ __forceinline__ void unpack_row(const uint32_t (&w)[4 * VectorRow<DEG, BF16>::kVectors],
                                           float (&g)[DEG * DEG]) {
  constexpr int kShift = VectorRow<DEG, BF16>::kShift;
#pragma unroll
  for (int c = 0; c < DEG * DEG; ++c) {
    const int e = c + kShift;  // the column within the SH vectors
    if constexpr (BF16) {
      g[c] = __uint_as_float(e % 2 ? (w[e / 2] & 0xffff0000u) : (w[e / 2] << 16));
    } else {
      g[c] = __uint_as_float(w[e]);
    }
  }
}

// Each lane assembles its row (padding vectors, then the SH vectors) in
// its warp's stage in shared memory; after __syncwarp the warp writes its
// 32 rows, one contiguous span, as 16-byte vectors, neighbouring lanes on
// neighbouring vectors, so every 32-byte sector is written whole.
template <int DEG, bool BF16>
__global__ void __launch_bounds__(kThreads)
    sh_forward_vector_kernel(const float* __restrict__ x, int64_t x_stride, uint4* __restrict__ out, int64_t batch,
                             int pad_vectors, float pad_value) {
  using Row = VectorRow<DEG, BF16>;
  constexpr int R = forward_rows<DEG>();
  extern __shared__ uint4 stage_rows[];  // kWarps x 32 rows x row_vectors
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_vectors = pad_vectors + Row::kVectors;
  uint4* stage = stage_rows + warp * 32 * row_vectors;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * (32 * R);
  float p[R][3];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t r = first + j * 32 + lane;
    const float* q = x + (r < batch ? r : 0) * x_stride;
    p[j][0] = q[0];
    p[j][1] = q[1];
    p[j][2] = q[2];
  }
  const uint4 pad = pad_vector<BF16>(pad_value);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t r0 = first + j * 32;
    if (r0 >= batch) break;  // the same for the whole warp
    const int rows = static_cast<int>(min(static_cast<int64_t>(32), batch - r0));
    if (lane < rows) {
      float v[DEG * DEG];
      sh_values<DEG>(remap(p[j][0]), remap(p[j][1]), remap(p[j][2]), v);
      uint4* s = stage + lane * row_vectors;
      for (int k = 0; k < pad_vectors; ++k) s[k] = pad;
      s += pad_vectors;
#pragma unroll
      for (int k = 0; k < Row::kVectors; ++k) s[k] = row_vector<DEG, BF16>(k, v, pad_value);
    }
    __syncwarp();
    uint4* o = out + r0 * row_vectors;
    for (int c = lane; c < rows * row_vectors; c += 32) o[c] = stage[c];
    __syncwarp();
  }
}

// Each lane reads its own dL/dy row's SH vectors (the 16-byte loads of a
// warp's rows fill whole sectors between them in L1) and writes its dL/dx
// to its warp's stage; the warp then writes its 32 rows' 384 bytes as 24
// float4s.
template <int DEG, bool BF16>
__global__ void __launch_bounds__(kThreads)
    sh_backward_input_vector_kernel(const float* __restrict__ x, int64_t x_stride, const uint4* __restrict__ dy,
                                    float* __restrict__ dx, int64_t batch, int pad_vectors) {
  using Row = VectorRow<DEG, BF16>;
  __shared__ __align__(16) float stage_dx[kWarps][32 * 3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
  if (r0 >= batch) return;  // the same for the whole warp
  const int rows = static_cast<int>(min(static_cast<int64_t>(32), batch - r0));
  const int64_t r = r0 + (lane < rows ? lane : 0);
  const float* q = x + r * x_stride;
  const float x0 = q[0], y0 = q[1], z0 = q[2];
  uint32_t w[4 * Row::kVectors];
  const uint4* g = dy + r * (pad_vectors + Row::kVectors) + pad_vectors;
#pragma unroll
  for (int k = 0; k < Row::kVectors; ++k) {
    const uint4 v = g[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  float gv[DEG * DEG];
  unpack_row<DEG, BF16>(w, gv);
  const float3 d = sh_input_grad<DEG>(remap(x0), remap(y0), remap(z0), gv);
  float* stage = stage_dx[warp];
  stage[lane * 3] = d.x;
  stage[lane * 3 + 1] = d.y;
  stage[lane * 3 + 2] = d.z;
  __syncwarp();
  float* o = dx + r0 * 3;
  if (rows == 32 && (reinterpret_cast<uintptr_t>(dx) & 15) == 0) {
    if (lane < 24) reinterpret_cast<float4*>(o)[lane] = reinterpret_cast<const float4*>(stage)[lane];
  } else {
    for (int c = lane; c < rows * 3; c += 32) o[c] = stage[c];
  }
}

template <template <int> class Launch, typename... Args>
cudaError_t dispatch_degree(int degree, Args... args) {
  switch (degree) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 3: return Launch<3>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 5: return Launch<5>::run(args...);
    case 6: return Launch<6>::run(args...);
    case 7: return Launch<7>::run(args...);
    case 8: return Launch<8>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int DEG>
struct LaunchForward {
  static cudaError_t run(const float* x, int64_t x_stride, void* out, int64_t batch, int n_to_pad, int padded_width,
                         float pad_value, int out_bf16, cudaStream_t stream) {
    const int64_t blocks = (batch + kThreads - 1) / kThreads;
    sh_forward_kernel<DEG><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, x_stride, out, batch, n_to_pad, padded_width, pad_value, out_bf16);
    return cudaGetLastError();
  }
};

template <int DEG>
struct LaunchBackward {
  static cudaError_t run(const float* x, int64_t x_stride, const void* dy, int dy_bf16, float* dx, int64_t batch,
                         int n_to_pad, int padded_width, cudaStream_t stream) {
    const int64_t blocks = (batch + kThreads - 1) / kThreads;
    sh_backward_input_kernel<DEG><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, x_stride, dy, dy_bf16, dx, batch, n_to_pad, padded_width);
    return cudaGetLastError();
  }
};

template <int DEG>
struct LaunchBackwardBackward {
  template <bool NEED_X, bool NEED_DY>
  static cudaError_t go(const float* x, int64_t x_stride, const void* dy, int64_t dy_stride, int dy_bf16,
                        const float* c, int64_t c_stride, float* d_x, void* d_dy, int64_t batch, int n_to_pad,
                        int padded_width, cudaStream_t stream) {
    const int64_t blocks = (batch + kThreads - 1) / kThreads;
    sh_backward_backward_kernel<DEG, NEED_X, NEED_DY><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, x_stride, dy, dy_stride, dy_bf16, c, c_stride, d_x, d_dy, batch, n_to_pad, padded_width);
    return cudaGetLastError();
  }
  static cudaError_t run(const float* x, int64_t x_stride, const void* dy, int64_t dy_stride, int dy_bf16,
                         const float* c, int64_t c_stride, float* d_x, void* d_dy, int64_t batch, int n_to_pad,
                         int padded_width, int need_x, int need_dy, cudaStream_t stream) {
    if (need_x && need_dy)
      return go<true, true>(x, x_stride, dy, dy_stride, dy_bf16, c, c_stride, d_x, d_dy, batch, n_to_pad,
                            padded_width, stream);
    if (need_x)
      return go<true, false>(x, x_stride, dy, dy_stride, dy_bf16, c, c_stride, d_x, d_dy, batch, n_to_pad,
                             padded_width, stream);
    return go<false, true>(x, x_stride, dy, dy_stride, dy_bf16, c, c_stride, d_x, d_dy, batch, n_to_pad,
                           padded_width, stream);
  }
};

// The vector route's kernels, bf16 or fp32 rows. The entry points have
// checked that a row is a whole number of vectors (so n_to_pad mod V is the
// layout's kShift) and that the row-vector tensor is 16-byte aligned.
template <int DEG>
struct LaunchForwardVector {
  template <bool BF16>
  static cudaError_t go(const float* x, int64_t x_stride, void* out, int64_t batch, int n_to_pad, int padded_width,
                        float pad_value, cudaStream_t stream) {
    constexpr int V = VectorRow<DEG, BF16>::kV;
    constexpr int rows = kThreads * forward_rows<DEG>();
    const int64_t blocks = (batch + rows - 1) / rows;
    const size_t stage = static_cast<size_t>(kWarps) * 32 * (padded_width / V) * sizeof(uint4);
    sh_forward_vector_kernel<DEG, BF16><<<static_cast<unsigned>(blocks), kThreads, stage, stream>>>(
        x, x_stride, static_cast<uint4*>(out), batch, n_to_pad / V, pad_value);
    return cudaGetLastError();
  }
  static cudaError_t run(const float* x, int64_t x_stride, void* out, int64_t batch, int n_to_pad, int padded_width,
                         float pad_value, int out_bf16, cudaStream_t stream) {
    return out_bf16 ? go<true>(x, x_stride, out, batch, n_to_pad, padded_width, pad_value, stream)
                    : go<false>(x, x_stride, out, batch, n_to_pad, padded_width, pad_value, stream);
  }
};

template <int DEG>
struct LaunchBackwardVector {
  template <bool BF16>
  static cudaError_t go(const float* x, int64_t x_stride, const void* dy, float* dx, int64_t batch, int n_to_pad,
                        cudaStream_t stream) {
    const int64_t blocks = (batch + kThreads - 1) / kThreads;
    sh_backward_input_vector_kernel<DEG, BF16><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, x_stride, static_cast<const uint4*>(dy), dx, batch, n_to_pad / VectorRow<DEG, BF16>::kV);
    return cudaGetLastError();
  }
  static cudaError_t run(const float* x, int64_t x_stride, const void* dy, int dy_bf16, float* dx, int64_t batch,
                         int n_to_pad, int padded_width, cudaStream_t stream) {
    return dy_bf16 ? go<true>(x, x_stride, dy, dx, batch, n_to_pad, stream)
                   : go<false>(x, x_stride, dy, dx, batch, n_to_pad, stream);
  }
};

// Whether rows of padded_width values of this type at p are whole 16-byte
// vectors, at most kMaxRowVectors of them, starting on 16-byte boundaries
// (the wrapper's route function decides the same).
bool vector_ok(const void* p, int padded_width, int bf16) {
  const int64_t bytes = static_cast<int64_t>(padded_width) * (bf16 ? 2 : 4);
  return bytes % 16 == 0 && bytes <= 16 * kMaxRowVectors && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool shape_ok(int64_t batch, int degree, int n_to_pad, int padded_width) {
  // The flat write loop indexes a block's tile in 32 bits.
  return batch > 0 && degree >= 1 && degree <= kMaxDegree && n_to_pad >= 0 &&
         padded_width == n_to_pad + degree * degree &&
         static_cast<int64_t>(kThreads) * padded_width < (int64_t{1} << 31) &&
         (batch + kThreads - 1) / kThreads < (int64_t{1} << 31);
}

}  // namespace

// out (batch, padded_width), bf16 (out_bf16) or fp32, contiguous: n_to_pad
// columns of pad_value, then degree^2 SH values of the row x[r * x_stride
// + 0..2] (fp32, [0, 1]^3). padded_width must be n_to_pad + degree^2.
extern "C" int tcnn_sh_forward(const float* x, int64_t x_stride, void* out, int64_t batch, int degree,
                               int n_to_pad, int padded_width, float pad_value, int out_bf16, cudaStream_t stream) {
  if (!shape_ok(batch, degree, n_to_pad, padded_width) || x_stride < 3) return cudaErrorInvalidValue;
  return dispatch_degree<LaunchForward>(degree, x, x_stride, out, batch, n_to_pad, padded_width, pad_value, out_bf16,
                                        stream);
}

// dx (batch, 3) fp32, contiguous: dL/dx from dL/dy (batch, padded_width),
// bf16 (dy_bf16) or fp32, contiguous; the padding columns of dL/dy are not
// read (the padding does not depend on x).
extern "C" int tcnn_sh_backward_input(const float* x, int64_t x_stride, const void* dy, int dy_bf16, float* dx,
                                      int64_t batch, int degree, int n_to_pad, int padded_width,
                                      cudaStream_t stream) {
  if (!shape_ok(batch, degree, n_to_pad, padded_width) || x_stride < 3) return cudaErrorInvalidValue;
  return dispatch_degree<LaunchBackward>(degree, x, x_stride, dy, dy_bf16, dx, batch, n_to_pad, padded_width, stream);
}

// tcnn_sh_forward's function on the vector route: the same arguments, and
// padded_width x the element size a multiple of 16 bytes and at most 384,
// out 16-byte aligned (cudaErrorInvalidValue otherwise).
extern "C" int tcnn_sh_forward_vector(const float* x, int64_t x_stride, void* out, int64_t batch, int degree,
                                      int n_to_pad, int padded_width, float pad_value, int out_bf16,
                                      cudaStream_t stream) {
  if (!shape_ok(batch, degree, n_to_pad, padded_width) || x_stride < 3 || !vector_ok(out, padded_width, out_bf16))
    return cudaErrorInvalidValue;
  return dispatch_degree<LaunchForwardVector>(degree, x, x_stride, out, batch, n_to_pad, padded_width, pad_value,
                                              out_bf16, stream);
}

// tcnn_sh_backward_input's function on the vector route: the same
// arguments, and padded_width x dL/dy's element size a multiple of 16
// bytes and at most 384, dL/dy 16-byte aligned (cudaErrorInvalidValue
// otherwise).
extern "C" int tcnn_sh_backward_input_vector(const float* x, int64_t x_stride, const void* dy, int dy_bf16,
                                             float* dx, int64_t batch, int degree, int n_to_pad, int padded_width,
                                             cudaStream_t stream) {
  if (!shape_ok(batch, degree, n_to_pad, padded_width) || x_stride < 3 || !vector_ok(dy, padded_width, dy_bf16))
    return cudaErrorInvalidValue;
  return dispatch_degree<LaunchBackwardVector>(degree, x, x_stride, dy, dy_bf16, dx, batch, n_to_pad, padded_width,
                                               stream);
}

// The input gradient's vjp: with the cotangent c (batch, 3) fp32 of dL/dx
// (row stride c_stride), d_x (batch, 3) fp32 contiguous = the gradient in x
// (need_x), and d_dy (batch, padded_width) contiguous, in dL/dy's type =
// the gradient in dL/dy, zeros in the padding columns (need_dy). dL/dy
// (bf16 or fp32, row stride dy_stride, its padding columns not read) is
// read only for d_x. At least one of need_x and need_dy must be set.
extern "C" int tcnn_sh_backward_backward(const float* x, int64_t x_stride, const void* dy, int64_t dy_stride,
                                         int dy_bf16, const float* c, int64_t c_stride, float* d_x, void* d_dy,
                                         int64_t batch, int degree, int n_to_pad, int padded_width, int need_x,
                                         int need_dy, cudaStream_t stream) {
  if (!shape_ok(batch, degree, n_to_pad, padded_width) || x_stride < 3 || c_stride < 3 || !(need_x || need_dy) ||
      (need_x && (d_x == nullptr || dy == nullptr || dy_stride < padded_width)) || (need_dy && d_dy == nullptr))
    return cudaErrorInvalidValue;
  return dispatch_degree<LaunchBackwardBackward>(degree, x, x_stride, dy, dy_stride, dy_bf16, c, c_stride, d_x, d_dy,
                                                 batch, n_to_pad, padded_width, need_x, need_dy, stream);
}

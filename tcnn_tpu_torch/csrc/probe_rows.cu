// Random row gather and scatter-add probes, for Hopper (sm_90a).
//
// Replaces: the Pallas probes of the TPU row gather and scatter in the JAX
// package's benchmarks: benchmarks/probe_mosaic_gather.py (gather_take,
// gather_brk, scatter_rmw, gather_onehot), probe_mosaic_gather2.py
// (run_case: take_along_axis), probe_r5_pallas_gather2.py (sp_serial,
// sp_unroll8, bs_dma_k, manual_dma, ds8, fused_dot) and
// probe_r5_pallas_gather3.py (static_copy, load_only, store_only,
// ds8_aligned, two_stream, dyngather_sel, onehot_mxu). Those asked how fast
// a TPU core gathers rows from VMEM or HBM (scalar prefetch, DMA, sublane
// alignment, lane-gather select trees); here the same functions ask what
// bounds a random row gather or scatter on this card.
//
// What bounds it on this card: the memory system, per row, not per byte.
// A random row of F fp32 values (8 or 32 bytes at F = 2 or 8) costs at
// least one 32-byte L2 sector, and a table beyond the 50 MB L2 one HBM
// access; so the bytes bound (idx + rows + output once) is far below what
// random access allows. A scatter-add costs one L2 atomic per row (or per
// 16 bytes of it), and collides where many rows hit one slot. What the
// design does about it: every row moves as one vector access (float2 /
// float4 loads, stores and atomics: one L2 request a row where the row
// allows it), several rows a thread are in flight before the first store,
// a warp's stores and index loads are contiguous, index math is 32-bit with
// no division per element, and the grid is sized to the card (grid-stride)
// rather than to the batch. The host's plans (tcnn_tpu_torch/ops/
// probe_rows.py: gather_plan, scatter_plan) pick the vector width from F or
// R and the pointers' alignment, the rows a thread, the grid and the shared
// bytes; each entry point reads them from one int32 array, so a call
// converts few arguments.
//
// Design, one entry point per probe kernel:
// - tcnn_probe_gather:
//   - ROW, WINDOW and COPY from L2 (gather_rows_l2): a warp owns 32 R
//     rows (R = 4 by default; P6's 1, P7's 8), lane l rows l + 32 u, so its
//     index loads and stores are contiguous; a thread loads its R indices,
//     then every row as VEC-wide __ldg loads, and only then stores. (R
//     neighbouring rows a thread, their indices as one int4, measured
//     slower: each store of the warp then half-fills its sectors.) F = 2,
//     4, 8 are compiled with F fixed; other F loop over VEC-wide chunks.
//   - LANE (gather_lanes): a thread owns 4 consecutive lanes of one row: an
//     int4 of indices, 4 random table reads, one float4 store.
//   - SHARED stages the whole table in each block (vector loads), then
//     gathers from it; ASYNC copies in_flight rows a block with cp.async
//     into a shared ring, waits, then stores (the TPU probe's "start G
//     DMAs, wait G, store"). Both store VEC-wide.
//   - TILE_SUM: one block a tile, the tile's rows into shared memory, then
//     an in-order sum per feature (bit-exact to the probe's loop).
// - tcnn_probe_scatter: ADD with R / VEC threads a row, each one VEC-wide
//   row load and one vector atomicAdd (global memory, sm_90), 4 rows a
//   thread in flight; or into private per-block copies of the whole table
//   in shared memory (scalar shared atomics), flushed once per non-zero
//   float4 with vector atomics, in as many blocks as keep the flush at most
//   an eighth of the adds (the plan's choice; otherwise none).
//   STORE_LAST claims each slot for the largest row index (atomicMax) and
//   then writes the winners' rows VEC-wide.
// - tcnn_probe_gather_dot: one thread per output element, an in-order
//   chain of fmaf over the F gathered values (F = 8: no tensor cores).
//
// The output of a scatter and STORE_LAST's winners are set here
// (cudaMemsetAsync: zeros, and -1 as all-ones bytes), not by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kRow = 0, kLane = 1, kWindow = 2, kTileSum = 3, kCopy = 4 };
enum Source { kL2 = 0, kShared = 1, kAsync = 2 };
enum Flags { kRoundBf16 = 1, kFeatureMajor = 2, kTransposed = 4, kAligned = 8 };
enum Op { kAdd = 0, kStoreLast = 1 };

// The plans' int32 arrays (ops/probe_rows.py: GatherPlan.args,
// ScatterPlan.args), entry by entry.
enum GatherArg {
  gB, gS, gF, gMode, gSource, gFlags, gTileShift, gVec, gRows, gPerRow, gPerRowShift, gThreads, gGrid, gSmem
};
enum ScatterArg { sN, sS, sR, sOp, sPrivate, sVec, sPerRow, sPerRowShift, sThreads, sGrid, sSmem };

constexpr int kThreads = 256;
// Scatter items a thread has in flight: 4, or 2 in the private blocks of
// 1,024 threads (64 registers a thread at most; their threads hide latency).
template <bool PRIVATE>
constexpr int kIlp = PRIVATE ? 2 : 4;

__device__ __forceinline__ float maybe_round(float v, int flags) {
  return (flags & kRoundBf16) ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Where element f of output row b goes: row-major (B, F) or feature-major
// (B / tile, F, tile), tile = 1 << tile_shift.
__device__ __forceinline__ size_t out_at(uint32_t b, int f, int F, int tile_shift, int flags) {
  if (flags & kFeatureMajor)
    return ((((size_t)(b >> tile_shift)) * F + f) << tile_shift) + (b & ((1u << tile_shift) - 1u));
  return (size_t)b * F + f;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
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

// A VEC-wide load from shared memory.
template <int VEC>
__device__ __forceinline__ void load_vec_shared(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// One vector atomic (global memory, compute capability 9.x) or a scalar one.
template <int VEC>
__device__ __forceinline__ void atomic_add_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Stores N values (rounded already) of output row b from feature f0 on:
// VEC-wide in row-major order, element by element in feature-major order.
template <int VEC, int N>
__device__ __forceinline__ void store_row(float* __restrict__ out, uint32_t b, int f0, const float* v, int F,
                                          int tile_shift, int flags) {
  if (flags & kFeatureMajor) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[out_at(b, f0 + k, F, tile_shift, flags)] = v[k];
  } else {
#pragma unroll
    for (int k = 0; k < N; k += VEC) store_vec<VEC>(out + (size_t)b * F + f0 + k, v + k);
  }
}

// Table row r (an index outside [0, S) reads zeros) of the gather's rows
// b0 + 32 u that lie in [0, B): ROW reads idx[b], WINDOW idx[b & ~7] (& ~7
// aligned) + (b & 7), COPY b % tile.
template <int R>
__device__ __forceinline__ void row_indices(const int32_t* __restrict__ idx, uint32_t b0, uint32_t B, int mode,
                                            int flags, int tile_shift, uint32_t (&r)[R]) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const uint32_t b = b0 + 32u * u;
    if (b >= B) {
      r[u] = 0xffffffffu;
    } else if (mode == kRow) {
      r[u] = (uint32_t)__ldg(idx + b);
    } else if (mode == kWindow) {
      uint32_t a = (uint32_t)__ldg(idx + (b & ~7u));
      if (flags & kAligned) a &= ~7u;
      r[u] = a + (b & 7u);  // wraps as the plain version's int32 sum
    } else {  // kCopy
      r[u] = b & ((1u << tile_shift) - 1u);
    }
  }
}

// ROW, WINDOW and COPY from L2. Rows come in groups of 32 R, one a warp
// (grid-stride over the groups); lane l owns rows base + l + 32 u (u < R),
// so each index load and each store of the warp is contiguous (at F = 2,
// 256 bytes: whole sectors). A thread loads its R indices, then all its
// rows (R x F / VEC loads in flight), then stores. FC > 0 compiles F = FC
// (the values stay in registers); FC = 0 loops over VEC-wide chunks of a
// runtime F. Odd rows read table2 where it is given; a transposed (F, S)
// table is read element by element (the plan's VEC is 1).
template <int VEC, int R, int FC>
__global__ void __launch_bounds__(kThreads)
    gather_rows_l2(const float* __restrict__ table, const float* __restrict__ table2,
                   const int32_t* __restrict__ idx, float* __restrict__ out, uint32_t B, uint32_t S, int F, int mode,
                   int flags, int tile_shift) {
  const uint32_t groups = (B + 32u * R - 1) / (32u * R);
  const uint32_t n_warps = (gridDim.x * blockDim.x) >> 5;
  const bool transposed = flags & kTransposed;
  for (uint32_t g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; g < groups; g += n_warps) {
    const uint32_t b0 = g * 32u * R + (threadIdx.x & 31u);
    uint32_t r[R];
    row_indices<R>(idx, b0, B, mode, flags, tile_shift, r);
    constexpr int NF = FC > 0 ? FC : VEC;  // values a row held at once
    for (int f0 = 0; f0 < (FC > 0 ? FC : F); f0 += NF) {
      float v[R * NF];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const float* t = (table2 != nullptr && ((b0 + 32u * u) & 1u)) ? table2 : table;
#pragma unroll
        for (int f = 0; f < NF; f += VEC) {
          if (r[u] >= S) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u * NF + f + k] = 0.0f;
          } else if (transposed) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[u * NF + f + k] = __ldg(t + (size_t)(f0 + f + k) * S + r[u]);
          } else {
            load_vec<VEC>(t + (size_t)r[u] * F + f0 + f, v + u * NF + f);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < R * NF; ++k) v[k] = maybe_round(v[k], flags);
#pragma unroll
      for (int u = 0; u < R; ++u)
        if (b0 + 32u * u < B) store_row<VEC, NF>(out, b0 + 32u * u, f0, v + u * NF, F, tile_shift, flags);
    }
  }
}

// LANE: out[b, l] = table[idx[b, l], l]. A thread owns lanes 4q .. 4q + 3
// (those below F) of row b, for item t = b * Q + q (Q = ceil(F / 4) quads a
// row; b = t >> q_shift where Q is a power of two, else one division a
// thread). V4 (F a multiple of 4): the four indices as one int4, the four
// values stored as one float4 in row-major order.
template <bool V4>
__global__ void __launch_bounds__(kThreads)
    gather_lanes(const float* __restrict__ table, const int32_t* __restrict__ idx, float* __restrict__ out,
                 uint32_t B, uint32_t S, int F, int Q, int q_shift, int flags, int tile_shift) {
  const uint32_t n = B * (uint32_t)Q;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const uint32_t b = q_shift >= 0 ? t >> q_shift : t / (uint32_t)Q;
    const int f0 = (int)(t - b * (uint32_t)Q) * 4;
    const int nl = min(4, F - f0);
    const size_t base = (size_t)b * F + f0;
    uint32_t r[4];
    if (V4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(idx + base));
      r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = k < nl ? (uint32_t)__ldg(idx + base + k) : 0xffffffffu;
    }
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float x = 0.0f;
      if (r[k] < S)
        x = (flags & kTransposed) ? __ldg(table + (size_t)(f0 + k) * S + r[k])
                                  : __ldg(table + (size_t)r[k] * F + f0 + k);
      v[k] = maybe_round(x, flags);
    }
    if (V4 && !(flags & kFeatureMajor)) {
      store_vec<4>(out + base, v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < nl) out[out_at(b, f0 + k, F, tile_shift, flags)] = v[k];
    }
  }
}

// ROW from shared memory: the block stages the whole (S, F) table (S * F *
// 4 <= 227 KB, checked by the wrapper) with VEC-wide loads, then its threads
// gather from it, one row a thread, VEC-wide.
template <int VEC>
__global__ void gather_rows_shared(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                   float* __restrict__ out, uint32_t B, uint32_t S, int F, int flags,
                                   int tile_shift) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t n = S * (uint32_t)F;
  for (uint32_t i = threadIdx.x * VEC; i < n; i += blockDim.x * VEC) {
    float v[VEC];
    load_vec<VEC>(table + i, v);
    store_vec<VEC>(smem + i, v);
  }
  __syncthreads();
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b < B; b += stride) {
    const uint32_t r = (uint32_t)__ldg(idx + b);
    for (int f = 0; f < F; f += VEC) {
      float v[VEC];
      if (r < S) {
        load_vec_shared<VEC>(smem + r * (uint32_t)F + f, v);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = maybe_round(v[k], flags);
      store_row<VEC, VEC>(out, b, f, v, F, tile_shift, flags);
    }
  }
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem_src), "n"(BYTES) : "memory");
  }
}

// ROW through cp.async: blockDim.x = in_flight threads; each round every
// thread copies one row (VEC floats a copy) into its slot of the block's
// ring, the block waits for all of them, and each thread stores its row
// VEC-wide.
template <int VEC>
__global__ void gather_rows_async(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                  float* __restrict__ out, uint32_t B, uint32_t S, int F, int flags, int tile_shift) {
  extern __shared__ __align__(16) float ring[];
  float* slot = ring + threadIdx.x * F;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b - threadIdx.x < B; b += stride) {
    const uint32_t r = b < B ? (uint32_t)__ldg(idx + b) : 0xffffffffu;
    const bool ok = r < S;
    if (ok) {
      const float* src = table + (size_t)r * F;
      for (int f = 0; f < F; f += VEC) cp_async<4 * VEC>(slot + f, src + f);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (b < B) {
      for (int f = 0; f < F; f += VEC) {
        float v[VEC];
        if (ok) {
          load_vec_shared<VEC>(slot + f, v);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = maybe_round(v[k], flags);
        store_row<VEC, VEC>(out, b, f, v, F, tile_shift, flags);
      }
    }
    __syncthreads();
  }
}

// TILE_SUM: one block per tile; its threads gather the tile's rows into
// shared memory (a row a thread), then thread f sums feature f over the
// tile in order (the probe's loop order, so the sum is bit-exact against
// it) into row 8g.
__global__ void gather_tile_sum(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                float* __restrict__ out, uint32_t S, int F, int flags, int tile) {
  extern __shared__ __align__(16) float rows[];
  const uint32_t g = blockIdx.x;
  const int32_t* ix = idx + (size_t)g * tile;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const uint32_t r = (uint32_t)__ldg(ix + j);
    for (int f = 0; f < F; ++f) {
      float x = 0.0f;
      if (r < S) x = (flags & kTransposed) ? __ldg(table + (size_t)f * S + r) : __ldg(table + (size_t)r * F + f);
      rows[j * F + f] = x;
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < tile; ++j) acc = __fadd_rn(acc, rows[j * F + f]);
    out[(size_t)g * 8 * F + f] = maybe_round(acc, flags);
  }
}

// Item t of a scatter: row n = t / T and its VEC-wide chunk c (T = R / VEC
// threads a row; a shift where T is a power of two).
__device__ __forceinline__ uint32_t item_row(uint32_t t, int T, int t_shift) {
  return t_shift >= 0 ? t >> t_shift : t / (uint32_t)T;
}

// ADD: kIlp items a thread in flight (grid-stride), each an index and a
// VEC-wide row chunk loaded before any add. PRIVATE: the block first zeroes
// its shared copy of the whole (S, R) table, adds into it with scalar shared
// atomics, then flushes every float4 of it that is not all zero with one
// vector atomic; else one vector atomic a chunk straight into the result.
template <int VEC, bool PRIVATE>
__global__ void __launch_bounds__(PRIVATE ? 1024 : kThreads)
    scatter_add(const int32_t* __restrict__ idx, const float* __restrict__ rows, float* __restrict__ out, uint32_t N,
                uint32_t S, int R, int T, int t_shift) {
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
  constexpr int ILP = kIlp<PRIVATE>;
  for (uint32_t t0 = blockIdx.x * blockDim.x + threadIdx.x; t0 < n_items; t0 += ILP * stride) {
    uint32_t r[ILP], at[ILP];
    float v[ILP][VEC];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const uint32_t t = t0 + k * stride;
      r[k] = 0xffffffffu, at[k] = 0;
      if (t < n_items) {
        const uint32_t n = item_row(t, T, t_shift);
        const int c = (int)(t - n * (uint32_t)T) * VEC;
        r[k] = (uint32_t)__ldg(idx + n);
        at[k] = (uint32_t)c;
        load_vec<VEC>(rows + (size_t)n * R + c, v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      if (r[k] >= S) continue;
      if constexpr (PRIVATE) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) atomicAdd(acc + r[k] * (uint32_t)R + at[k] + j, v[k][j]);
      } else {
        atomic_add_vec<VEC>(out + (size_t)r[k] * R + at[k], v[k]);
      }
    }
  }
  if constexpr (PRIVATE) {
    __syncthreads();
    for (uint32_t e = threadIdx.x; e < n_acc / 4; e += blockDim.x) {
      const float4 a = reinterpret_cast<const float4*>(acc)[e];
      if (a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f) atomicAdd(reinterpret_cast<float4*>(out) + e, a);
    }
    for (uint32_t e = n_acc / 4 * 4 + threadIdx.x; e < n_acc; e += blockDim.x)
      if (acc[e] != 0.0f) atomicAdd(out + e, acc[e]);
  }
}

__global__ void store_last_claim(const int32_t* __restrict__ idx, int32_t* __restrict__ winner, uint32_t N,
                                 uint32_t S) {
  const uint32_t j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const uint32_t r = (uint32_t)__ldg(idx + j);
  if (r < S) atomicMax(winner + r, (int32_t)j);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    store_last_write(const int32_t* __restrict__ idx, const float* __restrict__ rows,
                     const int32_t* __restrict__ winner, float* __restrict__ out, uint32_t N, uint32_t S, int R, int T,
                     int t_shift) {
  const uint32_t n_items = N * (uint32_t)T;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < n_items; t += stride) {
    const uint32_t n = item_row(t, T, t_shift);
    const int c = (int)(t - n * (uint32_t)T) * VEC;
    const uint32_t r = (uint32_t)__ldg(idx + n);
    if (r < S && winner[r] == (int32_t)n) {
      float v[VEC];
      load_vec<VEC>(rows + (size_t)n * R + c, v);
      store_vec<VEC>(out + (size_t)r * R + c, v);
    }
  }
}

constexpr int kDotCols = 128;

__global__ void gather_dot(const float* __restrict__ table, const int32_t* __restrict__ idx,
                           const float* __restrict__ w, float* __restrict__ out, int64_t B, int64_t S, int F) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * kDotCols) return;
  const int64_t b = i / kDotCols;
  const int c = (int)(i % kDotCols);
  const int32_t r = __ldg(idx + b);
  float acc = 0.0f;
  if (r >= 0 && r < S) {
    const float* row = table + (int64_t)r * F;
    for (int f = 0; f < F; ++f) acc = fmaf(__ldg(row + f), __ldg(w + f * kDotCols + c), acc);
  }
  out[i] = acc;
}

unsigned blocks_for(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int VEC, int FC>
void launch_rows_l2(int R, const int32_t* p, const float* t, const float* t2, const int32_t* ix, float* o,
                    cudaStream_t st) {
  const dim3 grid(p[gGrid]), block(p[gThreads]);
  const uint32_t B = p[gB], S = p[gS];
  const int F = p[gF], mode = p[gMode], flags = p[gFlags], ts = p[gTileShift];
  if (R == 8) {
    gather_rows_l2<VEC, 8, FC><<<grid, block, 0, st>>>(t, t2, ix, o, B, S, F, mode, flags, ts);
  } else if (R == 4) {
    gather_rows_l2<VEC, 4, FC><<<grid, block, 0, st>>>(t, t2, ix, o, B, S, F, mode, flags, ts);
  } else {
    gather_rows_l2<VEC, 1, FC><<<grid, block, 0, st>>>(t, t2, ix, o, B, S, F, mode, flags, ts);
  }
}

}  // namespace

// Each entry point returns the cudaError_t of its launches (0 on success),
// launches on `stream` and does not synchronise. Arguments are checked by
// the wrappers in tcnn_tpu_torch/ops/probe_rows.py; `plan` is the host
// plan's int32 array (GatherArg / ScatterArg above).
extern "C" int tcnn_probe_gather(const void* table, const void* table2, const void* idx, void* out,
                                 const int32_t* plan, void* stream) {
  const int32_t* p = plan;
  if (p[gB] <= 0 || p[gGrid] <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float* t2 = static_cast<const float*>(table2);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  const uint32_t B = p[gB], S = p[gS];
  const int F = p[gF], mode = p[gMode], source = p[gSource], flags = p[gFlags], ts = p[gTileShift];
  const int vec = p[gVec];
  const dim3 grid(p[gGrid]), block(p[gThreads]);
  const size_t smem = (size_t)p[gSmem];
  if (mode == kRow && source == kShared) {
    const void* fn = vec == 4 ? (const void*)gather_rows_shared<4>
                   : vec == 2 ? (const void*)gather_rows_shared<2> : (const void*)gather_rows_shared<1>;
    const int err = set_smem(fn, smem);
    if (err) return err;
    if (vec == 4) {
      gather_rows_shared<4><<<grid, block, smem, st>>>(t, ix, o, B, S, F, flags, ts);
    } else if (vec == 2) {
      gather_rows_shared<2><<<grid, block, smem, st>>>(t, ix, o, B, S, F, flags, ts);
    } else {
      gather_rows_shared<1><<<grid, block, smem, st>>>(t, ix, o, B, S, F, flags, ts);
    }
  } else if (mode == kRow && source == kAsync) {
    const void* fn = vec == 4 ? (const void*)gather_rows_async<4>
                   : vec == 2 ? (const void*)gather_rows_async<2> : (const void*)gather_rows_async<1>;
    const int err = set_smem(fn, smem);
    if (err) return err;
    if (vec == 4) {
      gather_rows_async<4><<<grid, block, smem, st>>>(t, ix, o, B, S, F, flags, ts);
    } else if (vec == 2) {
      gather_rows_async<2><<<grid, block, smem, st>>>(t, ix, o, B, S, F, flags, ts);
    } else {
      gather_rows_async<1><<<grid, block, smem, st>>>(t, ix, o, B, S, F, flags, ts);
    }
  } else if (mode == kTileSum) {
    const int err = set_smem((const void*)gather_tile_sum, smem);
    if (err) return err;
    gather_tile_sum<<<grid, block, smem, st>>>(t, ix, o, S, F, flags, 1 << ts);
  } else if (mode == kLane) {
    if (vec == 4) {
      gather_lanes<true><<<grid, block, 0, st>>>(t, ix, o, B, S, F, p[gPerRow], p[gPerRowShift], flags, ts);
    } else {
      gather_lanes<false><<<grid, block, 0, st>>>(t, ix, o, B, S, F, p[gPerRow], p[gPerRowShift], flags, ts);
    }
  } else {  // ROW, WINDOW, COPY from L2
    const int R = p[gRows];
    if (F == 2 && vec == 2) {
      launch_rows_l2<2, 2>(R, p, t, t2, ix, o, st);
    } else if (F == 4 && vec == 4) {
      launch_rows_l2<4, 4>(R, p, t, t2, ix, o, st);
    } else if (F == 8 && vec == 4) {
      launch_rows_l2<4, 8>(R, p, t, t2, ix, o, st);
    } else if (vec == 4) {
      launch_rows_l2<4, 0>(R, p, t, t2, ix, o, st);
    } else if (vec == 2) {
      launch_rows_l2<2, 0>(R, p, t, t2, ix, o, st);
    } else {
      launch_rows_l2<1, 0>(R, p, t, t2, ix, o, st);
    }
  }
  return (int)cudaGetLastError();
}

// Sets `out` (S, R) to zeros and, for STORE_LAST, `winner` (S int32) to -1,
// then scatters.
extern "C" int tcnn_probe_scatter(const void* idx, const void* rows, void* out, void* winner, const int32_t* plan,
                                  void* stream) {
  const int32_t* p = plan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t N = p[sN], S = p[sS];
  const int R = p[sR], vec = p[sVec], T = p[sPerRow], ts = p[sPerRowShift];
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* rw = static_cast<const float*>(rows);
  float* o = static_cast<float*>(out);
  int err = (int)cudaMemsetAsync(o, 0, (size_t)S * R * sizeof(float), st);
  if (err) return err;
  if (p[sOp] == kStoreLast) {
    err = (int)cudaMemsetAsync(winner, 0xff, (size_t)S * sizeof(int32_t), st);
    if (err) return err;
  }
  if (N == 0 || p[sGrid] <= 0) return (int)cudaGetLastError();
  const dim3 grid(p[sGrid]), block(p[sThreads]);
  const size_t smem = (size_t)p[sSmem];
  if (p[sOp] == kStoreLast) {
    int32_t* win = static_cast<int32_t*>(winner);
    store_last_claim<<<blocks_for(N, kThreads), kThreads, 0, st>>>(ix, win, N, S);
    if (vec == 4) {
      store_last_write<4><<<grid, block, 0, st>>>(ix, rw, win, o, N, S, R, T, ts);
    } else if (vec == 2) {
      store_last_write<2><<<grid, block, 0, st>>>(ix, rw, win, o, N, S, R, T, ts);
    } else {
      store_last_write<1><<<grid, block, 0, st>>>(ix, rw, win, o, N, S, R, T, ts);
    }
  } else if (p[sPrivate] > 0) {
    const void* fn = vec == 4 ? (const void*)scatter_add<4, true>
                   : vec == 2 ? (const void*)scatter_add<2, true> : (const void*)scatter_add<1, true>;
    err = set_smem(fn, smem);
    if (err) return err;
    if (vec == 4) {
      scatter_add<4, true><<<grid, block, smem, st>>>(ix, rw, o, N, S, R, T, ts);
    } else if (vec == 2) {
      scatter_add<2, true><<<grid, block, smem, st>>>(ix, rw, o, N, S, R, T, ts);
    } else {
      scatter_add<1, true><<<grid, block, smem, st>>>(ix, rw, o, N, S, R, T, ts);
    }
  } else {
    if (vec == 4) {
      scatter_add<4, false><<<grid, block, 0, st>>>(ix, rw, o, N, S, R, T, ts);
    } else if (vec == 2) {
      scatter_add<2, false><<<grid, block, 0, st>>>(ix, rw, o, N, S, R, T, ts);
    } else {
      scatter_add<1, false><<<grid, block, 0, st>>>(ix, rw, o, N, S, R, T, ts);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int tcnn_probe_gather_dot(const void* table, const void* idx, const void* w, void* out, int64_t B,
                                     int64_t S, int F, void* stream) {
  if (B <= 0) return 0;
  gather_dot<<<blocks_for(B * kDotCols, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<float*>(out), B, S, F);
  return (int)cudaGetLastError();
}

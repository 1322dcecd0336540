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
//   - ROW from L2, and WINDOW and COPY of a transposed table or into
//     feature-major tiles (gather_rows_l2): a warp owns 32 R rows (R = 4
//     by default; P6's 1, P7's 8), lane l rows l + 32 u, so its index
//     loads and stores are contiguous; a thread loads its R indices, then
//     every row as VEC-wide __ldg loads, and only then stores. (R
//     neighbouring rows a thread, their indices as one int4, measured
//     slower: each store of the warp then half-fills its sectors.) F = 2,
//     4, 8 are compiled with F fixed; other F loop over VEC-wide chunks.
//   - WINDOW (gather_windows; replaces probe_r5_pallas_gather2.py:282
//     k_ds8, the ds8 pallas_call at :308, and probe_r5_pallas_gather3.py:199
//     k3, ds8_aligned at :211): a window is 8 consecutive table rows, 8 F
//     contiguous floats in the table and in the output, so the output is
//     one flat run of B F / VEC vectors and vector q is vector q % NV of
//     window q / NV (NV = 8 F / VEC). Consecutive lanes move consecutive
//     vectors (at F = 8, a half-warp one window), so every load and store
//     instruction of a warp covers whole sectors; the lanes of a window load
//     its one start idx[8 w] (one request a window); a lane has K vectors'
//     loads in flight before its first store and the next chunk's starts
//     loaded ahead. What bounds it: 4 B F output bytes written and as many
//     read from L2, behind two dependent L2 round trips (the start, then
//     the rows); the grid fills the card (grid-stride over chunks of 32 K
//     vectors; K = 2, kWindowVectors, measured fastest of 1, 2, 4 at the
//     probe's shape, streaming stores no faster than plain ones; PERF.md).
//     F = 1, 2, 4, 8, the alignment and the rounding at compile time;
//     other F divide at run time. Each vector's row is tested against [0, S) (zeros
//     outside; the start plus the row wraps as the plain version's int32
//     sum).
//   - COPY (copy_tiles; replaces probe_r5_pallas_gather3.py:138 k0, the
//     static_copy pallas_call at :146): out[e] = table[e mod TILE F], flat:
//     no index. Thread t holds vector t mod NT of the first tile (NT = TILE F
//     / VEC vectors, read once from L2) in registers and stores it to every
//     tile it owns, consecutive lanes on consecutive vectors; a whole
//     number of tile copies in about one block an SM (at the probe's
//     shape 8 tiles a thread, 128 blocks: measured faster than 1-4 tiles
//     a thread, and than staging tile chunks in shared memory and storing
//     them by cp.async.bulk; PERF.md). What bounds it: the 4 B F output
//     bytes written.
//   - ROW of a transposed (F, S) table into feature-major tiles, from L2
//     (gather_planes): the output's (B / tile, F, tile) layout makes each
//     feature plane of a tile contiguous, while a sample's F values lie S
//     floats apart in the table, each its own 32-byte L2 sector. So a block
//     copies P whole feature planes (t[f0 .. f0 + P - 1, :], one contiguous
//     span of the table) into shared memory with cp.async, loading its
//     first indices meanwhile, then gathers from them for a run of
//     samples: a warp reads 32 consecutive indices and writes 128
//     contiguous bytes of each of its planes. The plan picks P (a divisor
//     of F whose planes fit a block) and the runs (one wave of blocks over
//     the card) that move the fewest bytes; P = 1, 2, 4, 8 compiled with P
//     fixed. Where one plane does not fit, the L2 gather below.
//   - LANE (gather_lanes): a thread owns 4 consecutive lanes of one row: an
//     int4 of indices, 4 random table reads, one float4 store.
//   - SHARED (gather_rows_shared): persistent blocks, one wave, each stage
//     the whole table in shared memory by cp.async, every copy of a thread
//     in flight at once, while every thread loads its first indices; then
//     warps gather 32 R rows at a time and store them as contiguous
//     vectors. ASYNC (gather_rows_async): each warp copies a group of
//     in_flight rows by cp.async into its own slice of shared memory,
//     waits for it and stores it, no block barrier (the TPU probe's "start
//     G DMAs, wait G, store").
//   - TILE_SUM (gather_tile_sum_chunked): one block a tile, its summing
//     warp beside kSumChunks chunks of kChunkRows gathering threads. The
//     sum of a feature over a tile is one chain of 2048 dependent fp32 adds
//     in index order (bit-exact to the probe's loop), so the chain's
//     latency, not the bytes, bounds the kernel. Each gathering thread
//     issues its row of every chunk at once (float4 / float2 loads where F
//     and the alignment allow), writes each chunk into a feature-major,
//     padded shared copy and arrives on that chunk's mbarrier; lane f of
//     the summing warp starts on chunk 0 while later chunks are still in
//     flight, and loads 16 operands as float4s ahead of their adds, so a
//     step costs one dependent add. F = 1, 2, 4, 8 at compile time.
// - tcnn_probe_scatter: ADD with R / VEC threads a row, each one VEC-wide
//   row load and one vector atomicAdd (global memory, sm_90), 4 rows a
//   thread in flight; or into private per-block copies of the whole table
//   in shared memory (scalar shared atomics), flushed once per non-zero
//   float4 with vector atomics, in as many blocks as keep the flush at most
//   an eighth of the adds (the plan's choice; otherwise none).
//   STORE_LAST writes each output row once: store_last_claim takes each
//   slot's largest row index j (a 64-bit atomicMax of (epoch, j) into a
//   winner array the caller keeps between calls, each call with a larger
//   epoch, so no call fills or resets it), then store_last_slots walks the
//   slots in order, a warp 32 at a time: one coalesced load of their
//   winners (those of an earlier epoch read as none), then the warp writes
//   the 32 rows as one contiguous span of VEC-wide stores, each the
//   winner's row (read VEC-wide) or zeros. No fill of the output, no
//   scattered store, no write to the winners but the claim's.
// - tcnn_probe_gather_dot (gather_dot_warps): out = table[idx] @ w, w (F,
//   128). The 2^24 output floats at the probe's shape (64 MiB) bound it:
//   the product is 2 F flops a float. Persistent blocks, a warp takes 32
//   samples at a time: one coalesced index load a lane (the next group's
//   loaded ahead), shared by __shfl_sync; lane l owns columns 4l .. 4l + 3
//   and keeps their 4 F values of w in registers; each sample's row comes
//   as F / 4 float4 broadcast loads, several samples' rows in flight
//   before the first multiply-add; each column is the in-order fmaf chain
//   over f, so the bits do not depend on the launch layout; a lane
//   writes one float4 with a streaming store, so a warp writes a sample's
//   512-byte output row in one instruction. fp32 FMA, not tensor cores:
//   the probe's tolerance rules out TF32. F = 1, 2, 4, 8 at compile time.
//
// The output of an ADD scatter is zeroed here (cudaMemsetAsync), not by the
// caller; STORE_LAST writes every output row itself and takes a winner
// array and an epoch from the caller (ops/probe_rows.py).

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
  gB, gS, gF, gMode, gSource, gFlags, gTileShift, gVec, gRows, gPerRow, gPerRowShift, gThreads, gGrid, gSmem, gChunks,
  gPlanes, gRuns, gRun, gInFlight, gRoute
};
// The kernel a plan launches (ops/probe_rows.py: GATHER_ROUTES), decided by
// the host's gather_plan alone.
enum Route {
  kRouteL2 = 0, kRouteLane = 1, kRouteTileSum = 2, kRoutePlanes = 3, kRouteShared = 4, kRouteAsync = 5,
  kRouteWindow = 6, kRouteCopy = 7
};
enum ScatterArg { sN, sS, sR, sOp, sPrivate, sVec, sPerRow, sPerRowShift, sThreads, sGrid, sSmem, sClaimGrid };
enum DotArg { dB, dS, dF, dVec, dInFlight, dThreads, dGrid };

constexpr int kThreads = 256;
// Rows a tile of feature-major output and of TILE_SUM (ops/probe_rows.py:
// TILE); the plans' tile_shift is its log2.
constexpr int kTile = 2048;
constexpr int kTileShift = 11;
// Scatter items a thread has in flight: 4, or 2 in the private blocks of
// 1,024 threads (64 registers a thread at most; their threads hide latency).
template <bool PRIVATE>
constexpr int kIlp = PRIVATE ? 2 : 4;

__device__ __forceinline__ float maybe_round(float v, int flags) {
  return (flags & kRoundBf16) ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool ROUND>
__device__ __forceinline__ float round_if(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
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

// Vectors a lane of the WINDOW kernel has in flight (K; 2 measured fastest
// of 1, 2 and 4 at P10's and P15's shapes, PERF.md).
constexpr int kWindowVectors = 2;

// The starts of the windows of a lane's K vectors q = q0 + 32 k (those
// below n_vec): idx[8 (q / nv)], & ~7 when ALIGNED.
template <bool ALIGNED>
__device__ __forceinline__ void window_starts(const int32_t* __restrict__ idx, uint32_t q0, uint32_t n_vec,
                                              uint32_t nv, uint32_t (&a)[kWindowVectors]) {
#pragma unroll
  for (int k = 0; k < kWindowVectors; ++k) {
    const uint32_t q = q0 + 32u * k;
    a[k] = q < n_vec ? (uint32_t)__ldg(idx + (q / nv) * 8u) : 0u;
    if (ALIGNED) a[k] &= ~7u;
  }
}

// WINDOW: out[8 w + u] = table[a_w + u] (u < 8; a_w = idx[8 w], & ~7 when
// ALIGNED; zeros for a row outside [0, S)), as a flat run of n_vec = B F /
// VEC vectors: vector q is vector e = q % NV of window q / NV (NV = 8 F /
// VEC), row a_w + e / (F / VEC), chunk e % (F / VEC). Warp c of the grid
// takes chunks c, c + n_warps, ... of 32 K vectors; lane l vectors
// c 32 K + l + 32 k (k < K): their K starts (the next chunk's loaded
// ahead), then their K VEC-wide loads, then their stores (K =
// kWindowVectors). FC > 0: F = FC at compile time (shifts); FC = 0: F at
// run time.
template <int VEC, int FC, bool ALIGNED, bool ROUND>
__global__ void __launch_bounds__(kThreads)
    gather_windows(const float* __restrict__ table, const int32_t* __restrict__ idx, float* __restrict__ out,
                   uint32_t n_vec, uint32_t S, int F_rt) {
  constexpr int K = kWindowVectors;
  const uint32_t F = FC > 0 ? (uint32_t)FC : (uint32_t)F_rt;
  const uint32_t per_row = F / VEC;
  const uint32_t nv = 8u * per_row;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t n_warps = (gridDim.x * blockDim.x) >> 5;
  const uint32_t chunks = (n_vec + 32u * K - 1) / (32u * K);
  uint32_t c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  uint32_t a[K];
  window_starts<ALIGNED>(idx, c * 32u * K + lane, n_vec, nv, a);
  for (; c < chunks; c += n_warps) {
    const uint32_t q0 = c * 32u * K + lane;
    uint32_t next[K];
    window_starts<ALIGNED>(idx, (c + n_warps) * 32u * K + lane, n_vec, nv, next);
    float v[K * VEC];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t q = q0 + 32u * k;
      const uint32_t e = q % nv;
      const uint32_t row = a[k] + e / per_row;  // wraps as the plain version's int32 sum
      if (q < n_vec && row < S) {
        load_vec<VEC>(table + (size_t)row * F + (e % per_row) * VEC, v + k * VEC);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[k * VEC + j] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < K * VEC; ++j) v[j] = round_if<ROUND>(v[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t q = q0 + 32u * k;
      if (q < n_vec) store_vec<VEC>(out + (size_t)q * VEC, v + k * VEC);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = next[k];
  }
}

// COPY: out[e] = table[e mod TILE F], as vectors: the grid's G threads
// form `groups` groups of W = G / groups (W = NT, the vectors of a tile,
// unless a tile has more vectors than the card holds threads). Thread t
// loads vector s = t % W of the first tile once, stores it to tiles
// t / W, t / W + groups, ... below n_tiles, then takes s + W, ... below NT.
template <int VEC, bool ROUND>
__global__ void __launch_bounds__(kThreads)
    copy_tiles(const float* __restrict__ table, float* __restrict__ out, uint32_t n_tiles, uint32_t nt,
               uint32_t groups) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t width = gridDim.x * blockDim.x / groups;
  const uint32_t g = t / width;
  for (uint32_t s = t - g * width; s < nt; s += width) {
    float v[VEC];
    load_vec<VEC>(table + (size_t)s * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = round_if<ROUND>(v[j]);
#pragma unroll 4
    for (uint32_t r = g; r < n_tiles; r += groups) store_vec<VEC>(out + ((size_t)r * nt + s) * VEC, v);
  }
}

constexpr int kPlaneThreads = 1024;
constexpr int kPlaneGroups = 4;  // groups of 32 samples a warp has in flight

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

// The indices of the kPlaneGroups groups of 32 samples from group g0 on
// (n_warps apart) that lie in the run: lane l's of each, or ~0 past it.
__device__ __forceinline__ void plane_indices(const int32_t* __restrict__ idx, uint32_t b_begin, uint32_t b_end,
                                              uint32_t n_groups, uint32_t g0, uint32_t n_warps, uint32_t lane,
                                              uint32_t (&r)[kPlaneGroups]) {
#pragma unroll
  for (int u = 0; u < kPlaneGroups; ++u) {
    const uint32_t g = g0 + n_warps * u;
    const uint32_t b = b_begin + g * 32u + lane;
    r[u] = g < n_groups && b < b_end ? (uint32_t)__ldg(idx + b) : 0xffffffffu;
  }
}

// ROW of a transposed (F, S) table into feature-major tiles: out[b >> ts, f,
// b & (tile - 1)] = t[f, idx[b]] (zero for an index outside [0, S)). Work
// item w (grid-stride over groups * runs items) is plane group w / runs
// (features P (w / runs) .. + P - 1) and sample run w % runs (samples
// run * (w % runs) .. + run - 1). A block copies its group's P planes, one
// contiguous span of P S floats, into shared memory with cp.async (VEC
// floats a copy, all of a thread's in flight at once) and loads its first
// indices while they land; then warp k takes the run's groups of 32
// samples k + n_warps (u + kPlaneGroups i), the kPlaneGroups of one i at a
// time, the next i's indices loaded before this i's stores: lane l holds
// index l of each group, and for each plane the warp stores each group's
// 32 values as 128 contiguous bytes. PC > 0: P = PC at compile time;
// PC = 0: P at run time. The tile and the bf16 rounding (ROUND) are
// compile-time too: with a run-time tile shift and flag the kernel
// measured slower.
template <int VEC, int PC, bool ROUND>
__global__ void __launch_bounds__(kPlaneThreads)
    gather_planes(const float* __restrict__ table, const int32_t* __restrict__ idx, float* __restrict__ out,
                  uint32_t B, uint32_t S, int F, int P_rt, uint32_t runs, uint32_t run) {
  extern __shared__ __align__(16) float planes[];
  const int P = PC > 0 ? PC : P_rt;
  const uint32_t n_items = (uint32_t)(F / P) * runs;
  const uint32_t span = (uint32_t)P * S;
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const uint32_t step = n_warps * kPlaneGroups;
  for (uint32_t w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int f0 = (int)(w / runs) * P;
    const uint32_t b_begin = (w % runs) * run;
    const uint32_t b_end = min(B, b_begin + run);
    const uint32_t n_groups = (b_end - b_begin + 31u) / 32u;
    const float* src = table + (size_t)f0 * S;
    __syncthreads();  // the previous item's gathers are done with the planes
    for (uint32_t i = threadIdx.x * VEC; i < span; i += blockDim.x * VEC) cp_async<4 * VEC>(planes + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    uint32_t r[kPlaneGroups];
    plane_indices(idx, b_begin, b_end, n_groups, warp, n_warps, lane, r);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (uint32_t g0 = warp; g0 < n_groups; g0 += step) {
      uint32_t next[kPlaneGroups];
      plane_indices(idx, b_begin, b_end, n_groups, g0 + step, n_warps, lane, next);
#pragma unroll
      for (int u = 0; u < kPlaneGroups; ++u) {
        const uint32_t b = b_begin + (g0 + n_warps * u) * 32u + lane;
        if (g0 + n_warps * u < n_groups && b < b_end) {
          float* o = out + ((((size_t)(b >> kTileShift)) * F + f0) << kTileShift) + (b & (kTile - 1u));
          if constexpr (PC > 0) {
#pragma unroll
            for (int q = 0; q < PC; ++q)
              o[(size_t)q << kTileShift] = round_if<ROUND>(r[u] < S ? planes[q * S + r[u]] : 0.0f);
          } else {
            for (int q = 0; q < P; ++q)
              o[(size_t)q << kTileShift] = round_if<ROUND>(r[u] < S ? planes[q * S + r[u]] : 0.0f);
          }
        }
        r[u] = next[u];
      }
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

// cp.async of BYTES (4, 8 or 16) that reads `src_bytes` (BYTES or 0) from
// global memory and fills the rest of the BYTES with zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem_dst, const void* gmem_src, uint32_t src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem_src), "n"(BYTES),
                 "r"(src_bytes)
                 : "memory");
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Row q / T of a group of rows T vectors long (a shift where T is a power
// of two).
__device__ __forceinline__ uint32_t vector_row(uint32_t q, int T, int t_shift) {
  return t_shift >= 0 ? q >> t_shift : q / (uint32_t)T;
}

constexpr int kSharedThreads = 1024;

// SHARED: ROW from a copy of the whole (S, F) table in each block's shared
// memory (4 S F bytes <= 227 KB, checked by the wrapper). Persistent
// blocks of kSharedThreads, one wave. The block's threads copy the table
// with cp.async, VEC floats a copy and every copy of a thread in flight at
// once; meanwhile each thread loads the indices of its first R rows, then
// waits for its copies and the block synchronises. Then the warps take
// groups of 32 R rows (grid-stride; the next group's indices loaded
// ahead), lane l owning rows base + l + 32 u as in gather_rows_l2.
// Row-major output: the 32 rows of each u are 32 T contiguous vectors (T =
// F / VEC); lane l gathers and stores vectors l + 32 k from shared memory,
// the row's index shuffled from its owner, so each store of the warp writes
// 32 contiguous vectors. Feature-major: lane l stores its own row's F
// values, a warp 128 contiguous bytes a feature. R, VEC and the rounding
// are compile-time. Staging by bulk copies (TMA) on an mbarrier, multicast
// over thread-block clusters of 1-8 blocks, measured slower at the probes'
// tables (about twice cp.async's staging time; a cluster costs about 1 us
// of its own; PERF.md).
template <int VEC, int R, bool ROUND>
__global__ void __launch_bounds__(kSharedThreads, 1)
    gather_rows_shared(const float* __restrict__ table, const int32_t* __restrict__ idx, float* __restrict__ out,
                       uint32_t B, uint32_t S, int F, int T, int t_shift, int flags) {
  extern __shared__ __align__(16) float tab[];
  const uint32_t n = S * (uint32_t)F;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t n_warps = (gridDim.x * blockDim.x) >> 5;
  const uint32_t groups = (B + 32u * R - 1) / (32u * R);
  for (uint32_t i = threadIdx.x * VEC; i < n; i += blockDim.x * VEC) cp_async<4 * VEC>(tab + i, table + i);
  cp_async_commit();
  uint32_t g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  uint32_t r[R];
  row_indices<R>(idx, g * 32u * R + lane, B, kRow, 0, 0, r);
  cp_async_wait<0>();
  __syncthreads();
  const bool feature_major = flags & kFeatureMajor;
  for (; g < groups; g += n_warps) {
    uint32_t next[R];
    row_indices<R>(idx, (g + n_warps) * 32u * R + lane, B, kRow, 0, 0, next);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const uint32_t b0 = g * 32u * R + 32u * u;
      if (b0 >= B) break;
      if (feature_major) {
        if (b0 + lane < B) {
          for (int f = 0; f < F; ++f)
            out[out_at(b0 + lane, f, F, kTileShift, flags)] = round_if<ROUND>(r[u] < S ? tab[r[u] * F + f] : 0.0f);
        }
      } else {
        const uint32_t nv = min(32u, B - b0) * (uint32_t)T;
        float* o = out + (size_t)b0 * F;
        for (uint32_t q = lane; q < 32u * T; q += 32u) {
          const uint32_t j = vector_row(q, T, t_shift);
          const uint32_t rj = __shfl_sync(0xffffffffu, r[u], (int)j);
          if (q < nv) {
            float v[VEC];
            if (rj < S) {
              load_vec_shared<VEC>(tab + rj * (uint32_t)F + (q - j * (uint32_t)T) * VEC, v);
            } else {
#pragma unroll
              for (int k = 0; k < VEC; ++k) v[k] = 0.0f;
            }
#pragma unroll
            for (int k = 0; k < VEC; ++k) v[k] = round_if<ROUND>(v[k]);
            store_vec<VEC>(o + (size_t)q * VEC, v);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) r[u] = next[u];
  }
}

constexpr int kAsyncWarps = 8;      // warps a block of the ASYNC gather at most (ops/probe_rows.py: ASYNC_WARPS)
constexpr int kAsyncPrefetch = 4;   // vectors a lane whose indices are loaded a group ahead

// ASYNC's indices of group g for the lane's vectors q = lane + 32 k (k <
// kAsyncPrefetch) of the group's G T: the index of row g G + row[k] (row[k]
// = q / T, computed once a thread), or ~0 past the group, the batch or the
// groups.
__device__ __forceinline__ void async_indices(const int32_t* __restrict__ idx, uint32_t g, uint32_t groups, uint32_t G,
                                              uint32_t B, uint32_t gvec, uint32_t lane,
                                              const uint32_t (&row)[kAsyncPrefetch], uint32_t (&r)[kAsyncPrefetch]) {
#pragma unroll
  for (int k = 0; k < kAsyncPrefetch; ++k) {
    const uint32_t b = g * G + row[k];
    r[k] = g < groups && lane + 32u * k < gvec && b < B ? (uint32_t)__ldg(idx + b) : 0xffffffffu;
  }
}

// ASYNC's copy of vector q of a group (row j, chunk q - j T) from table
// row r into `slot`, a zero-byte source for a row outside the table.
template <int VEC>
__device__ __forceinline__ void async_copy(const float* __restrict__ table, float* slot, uint32_t q, uint32_t j,
                                           uint32_t r, uint32_t S, int F, int T) {
  const bool in = r < S;
  const float* src = in ? table + (size_t)r * F + (q - j * (uint32_t)T) * VEC : table;
  cp_async_zfill<4 * VEC>(slot + (size_t)q * VEC, src, in ? 4u * VEC : 0u);
}

// ASYNC's copies of group g into `slot`: lane l copies vectors l + 32 k of
// the group's G T, the indices of its first kAsyncPrefetch vectors (rows
// `row`) from `pre`, the rest loaded as they are issued (~0 past the batch).
template <int VEC>
__device__ __forceinline__ void async_issue(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                            float* slot, uint32_t g, uint32_t G, uint32_t B, uint32_t S, int F,
                                            uint32_t gvec, int T, int t_shift, uint32_t lane,
                                            const uint32_t (&row)[kAsyncPrefetch],
                                            const uint32_t (&pre)[kAsyncPrefetch]) {
#pragma unroll
  for (int k = 0; k < kAsyncPrefetch; ++k) {
    const uint32_t q = lane + 32u * k;
    if (q < gvec) async_copy<VEC>(table, slot, q, row[k], pre[k], S, F, T);
  }
  for (uint32_t q = lane + 32u * kAsyncPrefetch; q < gvec; q += 32u) {
    const uint32_t j = vector_row(q, T, t_shift);
    const uint32_t b = g * G + j;
    async_copy<VEC>(table, slot, q, j, b < B ? (uint32_t)__ldg(idx + b) : 0xffffffffu, S, F, T);
  }
}

// ASYNC: ROW through cp.async, a copy group at a time a warp. Group g is
// rows g G .. g G + G - 1 (G = in_flight), G T vectors of VEC floats (T =
// F / VEC); warp w of the grid takes groups w, w + n_warps, ... into its
// own slice of shared memory: it issues the group (lane l copies vectors
// l + 32 k into the slice, a zero-byte source filling zeros for a row
// outside the table or past the batch; the indices of a lane's first
// kAsyncPrefetch vectors were loaded a group ahead, the rest as they are
// issued), commits it, loads the next group's indices, waits for the group
// and stores it: row-major, lane l stores the vectors it copied, contiguous
// for the warp; feature-major, lane l a row's F values. __syncwarp before
// and after the stores; no block barrier. A ring of 2, 4 or 8 groups in
// flight a warp measured slower at every shape tried (PERF.md).
template <int VEC, bool ROUND>
__global__ void __launch_bounds__(32 * kAsyncWarps)
    gather_rows_async(const float* __restrict__ table, const int32_t* __restrict__ idx, float* __restrict__ out,
                      uint32_t B, uint32_t S, int F, uint32_t G, int T, int t_shift, int flags) {
  extern __shared__ __align__(16) float slots[];
  const uint32_t lane = threadIdx.x & 31u, wpb = blockDim.x >> 5;
  const uint32_t gvec = G * (uint32_t)T;
  float* slot = slots + (size_t)(threadIdx.x >> 5) * G * (uint32_t)F;
  const uint32_t n_warps = gridDim.x * wpb;
  const uint32_t groups = (B + G - 1) / G;
  const bool feature_major = flags & kFeatureMajor;
  uint32_t row[kAsyncPrefetch];  // the rows of the lane's first vectors of a group
#pragma unroll
  for (int k = 0; k < kAsyncPrefetch; ++k) row[k] = vector_row(lane + 32u * k, T, t_shift);
  uint32_t g = blockIdx.x * wpb + (threadIdx.x >> 5);
  uint32_t next[kAsyncPrefetch];
  async_indices(idx, g, groups, G, B, gvec, lane, row, next);
  for (; g < groups; g += n_warps) {
    async_issue<VEC>(table, idx, slot, g, G, B, S, F, gvec, T, t_shift, lane, row, next);
    cp_async_commit();
    async_indices(idx, g + n_warps, groups, G, B, gvec, lane, row, next);
    cp_async_wait<0>();
    __syncwarp();
    const uint32_t b_base = g * G;
    const uint32_t rows = min(G, B - b_base);
    if (feature_major) {
      for (uint32_t j = lane; j < rows; j += 32u) {
        for (int f = 0; f < F; ++f) out[out_at(b_base + j, f, F, kTileShift, flags)] = round_if<ROUND>(slot[j * F + f]);
      }
    } else {
      float* o = out + (size_t)b_base * F;
      const uint32_t nv = rows * (uint32_t)T;
      for (uint32_t q = lane; q < nv; q += 32u) {
        float v[VEC];
        load_vec_shared<VEC>(slot + (size_t)q * VEC, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = round_if<ROUND>(v[k]);
        store_vec<VEC>(o + (size_t)q * VEC, v);
      }
    }
    __syncwarp();
  }
}

// Row r (< S) of the table into v: an (S, F) table's row as VEC-wide
// loads (VEC = 4 or 2 only where it divides FC), a transposed (F, S)
// table's element by element.
template <int FC>
__device__ __forceinline__ void load_row(const float* __restrict__ table, uint32_t r, uint32_t S, int vec,
                                         bool transposed, float* v) {
  if (transposed) {
#pragma unroll
    for (int f = 0; f < FC; ++f) v[f] = __ldg(table + (size_t)f * S + r);
  } else if (FC % 4 == 0 && vec == 4) {
#pragma unroll
    for (int f = 0; f < FC; f += 4) load_vec<4>(table + (size_t)r * FC + f, v + f);
  } else if (FC % 2 == 0 && vec >= 2) {
#pragma unroll
    for (int f = 0; f < FC; f += 2) load_vec<2>(table + (size_t)r * FC + f, v + f);
  } else {
#pragma unroll
    for (int f = 0; f < FC; ++f) v[f] = __ldg(table + (size_t)r * FC + f);
  }
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier of a block: init with the arrivals a phase takes, arrive
// (release: the arriving thread's shared stores are visible to a waiter),
// and wait for phase `parity` to complete (acquire).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(shared_address(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n" : "=l"(state) : "r"(shared_address(bar)) : "memory");
  (void)state;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TILE_SUM's layout of a tile (ops/probe_rows.py mirrors it:
// TILE_SUM_CHUNKS, TILE_SUM_PAD, TILE_SUM_THREADS).
constexpr int kSumChunks = 8;
constexpr int kChunkRows = kTile / kSumChunks;  // one row a gathering thread a chunk
constexpr int kSumThreads = 32 + kChunkRows;    // the summing warp, then the gatherers
constexpr int kSumLd = kTile + 4;  // floats a feature in shared memory: float4 reads of 8 features hit 32 banks
constexpr int kSumBatch = 16;      // operands a summing lane loads ahead of their adds

// TILE_SUM: out[8 g + 0, f] = the sum over the tile's rows j in order of
// table[idx[g * kTile + j], f] (zero for an index outside [0, S)); rows 1-7
// of the 8-row block zero. Block g: warp 0 sums (lane f, feature f < F),
// threads 32 + t gather row c * kChunkRows + t of every chunk c into
// cols[f * kSumLd + j] and arrive on ready[c]. FC > 0: F = FC at compile
// time, every chunk's row loaded before the first is stored; FC = 0: a
// run-time F (at most 28: the shared copy fits), chunk by chunk.
template <int FC>
__global__ void __launch_bounds__(kSumThreads, 1)
    gather_tile_sum_chunked(const float* __restrict__ table, const int32_t* __restrict__ idx,
                            float* __restrict__ out, uint32_t S, int F_rt, int vec, int flags) {
  extern __shared__ __align__(16) float cols[];
  __shared__ uint64_t ready[kSumChunks];
  const int F = FC > 0 ? FC : F_rt;
  const uint32_t g = blockIdx.x;
  if (threadIdx.x < kSumChunks) mbar_init(&ready[threadIdx.x], kChunkRows);
  __syncthreads();
  if (threadIdx.x >= 32) {
    const int t = threadIdx.x - 32;
    const bool transposed = flags & kTransposed;
    uint32_t r[kSumChunks];
#pragma unroll
    for (int c = 0; c < kSumChunks; ++c) r[c] = (uint32_t)__ldg(idx + (size_t)g * kTile + c * kChunkRows + t);
    if constexpr (FC > 0) {
      float v[kSumChunks * FC];
#pragma unroll
      for (int c = 0; c < kSumChunks; ++c) {
        if (r[c] < S) {
          load_row<FC>(table, r[c], S, vec, transposed, v + c * FC);
        } else {
#pragma unroll
          for (int f = 0; f < FC; ++f) v[c * FC + f] = 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < kSumChunks; ++c) {
#pragma unroll
        for (int f = 0; f < FC; ++f) cols[f * kSumLd + c * kChunkRows + t] = v[c * FC + f];
        mbar_arrive(&ready[c]);
      }
    } else {
      for (int c = 0; c < kSumChunks; ++c) {
        for (int f = 0; f < F; ++f) {
          float x = 0.0f;
          if (r[c] < S) x = transposed ? __ldg(table + (size_t)f * S + r[c]) : __ldg(table + (size_t)r[c] * F + f);
          cols[f * kSumLd + c * kChunkRows + t] = x;
        }
        mbar_arrive(&ready[c]);
      }
    }
    if (t < 7 * F) out[((size_t)g * 8 + 1) * F + t] = 0.0f;
  } else if ((int)threadIdx.x < F) {
    const float4* col = reinterpret_cast<const float4*>(cols + threadIdx.x * kSumLd);
    float acc = 0.0f;
    for (int c = 0; c < kSumChunks; ++c) {
      mbar_wait(&ready[c], 0);
      const float4* chunk = col + c * (kChunkRows / 4);
      float4 a[kSumBatch / 4], b[kSumBatch / 4];
#pragma unroll
      for (int k = 0; k < kSumBatch / 4; ++k) a[k] = chunk[k];
#pragma unroll 2
      for (int j = 0; j < kChunkRows / 4; j += kSumBatch / 4) {
        if (j + kSumBatch / 4 < kChunkRows / 4) {
#pragma unroll
          for (int k = 0; k < kSumBatch / 4; ++k) b[k] = chunk[j + kSumBatch / 4 + k];
        }
#pragma unroll
        for (int k = 0; k < kSumBatch / 4; ++k) {
          acc = __fadd_rn(acc, a[k].x);
          acc = __fadd_rn(acc, a[k].y);
          acc = __fadd_rn(acc, a[k].z);
          acc = __fadd_rn(acc, a[k].w);
        }
#pragma unroll
        for (int k = 0; k < kSumBatch / 4; ++k) a[k] = b[k];
      }
    }
    out[(size_t)g * 8 * F + threadIdx.x] = maybe_round(acc, flags);
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

// STORE_LAST, pass 1: winner[r] = (epoch << 32) | the largest j with
// idx[j] = r, over every winner[r] of an earlier epoch (j < 2^31; grid-
// stride, one index a thread).
__global__ void __launch_bounds__(kThreads)
    store_last_claim(const int32_t* __restrict__ idx, unsigned long long* __restrict__ winner, uint32_t N, uint32_t S,
                     uint32_t epoch) {
  const unsigned long long tag = (unsigned long long)epoch << 32;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < N; j += stride) {
    const uint32_t r = (uint32_t)__ldg(idx + j);
    if (r < S) atomicMax(winner + r, tag | j);
  }
}

constexpr int kSlotIlp = 4;  // vectors a lane of store_last_slots loads before it stores

// STORE_LAST, pass 2: out[s] = rows[j] where winner[s] holds this epoch's j,
// else zeros. A warp takes 32 consecutive slots s0 .. s0 + n - 1 (grid-
// stride over the groups): lane l loads winner[s0 + l]; the group's n rows
// are n T VEC-wide vectors (T = R / VEC), contiguous in out; vector q of
// them is chunk q % T of slot q / T (a shift where T is a power of two),
// whose winner the warp shuffles from lane q / T. A lane loads kSlotIlp
// vectors (32 apart) before it stores them.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    store_last_slots(const float* __restrict__ rows, const unsigned long long* __restrict__ winner,
                     float* __restrict__ out, uint32_t S, int R, int T, int t_shift, uint32_t epoch) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t groups = (S + 31u) / 32u;
  const uint32_t n_warps = (gridDim.x * blockDim.x) >> 5;
  for (uint32_t g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; g < groups; g += n_warps) {
    const uint32_t s0 = g * 32u;
    const uint32_t n = min(32u, S - s0);
    int32_t w = -1;
    if (lane < n) {
      const unsigned long long v = winner[s0 + lane];
      if ((uint32_t)(v >> 32) == epoch) w = (int32_t)(uint32_t)v;
    }
    const uint32_t n_vec = n * (uint32_t)T;
    float* o = out + (size_t)s0 * R;
    for (uint32_t q0 = 0; q0 < n_vec; q0 += 32u * kSlotIlp) {
      float v[kSlotIlp][VEC];
#pragma unroll
      for (int k = 0; k < kSlotIlp; ++k) {
        const uint32_t q = q0 + 32u * k + lane;
        const uint32_t slot = item_row(q, T, t_shift);
        const int32_t ws = __shfl_sync(0xffffffffu, w, (int)(slot & 31u));
        if (q < n_vec && ws >= 0) {
          load_vec<VEC>(rows + (size_t)ws * R + (q - slot * (uint32_t)T) * VEC, v[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kSlotIlp; ++k) {
        const uint32_t q = q0 + 32u * k + lane;
        if (q < n_vec) store_vec<VEC>(o + (size_t)q * VEC, v[k]);
      }
    }
  }
}

constexpr int kDotCols = 128;
constexpr int kDotThreads = 256;

// Samples whose rows a warp of gather_dot_warps has in flight: 64 row
// values (FC = 8: 8 samples, 4: 16), at most the 32 of a group; 4 at a
// run-time F (ops/probe_rows.py: dot_in_flight mirrors it).
template <int FC>
constexpr int kDotInFlight = FC == 0 ? 4 : (64 / FC < 32 ? 64 / FC : 32);

// Columns c0 .. c0 + 3 of output row b as one streaming float4 store
// (evict-first: the output is written once and not read back), zeros where
// the row's index lies outside the table; nothing where b is past the batch.
__device__ __forceinline__ void store_dot_row(float* __restrict__ out, uint32_t b, int c0, const float* a, bool in_batch,
                                              bool in_table) {
  if (!in_batch) return;
  const float4 o = in_table ? make_float4(a[0], a[1], a[2], a[3]) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __stcs(reinterpret_cast<float4*>(out + (size_t)b * kDotCols + c0), o);
}

// out[b, c] = sum over f in order of table[idx[b], f] * w[f, c] (fmaf; zero
// for an index outside [0, S)). A warp takes groups of 32 samples (grid-
// stride); lane l loads the group's index l and owns columns 4l .. 4l + 3.
template <int FC>
__global__ void __launch_bounds__(kDotThreads, 2)
    gather_dot_warps(const float* __restrict__ table, const int32_t* __restrict__ idx, const float* __restrict__ w,
                     float* __restrict__ out, uint32_t B, uint32_t S, int F_rt, int vec) {
  constexpr int U = kDotInFlight<FC>;
  constexpr int NF = FC > 0 ? FC : 1;
  const int F = FC > 0 ? FC : F_rt;
  const uint32_t lane = threadIdx.x & 31u;
  const int c0 = 4 * (int)lane;
  float wr[4 * NF];
  if constexpr (FC > 0) {
#pragma unroll
    for (int f = 0; f < FC; ++f) {
#pragma unroll
      for (int k = 0; k < 4; ++k) wr[4 * f + k] = __ldg(w + f * kDotCols + c0 + k);
    }
  }
  const uint32_t groups = (B + 31u) / 32u;
  const uint32_t n_warps = (gridDim.x * blockDim.x) >> 5;
  uint32_t g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  uint32_t r_next = g < groups && g * 32u + lane < B ? (uint32_t)__ldg(idx + g * 32u + lane) : 0xffffffffu;
  for (; g < groups; g += n_warps) {
    const uint32_t r_own = r_next;
    const uint32_t gn = g + n_warps;
    r_next = gn < groups && gn * 32u + lane < B ? (uint32_t)__ldg(idx + gn * 32u + lane) : 0xffffffffu;
    const uint32_t b0 = g * 32u;
    const uint32_t n = min(32u, B - b0);
    for (uint32_t j0 = 0; j0 < n; j0 += U) {
      uint32_t r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) r[u] = __shfl_sync(0xffffffffu, r_own, (int)j0 + u);
      if constexpr (FC > 0) {
        float v[U * FC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (r[u] < S) {
            load_row<FC>(table, r[u], S, vec, false, v + u * FC);
          } else {
#pragma unroll
            for (int f = 0; f < FC; ++f) v[u * FC + f] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float a[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            a[k] = 0.0f;
#pragma unroll
            for (int f = 0; f < FC; ++f) a[k] = fmaf(v[u * FC + f], wr[4 * f + k], a[k]);
          }
          store_dot_row(out, b0 + j0 + u, c0, a, j0 + u < n, r[u] < S);
        }
      } else {
        float acc[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[u][k] = 0.0f;
        }
        for (int f = 0; f < F; ++f) {
          float wf[4], x[U];
#pragma unroll
          for (int k = 0; k < 4; ++k) wf[k] = __ldg(w + f * kDotCols + c0 + k);
#pragma unroll
          for (int u = 0; u < U; ++u) x[u] = r[u] < S ? __ldg(table + (size_t)r[u] * F + f) : 0.0f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[u][k] = fmaf(x[u], wf[k], acc[u][k]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) store_dot_row(out, b0 + j0 + u, c0, acc[u], j0 + u < n, r[u] < S);
      }
    }
  }
}

// A launch's cudaError_t, cleared from the runtime's last error
// so that a later launch's check does not report it again.
int cleared(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The SHARED instantiation of a plan: VEC, R (1, 2, 4, 8) and the
// rounding at compile time.
template <int VEC, int R>
void* shared_fn_vr(const int32_t* p) {
  return (p[gFlags] & kRoundBf16) ? (void*)gather_rows_shared<VEC, R, true> : (void*)gather_rows_shared<VEC, R, false>;
}

template <int VEC>
void* shared_fn_v(const int32_t* p) {
  switch (p[gRows]) {
    case 1: return shared_fn_vr<VEC, 1>(p);
    case 2: return shared_fn_vr<VEC, 2>(p);
    case 4: return shared_fn_vr<VEC, 4>(p);
    case 8: return shared_fn_vr<VEC, 8>(p);
    default: return nullptr;
  }
}

int launch_shared(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  if (p[gThreads] != kSharedThreads) return (int)cudaErrorInvalidValue;
  void* fn = p[gVec] == 4 ? shared_fn_v<4>(p) : p[gVec] == 2 ? shared_fn_v<2>(p) : shared_fn_v<1>(p);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p[gSmem];
  int err = set_smem(fn, smem);
  if (err) return err;
  uint32_t B = p[gB], S = p[gS];
  int F = p[gF], T = p[gPerRow], ts = p[gPerRowShift], flags = p[gFlags];
  void* args[] = {(void*)&t, (void*)&ix, (void*)&o, &B, &S, &F, &T, &ts, &flags};
  return cleared(cudaLaunchKernel(fn, dim3(p[gGrid]), dim3(kSharedThreads), args, smem, st));
}

template <int VEC>
void* async_fn_v(const int32_t* p) {
  return (p[gFlags] & kRoundBf16) ? (void*)gather_rows_async<VEC, true> : (void*)gather_rows_async<VEC, false>;
}

int launch_async(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  if (p[gThreads] % 32 != 0 || p[gThreads] > 32 * kAsyncWarps || p[gInFlight] < 1) return (int)cudaErrorInvalidValue;
  void* fn = p[gVec] == 4 ? async_fn_v<4>(p) : p[gVec] == 2 ? async_fn_v<2>(p) : async_fn_v<1>(p);
  const size_t smem = (size_t)p[gSmem];
  int err = set_smem(fn, smem);
  if (err) return err;
  uint32_t B = p[gB], S = p[gS], G = p[gInFlight];
  int F = p[gF], T = p[gPerRow], ts = p[gPerRowShift], flags = p[gFlags];
  void* args[] = {(void*)&t, (void*)&ix, (void*)&o, &B, &S, &F, &G, &T, &ts, &flags};
  return cleared(cudaLaunchKernel(fn, dim3(p[gGrid]), dim3(p[gThreads]), args, smem, st));
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

template <int VEC, int PC, bool ROUND>
int launch_planes_pcr(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  const size_t smem = (size_t)p[gSmem];
  const int err = set_smem((const void*)gather_planes<VEC, PC, ROUND>, smem);
  if (err) return err;
  gather_planes<VEC, PC, ROUND><<<p[gGrid], kPlaneThreads, smem, st>>>(t, ix, o, p[gB], p[gS], p[gF], p[gPlanes],
                                                                      p[gRuns], p[gRun]);
  return (int)cudaGetLastError();
}

template <int VEC, int PC>
int launch_planes_pc(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  return (p[gFlags] & kRoundBf16) ? launch_planes_pcr<VEC, PC, true>(p, t, ix, o, st)
                                  : launch_planes_pcr<VEC, PC, false>(p, t, ix, o, st);
}

template <int VEC>
int launch_planes(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  switch (p[gPlanes]) {
    case 8: return launch_planes_pc<VEC, 8>(p, t, ix, o, st);
    case 4: return launch_planes_pc<VEC, 4>(p, t, ix, o, st);
    case 2: return launch_planes_pc<VEC, 2>(p, t, ix, o, st);
    case 1: return launch_planes_pc<VEC, 1>(p, t, ix, o, st);
    default: return launch_planes_pc<VEC, 0>(p, t, ix, o, st);
  }
}

template <int FC>
int launch_tile_sum(dim3 grid, size_t smem, cudaStream_t st, const float* t, const int32_t* ix, float* o, uint32_t S,
                    int F, int vec, int flags) {
  const int err = set_smem((const void*)gather_tile_sum_chunked<FC>, smem);
  if (err) return err;
  gather_tile_sum_chunked<FC><<<grid, kSumThreads, smem, st>>>(t, ix, o, S, F, vec, flags);
  return (int)cudaGetLastError();
}

template <int FC>
void launch_dot(const int32_t* p, const float* t, const int32_t* ix, const float* w, float* o, cudaStream_t st) {
  gather_dot_warps<FC><<<p[dGrid], kDotThreads, 0, st>>>(t, ix, w, o, p[dB], p[dS], p[dF], p[dVec]);
}

// The WINDOW instantiation of a plan: VEC, F (1, 2, 4, 8 or 0: at run
// time), the alignment and the rounding at compile time.
template <int VEC, int FC, bool AL, bool RD>
int launch_windows_r(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  const uint32_t n_vec = (uint32_t)((uint64_t)(uint32_t)p[gB] * (uint32_t)p[gF] / VEC);
  gather_windows<VEC, FC, AL, RD><<<p[gGrid], kThreads, 0, st>>>(t, ix, o, n_vec, p[gS], p[gF]);
  return (int)cudaGetLastError();
}

template <int VEC, int FC>
int launch_windows_f(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  if constexpr (FC % VEC != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    const bool al = p[gFlags] & kAligned, rd = p[gFlags] & kRoundBf16;
    if (al) {
      return rd ? launch_windows_r<VEC, FC, true, true>(p, t, ix, o, st)
                : launch_windows_r<VEC, FC, true, false>(p, t, ix, o, st);
    }
    return rd ? launch_windows_r<VEC, FC, false, true>(p, t, ix, o, st)
              : launch_windows_r<VEC, FC, false, false>(p, t, ix, o, st);
  }
}

template <int VEC>
int launch_windows_v(const int32_t* p, const float* t, const int32_t* ix, float* o, cudaStream_t st) {
  switch (p[gF]) {
    case 1: return launch_windows_f<VEC, 1>(p, t, ix, o, st);
    case 2: return launch_windows_f<VEC, 2>(p, t, ix, o, st);
    case 4: return launch_windows_f<VEC, 4>(p, t, ix, o, st);
    case 8: return launch_windows_f<VEC, 8>(p, t, ix, o, st);
    default: return launch_windows_f<VEC, 0>(p, t, ix, o, st);
  }
}

int launch_windows(const int32_t* p, const float* t, const float* t2, const int32_t* ix, float* o, cudaStream_t st) {
  const int F = p[gF], vec = p[gVec];
  if (p[gMode] != kWindow || (p[gFlags] & (kTransposed | kFeatureMajor)) || t2 != nullptr ||
      p[gThreads] != kThreads || p[gRows] != kWindowVectors || F <= 0 || (vec != 1 && vec != 2 && vec != 4) ||
      F % vec != 0 ||
      (uint64_t)(uint32_t)p[gB] * (uint32_t)F >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  if (vec == 4) return launch_windows_v<4>(p, t, ix, o, st);
  if (vec == 2) return launch_windows_v<2>(p, t, ix, o, st);
  return launch_windows_v<1>(p, t, ix, o, st);
}

template <int VEC, bool RD>
int launch_copy_r(const int32_t* p, const float* t, float* o, cudaStream_t st) {
  const uint32_t n_tiles = (uint32_t)p[gB] >> kTileShift, nt = p[gPerRow];
  copy_tiles<VEC, RD><<<p[gGrid], kThreads, 0, st>>>(t, o, n_tiles, nt, p[gRuns]);
  return (int)cudaGetLastError();
}

int launch_copy(const int32_t* p, const float* t, const float* t2, float* o, cudaStream_t st) {
  const int vec = p[gVec];
  const uint64_t nt = (uint64_t)kTile * (uint32_t)p[gF] / (vec > 0 ? vec : 1);
  if (p[gMode] != kCopy || (p[gFlags] & (kTransposed | kFeatureMajor)) || t2 != nullptr ||
      p[gThreads] != kThreads || p[gTileShift] != kTileShift || (p[gB] & (kTile - 1)) != 0 ||
      (vec != 1 && vec != 2 && vec != 4) || (uint64_t)(uint32_t)p[gPerRow] != nt ||
      p[gRuns] < 1 || ((uint64_t)p[gGrid] * kThreads) % (uint32_t)p[gRuns] != 0 ||
      (uint64_t)(uint32_t)p[gB] * (uint32_t)p[gF] >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  const bool rd = p[gFlags] & kRoundBf16;
  if (vec == 4) return rd ? launch_copy_r<4, true>(p, t, o, st) : launch_copy_r<4, false>(p, t, o, st);
  if (vec == 2) return rd ? launch_copy_r<2, true>(p, t, o, st) : launch_copy_r<2, false>(p, t, o, st);
  return rd ? launch_copy_r<1, true>(p, t, o, st) : launch_copy_r<1, false>(p, t, o, st);
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
  switch (p[gRoute]) {
    case kRouteWindow:
      return launch_windows(p, t, t2, ix, o, st);
    case kRouteCopy:
      return launch_copy(p, t, t2, o, st);
    case kRouteShared:
      return mode == kRow && source == kShared ? launch_shared(p, t, ix, o, st) : (int)cudaErrorInvalidValue;
    case kRouteAsync:
      return mode == kRow && source == kAsync ? launch_async(p, t, ix, o, st) : (int)cudaErrorInvalidValue;
    case kRoutePlanes:  // ROW of a transposed table into feature-major tiles
      if (mode != kRow || p[gPlanes] <= 0 || p[gThreads] != kPlaneThreads || t2 != nullptr || ts != kTileShift)
        return (int)cudaErrorInvalidValue;
      if (vec == 4) return launch_planes<4>(p, t, ix, o, st);
      if (vec == 2) return launch_planes<2>(p, t, ix, o, st);
      return launch_planes<1>(p, t, ix, o, st);
    case kRouteTileSum:
      if (mode != kTileSum || p[gChunks] != kSumChunks || p[gThreads] != kSumThreads || (1 << ts) != kTile)
        return (int)cudaErrorInvalidValue;
      if (F == 8) return launch_tile_sum<8>(grid, smem, st, t, ix, o, S, F, vec, flags);
      if (F == 4) return launch_tile_sum<4>(grid, smem, st, t, ix, o, S, F, vec, flags);
      if (F == 2) return launch_tile_sum<2>(grid, smem, st, t, ix, o, S, F, vec, flags);
      if (F == 1) return launch_tile_sum<1>(grid, smem, st, t, ix, o, S, F, vec, flags);
      return launch_tile_sum<0>(grid, smem, st, t, ix, o, S, F, vec, flags);
    case kRouteLane:
      if (mode != kLane) return (int)cudaErrorInvalidValue;
      if (vec == 4) {
        gather_lanes<true><<<grid, block, 0, st>>>(t, ix, o, B, S, F, p[gPerRow], p[gPerRowShift], flags, ts);
      } else {
        gather_lanes<false><<<grid, block, 0, st>>>(t, ix, o, B, S, F, p[gPerRow], p[gPerRowShift], flags, ts);
      }
      break;
    case kRouteL2: {  // ROW, WINDOW, COPY from L2
      if (source != kL2 || (mode != kRow && mode != kWindow && mode != kCopy)) return (int)cudaErrorInvalidValue;
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
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ADD: sets `out` (S, R) to zeros, then adds. STORE_LAST: writes every row
// of `out`; `winner` (S uint64) holds no entry of an epoch `epoch` or later.
extern "C" int tcnn_probe_scatter(const void* idx, const void* rows, void* out, void* winner, const int32_t* plan,
                                  void* stream, uint32_t epoch) {
  const int32_t* p = plan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t N = p[sN], S = p[sS];
  const int R = p[sR], vec = p[sVec], T = p[sPerRow], ts = p[sPerRowShift];
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* rw = static_cast<const float*>(rows);
  float* o = static_cast<float*>(out);
  const dim3 grid(p[sGrid]), block(p[sThreads]);
  if (p[sOp] == kStoreLast) {
    if (S == 0 || R == 0 || p[sGrid] <= 0) return 0;
    unsigned long long* win = static_cast<unsigned long long*>(winner);
    if (N > 0 && p[sClaimGrid] > 0) store_last_claim<<<p[sClaimGrid], kThreads, 0, st>>>(ix, win, N, S, epoch);
    if (vec == 4) {
      store_last_slots<4><<<grid, block, 0, st>>>(rw, win, o, S, R, T, ts, epoch);
    } else if (vec == 2) {
      store_last_slots<2><<<grid, block, 0, st>>>(rw, win, o, S, R, T, ts, epoch);
    } else {
      store_last_slots<1><<<grid, block, 0, st>>>(rw, win, o, S, R, T, ts, epoch);
    }
    return (int)cudaGetLastError();
  }
  int err = (int)cudaMemsetAsync(o, 0, (size_t)S * R * sizeof(float), st);
  if (err) return err;
  if (N == 0 || p[sGrid] <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)p[sSmem];
  if (p[sPrivate] > 0) {
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

// out (B, 128) = table (S, F)[idx] @ w (F, 128); `plan` is the host plan's
// int32 array (DotArg above).
extern "C" int tcnn_probe_gather_dot(const void* table, const void* idx, const void* w, void* out, const int32_t* plan,
                                     void* stream) {
  const int32_t* p = plan;
  if (p[dB] <= 0 || p[dGrid] <= 0) return 0;
  if (p[dThreads] != kDotThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* wp = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  switch (p[dF]) {
    case 8: launch_dot<8>(p, t, ix, wp, o, st); break;
    case 4: launch_dot<4>(p, t, ix, wp, o, st); break;
    case 2: launch_dot<2>(p, t, ix, wp, o, st); break;
    case 1: launch_dot<1>(p, t, ix, wp, o, st); break;
    default: launch_dot<0>(p, t, ix, wp, o, st);
  }
  return (int)cudaGetLastError();
}

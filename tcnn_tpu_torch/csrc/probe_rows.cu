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
// random access allows. Scatter-adds add one atomic per element, and
// collide where many rows hit one slot.
//
// Design, one entry point per probe kernel:
// - tcnn_probe_gather: one thread per row (UNROLL = 8: eight independent
//   rows a thread, eight loads in flight), reading the table from
//   L2 (__ldg), from SHARED memory (each block stages the whole table with
//   vector loads, then gathers; persistent blocks, one per SM), or
//   ASYNC (blocks of in_flight threads: each copies one row with cp.async
//   into a shared ring, all wait, then store: the TPU probe's "start G
//   DMAs, wait G, store"). The other modes (per-lane gather, 8-row windows,
//   the tile sum in order, the static copy) read through L2.
// - tcnn_probe_scatter: fp32 atomicAdd per element into the result, or
//   into a per-block shared copy of the whole table that is flushed with
//   one atomic per touched entry; STORE_LAST claims each slot for the
//   largest row index (atomicMax) and then writes the winners' rows.
// - tcnn_probe_gather_dot: one thread per output element, an in-order
//   chain of fmaf over the F gathered values (F = 8: no tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kRow = 0, kLane = 1, kWindow = 2, kTileSum = 3, kCopy = 4 };
enum Source { kL2 = 0, kShared = 1, kAsync = 2 };
enum Flags { kRoundBf16 = 1, kFeatureMajor = 2, kTransposed = 4, kAligned = 8 };
enum Op { kAdd = 0, kStoreLast = 1 };
enum Acc { kGlobalAcc = 0, kSharedAcc = 1 };

constexpr int kThreads = 256;

__device__ __forceinline__ float maybe_round(float v, int flags) {
  return (flags & kRoundBf16) ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Where element f of output row b goes: row-major (B, F) or feature-major
// (B / tile, F, tile).
__device__ __forceinline__ int64_t out_at(int64_t b, int f, int F, int tile, int flags) {
  return (flags & kFeatureMajor) ? ((b / tile) * F + f) * tile + b % tile : b * F + f;
}

// Element f of table row r: row-major (S, F) or transposed (F, S); zero
// outside [0, S).
__device__ __forceinline__ float table_at(const float* __restrict__ t, int64_t r, int f, int64_t S, int F,
                                          int flags) {
  if (r < 0 || r >= S) return 0.0f;
  return (flags & kTransposed) ? __ldg(t + (int64_t)f * S + r) : __ldg(t + r * F + f);
}

// ROW from L2: UNROLL rows a thread, their index loads and then their row
// loads issued before any store. Odd rows read table2 when it is given.
template <int UNROLL>
__global__ void gather_rows_l2(const float* __restrict__ table, const float* __restrict__ table2,
                               const int32_t* __restrict__ idx, float* __restrict__ out, int64_t B, int64_t S,
                               int F, int flags, int tile) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t b0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b0 < B; b0 += stride * UNROLL) {
    int32_t r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t b = b0 + u * stride;
      r[u] = b < B ? __ldg(idx + b) : -1;
    }
    for (int f = 0; f < F; ++f) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t b = b0 + u * stride;
        const float* t = (table2 != nullptr && (b & 1)) ? table2 : table;
        v[u] = b < B ? table_at(t, r[u], f, S, F, flags) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t b = b0 + u * stride;
        if (b < B) out[out_at(b, f, F, tile, flags)] = maybe_round(v[u], flags);
      }
    }
  }
}

// ROW from shared memory: the block stages the whole (S, F) table (S * F * 4 <=
// 227 KB, checked by the wrapper), then its threads gather from it.
__global__ void gather_rows_shared(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int64_t B, int64_t S, int F, int flags, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int64_t n = S * F;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(table);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int64_t i = threadIdx.x; i < n / 4; i += blockDim.x) dst[i] = __ldg(src + i);
  } else {
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) smem[i] = __ldg(table + i);
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < B; b += stride) {
    const int32_t r = __ldg(idx + b);
    const bool ok = r >= 0 && r < S;
    for (int f = 0; f < F; ++f)
      out[out_at(b, f, F, tile, flags)] = maybe_round(ok ? smem[(int64_t)r * F + f] : 0.0f, flags);
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
// ring, the block waits for all of them, and each thread stores its row.
template <int VEC>
__global__ void gather_rows_async(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                  float* __restrict__ out, int64_t B, int64_t S, int F, int flags, int tile) {
  extern __shared__ __align__(16) float ring[];
  float* slot = ring + (int64_t)threadIdx.x * F;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b - threadIdx.x < B; b += stride) {
    const int32_t r = b < B ? __ldg(idx + b) : -1;
    const bool ok = r >= 0 && r < S;
    if (ok) {
      const float* src = table + (int64_t)r * F;
      for (int f = 0; f < F; f += VEC) cp_async<4 * VEC>(slot + f, src + f);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (b < B)
      for (int f = 0; f < F; ++f) out[out_at(b, f, F, tile, flags)] = maybe_round(ok ? slot[f] : 0.0f, flags);
    __syncthreads();
  }
}

// Elementwise modes, one thread per output element.
__global__ void gather_elementwise(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int64_t B, int64_t S, int F, int mode, int flags,
                                   int tile) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * F) return;
  const int64_t b = i / F;
  const int f = (int)(i % F);
  int64_t r;
  if (mode == kLane) {
    r = __ldg(idx + i);
  } else if (mode == kWindow) {
    int32_t a = __ldg(idx + (b & ~(int64_t)7));
    if (flags & kAligned) a &= ~7;
    r = (int64_t)a + (b & 7);
  } else {  // kCopy
    r = b % tile;
  }
  out[out_at(b, f, F, tile, flags)] = maybe_round(table_at(table, r, f, S, F, flags & kTransposed), flags);
}

// TILE_SUM: one block per tile; its threads gather the tile's rows into
// shared memory, then thread f sums feature f over the tile in order (the
// probe's loop order, so the sum is bit-exact against it) into row 8g.
__global__ void gather_tile_sum(const float* __restrict__ table, const int32_t* __restrict__ idx,
                                float* __restrict__ out, int64_t S, int F, int flags, int tile) {
  extern __shared__ __align__(16) float rows[];
  const int64_t g = blockIdx.x;
  for (int64_t i = threadIdx.x; i < (int64_t)tile * F; i += blockDim.x) {
    const int64_t j = i / F;
    rows[i] = table_at(table, __ldg(idx + g * tile + j), (int)(i % F), S, F, flags & kTransposed);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < tile; ++j) acc = __fadd_rn(acc, rows[(int64_t)j * F + f]);
    out[g * 8 * F + f] = maybe_round(acc, flags);
  }
}

__global__ void scatter_add_global(const int32_t* __restrict__ idx, const float* __restrict__ rows,
                                   float* __restrict__ out, int64_t N, int64_t S, int R) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * R) return;
  const int32_t r = __ldg(idx + i / R);
  if (r < 0 || r >= S) return;
  atomicAdd(out + (int64_t)r * R + i % R, __ldg(rows + i));
}

// ADD into a shared copy of the whole (S, R) table, then one global atomic
// per touched entry.
__global__ void scatter_add_shared(const int32_t* __restrict__ idx, const float* __restrict__ rows,
                                   float* __restrict__ out, int64_t N, int64_t S, int R) {
  extern __shared__ __align__(16) float acc[];
  const int64_t n = S * R;
  for (int64_t e = threadIdx.x; e < n; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < N * R; i += stride) {
    const int32_t r = __ldg(idx + i / R);
    if (r >= 0 && r < S) atomicAdd(acc + (int64_t)r * R + i % R, __ldg(rows + i));
  }
  __syncthreads();
  for (int64_t e = threadIdx.x; e < n; e += blockDim.x)
    if (acc[e] != 0.0f) atomicAdd(out + e, acc[e]);
}

__global__ void store_last_claim(const int32_t* __restrict__ idx, int32_t* __restrict__ winner, int64_t N,
                                 int64_t S) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int32_t r = __ldg(idx + j);
  if (r >= 0 && r < S) atomicMax(winner + r, (int32_t)j);
}

__global__ void store_last_write(const int32_t* __restrict__ idx, const float* __restrict__ rows,
                                 const int32_t* __restrict__ winner, float* __restrict__ out, int64_t N,
                                 int64_t S, int R) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * R) return;
  const int64_t j = i / R;
  const int32_t r = __ldg(idx + j);
  if (r >= 0 && r < S && winner[r] == (int32_t)j) out[(int64_t)r * R + i % R] = __ldg(rows + i);
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

}  // namespace

// Each entry point returns the cudaError_t of its launches (0 on success),
// launches on `stream` and does not synchronise. Arguments are checked by
// the wrappers in tcnn_tpu_torch/ops/probe_rows.py.
extern "C" int tcnn_probe_gather(const void* table, const void* table2, const void* idx, void* out, int64_t B,
                                 int64_t S, int F, int mode, int source, int unroll, int flags, int tile,
                                 int in_flight, int n_sms, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float* t2 = static_cast<const float*>(table2);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  if (mode == kRow && source == kShared) {
    const size_t bytes = (size_t)S * F * sizeof(float);
    const int err = set_smem((const void*)gather_rows_shared, bytes);
    if (err) return err;
    gather_rows_shared<<<n_sms, 1024, bytes, st>>>(t, ix, o, B, S, F, flags, tile);
  } else if (mode == kRow && source == kAsync) {
    const size_t bytes = (size_t)in_flight * F * sizeof(float);
    const bool v16 = (F % 4) == 0 && (reinterpret_cast<uintptr_t>(t) & 15) == 0;
    const bool v8 = (F % 2) == 0 && (reinterpret_cast<uintptr_t>(t) & 7) == 0;
    const void* fn = v16 ? (const void*)gather_rows_async<4> : v8 ? (const void*)gather_rows_async<2>
                                                                  : (const void*)gather_rows_async<1>;
    const int err = set_smem(fn, bytes);
    if (err) return err;
    const unsigned grid = blocks_for(B, in_flight);
    if (v16) {
      gather_rows_async<4><<<grid, in_flight, bytes, st>>>(t, ix, o, B, S, F, flags, tile);
    } else if (v8) {
      gather_rows_async<2><<<grid, in_flight, bytes, st>>>(t, ix, o, B, S, F, flags, tile);
    } else {
      gather_rows_async<1><<<grid, in_flight, bytes, st>>>(t, ix, o, B, S, F, flags, tile);
    }
  } else if (mode == kRow) {
    if (unroll == 8) {
      gather_rows_l2<8><<<blocks_for(B, kThreads * 8), kThreads, 0, st>>>(t, t2, ix, o, B, S, F, flags, tile);
    } else {
      gather_rows_l2<1><<<blocks_for(B, kThreads), kThreads, 0, st>>>(t, t2, ix, o, B, S, F, flags, tile);
    }
  } else if (mode == kTileSum) {
    const size_t bytes = (size_t)tile * F * sizeof(float);
    const int err = set_smem((const void*)gather_tile_sum, bytes);
    if (err) return err;
    gather_tile_sum<<<(unsigned)(B / tile), kThreads, bytes, st>>>(t, ix, o, S, F, flags, tile);
  } else {
    gather_elementwise<<<blocks_for(B * F, kThreads), kThreads, 0, st>>>(t, ix, o, B, S, F, mode, flags, tile);
  }
  return (int)cudaGetLastError();
}

// `out` is zeroed by the wrapper; `winner` (S int32 set to -1) is used by
// STORE_LAST only.
extern "C" int tcnn_probe_scatter(const void* idx, const void* rows, void* out, void* winner, int64_t N,
                                  int64_t S, int R, int op, int acc, int n_sms, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* rw = static_cast<const float*>(rows);
  float* o = static_cast<float*>(out);
  if (op == kStoreLast) {
    int32_t* win = static_cast<int32_t*>(winner);
    store_last_claim<<<blocks_for(N, kThreads), kThreads, 0, st>>>(ix, win, N, S);
    store_last_write<<<blocks_for(N * R, kThreads), kThreads, 0, st>>>(ix, rw, win, o, N, S, R);
  } else if (acc == kSharedAcc) {
    const size_t bytes = (size_t)S * R * sizeof(float);
    const int err = set_smem((const void*)scatter_add_shared, bytes);
    if (err) return err;
    // One block per SM at most, and no more blocks than rows per table
    // entry: each block flushes up to S * R atomics.
    int64_t grid = N / (S > 0 ? S : 1);
    grid = grid < 1 ? 1 : (grid > n_sms ? n_sms : grid);
    scatter_add_shared<<<(unsigned)grid, 1024, bytes, st>>>(ix, rw, o, N, S, R);
  } else {
    scatter_add_global<<<blocks_for(N * R, kThreads), kThreads, 0, st>>>(ix, rw, o, N, S, R);
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

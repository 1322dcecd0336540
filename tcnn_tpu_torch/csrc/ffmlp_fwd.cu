// Fully fused MLP forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel tcnn_tpu/ops/ffmlp.py:mlp_forward_pallas
// (bodies _mlp_kernel and _mlp_kernel_cf), itself the TPU form of the
// reference's kernel_mlp_fused (src/fully_fused_mlp.cu:499-557).
//
// What it computes: for a tile of rows, every layer z = h @ W^T with bf16
// operands and fp32 accumulation, the activation in fp32, then one round to
// bf16 (round to nearest) before the next layer; the last layer uses the
// output activation. Weights arrive as one bf16 buffer of row-major
// (fan_out, fan_in) matrices in flat-parameter order.
//
// What bounds it on this card: a row costs 2 * sum(fan_in * fan_out) flops
// against 2 * (in + out) bytes of device memory: 14,336 flops per 96 bytes
// (149 flop/byte) at the flagship's 32 -> 64 -> 64 -> 16, below the bf16
// ridge (~295), so HBM bounds it (~7.5 us for 2^18 rows).
//
// Design (host plan: tcnn_tpu_torch/ops/ffmlp.py:forward_plan):
// - Persistent blocks: about as many as the card holds at once, each
//   staging every weight matrix into shared memory once, with cp.async, in
//   rows padded by 8 bf16 so that ldmatrix reads them without bank
//   conflicts (unpadded where the padding would not fit). Each warp then
//   walks its own row tiles, tiles_per_warp apart.
// - A warp owns 16 * MT rows (MT = 2 at widths <= 64, 1 at 128, where 64
//   fp32 accumulators a row tile already fill the registers). Every layer
//   is mma.sync.m16n8k16 (bf16 in, fp32 accumulate), B fragments by
//   ldmatrix from the staged weights. The fp32 C fragment of a layer maps
//   one-to-one onto the A fragment of the next (a lane holds rows g and
//   g + 8, columns 2q and 2q + 1), so after the activation and one
//   __floats2bfloat162_rn the output is the next layer's input without
//   touching shared memory.
// - Input: the next tile's x rows are prefetched with cp.async into a
//   second buffer (padded rows) while the warp computes the current one;
//   rows past the batch read as zeros.
// - Output: each 16-column chunk of the last layer is staged in shared
//   memory and written 16 bytes a lane, coalesced; rows past the batch are
//   not written.
// Products of bf16 values are exact in fp32; only the order of the fp32
// sums differs from the plain chain. No atomics: the same inputs give the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"

using tcnn_act::activate;

namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kMaxWarps = 8;
constexpr int kOutStride = 24;  // bf16 a row of the output staging tile (16 + 8 pad)
constexpr int kMaxDevices = 64;

// Layout must match tcnn_tpu_torch/ops/ffmlp.py:ForwardPlan.FIELDS.
struct Plan {
  int32_t blocks, warps, rows_per_warp, tiles_per_warp, smem_bytes, w_pad, x_bufs, weight_bytes, warp_bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b for one m16n8k16 tile: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Ends a k step of a layer, so that ptxas loads the weight fragments of one
// k step at a time: without it the 64-wide, 32-row instantiation spilled (8
// bytes at 128 registers; PERF.md §6).
__device__ __forceinline__ void k_fence() { __syncwarp(); }

// Two fp32 values rounded to nearest bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The activation over a register array; one branch for the whole array.
template <int N>
__device__ __forceinline__ void activate_all(float (&v)[N], int act) {
#define TCNN_ACT_CASE(k)                                 \
  case k:                                                \
    _Pragma("unroll") for (int i = 0; i < N; ++i) v[i] = activate(v[i], k); \
    break;
  switch (act) {
    TCNN_ACT_CASE(1)
    TCNN_ACT_CASE(2)
    TCNN_ACT_CASE(3)
    TCNN_ACT_CASE(4)
    TCNN_ACT_CASE(5)
    TCNN_ACT_CASE(6)
    TCNN_ACT_CASE(7)
    TCNN_ACT_CASE(8)
    TCNN_ACT_CASE(9)
    default: break;  // 0: None
  }
#undef TCNN_ACT_CASE
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* weights;
  __nv_bfloat16* out;
  int batch, in_w, n_hidden, out_w, act, out_act;
  int n_tiles, w_pad, x_bufs, weight_bytes, warp_bytes;
};

// Lane offsets of the ldmatrix.x4 row addresses. A (16 x 16 of the
// activations): matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7,
// k 8-15), (rows 8-15, k 8-15) -> a0..a3. B (16 output rows n of W, 16 k):
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) ->
// b0, b1 of n tile 0, then of n tile 1.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

// Issues the cp.async copies of one tile's x rows into a padded buffer.
template <int MT>
__device__ __forceinline__ void load_x(const Args& p, int tile, uint32_t buf, int lane) {
  constexpr int rows = 16 * MT;
  const int chunks = p.in_w / 8;
  const int stride = p.in_w + 8;
  const int row0 = tile * rows;
  for (int i = lane; i < rows * chunks; i += 32) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const bool in = row0 + r < p.batch;
    const __nv_bfloat16* src = p.x + (in ? (size_t)(row0 + r) * p.in_w + c * 8 : 0);
    cp_async16(buf + (uint32_t)(r * stride + c * 8) * 2, src, in ? 16 : 0);
  }
}

// The output activation on one 16-column chunk of the last layer, rounded,
// staged in shared memory and written 16 bytes a lane.
template <int MT>
__device__ __forceinline__ void store_chunk(const Args& p, float (&acc)[MT * 8], int row0, int chunk,
                                            __nv_bfloat16* stage, int lane) {
  activate_all(acc, p.out_act);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* c = acc + (mt * 2 + j) * 4;
      __nv_bfloat16* s = stage + (mt * 16 + g) * kOutStride + j * 8 + 2 * q;
      *reinterpret_cast<uint32_t*>(s) = pack_bf16(c[0], c[1]);
      *reinterpret_cast<uint32_t*>(s + 8 * kOutStride) = pack_bf16(c[2], c[3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * MT * 2; i += 32) {
    const int r = i >> 1, half = i & 1;
    if (row0 + r < p.batch) {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + r * kOutStride + half * 8);
      *reinterpret_cast<uint4*>(p.out + (size_t)(row0 + r) * p.out_w + chunk * 16 + half * 8) = v;
    }
  }
  __syncwarp();
}

// Activation and round of one group of NG n tiles of a layer (fp32 C
// fragments) into the next layer's bf16 A fragments: k tile kt of the next
// layer takes n tiles 2kt and 2kt + 1, so group g fills k tiles g * NG / 2
// onwards of the layer's NT / 2.
template <int MT, int NG, int NT>
__device__ __forceinline__ void pack_group(float (&acc)[MT * NG * 4], uint32_t (&an)[MT * NT / 2 * 4], int g,
                                           int act) {
  activate_all(acc, act);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kk = 0; kk < NG / 2; ++kk) {
      const float* c0 = acc + (mt * NG + 2 * kk) * 4;
      const float* c1 = c0 + 4;
      uint32_t* r = an + (mt * (NT / 2) + g * (NG / 2) + kk) * 4;
      r[0] = pack_bf16(c0[0], c0[1]);
      r[1] = pack_bf16(c0[2], c0[3]);
      r[2] = pack_bf16(c1[0], c1[1]);
      r[3] = pack_bf16(c1[2], c1[3]);
    }
  }
}

// acc (MT m tiles x 2 n tiles) += a * B, B the 16 weight rows at b_addr.
template <int MT>
__device__ __forceinline__ void mma_pair(float* acc, int acc_stride, const uint32_t* a, int a_stride,
                                         uint32_t b_addr) {
  uint32_t b[4];
  ldmatrix_x4(b, b_addr);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const uint32_t(&am)[4] = *reinterpret_cast<const uint32_t(*)[4]>(a + mt * a_stride);
    mma(*reinterpret_cast<float(*)[4]>(acc + mt * acc_stride), am, b[0], b[1]);
    mma(*reinterpret_cast<float(*)[4]>(acc + mt * acc_stride + 4), am, b[2], b[3]);
  }
}

// Where a lane's ldmatrix rows start, and the warp's tile.
struct Lanes {
  int ar, ac, br, bc;
};

// Layer 0: the x tile (shared memory, in_w / 16 k tiles) times W0 (NT n
// tiles) into the A fragments an, NG n tiles at a time.
template <int MT, int NT, int NG>
__device__ __forceinline__ void layer_from_x(uint32_t xs, int x_stride, int k_tiles, uint32_t w_off, int w_stride,
                                             const Lanes& ln, uint32_t (&an)[MT * NT / 2 * 4], int act) {
#pragma unroll
  for (int g = 0; g < NT / NG; ++g) {
    float acc[MT * NG * 4];
#pragma unroll
    for (int i = 0; i < MT * NG * 4; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      uint32_t xa[MT * 4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(*reinterpret_cast<uint32_t(*)[4]>(xa + mt * 4),
                    xs + (uint32_t)((mt * 16 + ln.ar) * x_stride + kt * 16 + ln.ac) * 2);
#pragma unroll
      for (int np = 0; np < NG / 2; ++np)
        mma_pair<MT>(acc + 2 * np * 4, NG * 4, xa, 4,
                     w_off + (uint32_t)((g * NG * 8 + np * 16 + ln.br) * w_stride + kt * 16 + ln.bc) * 2);
      k_fence();
    }
    pack_group<MT, NG, NT>(acc, an, g, act);
  }
}

// A hidden layer: the A fragments a (KT k tiles) times W (NT n tiles) into
// an, NG n tiles at a time.
template <int MT, int KT, int NT, int NG>
__device__ __forceinline__ void layer_from_regs(const uint32_t (&a)[MT * KT * 4], uint32_t w_off, int w_stride,
                                                const Lanes& ln, uint32_t (&an)[MT * NT / 2 * 4], int act) {
#pragma unroll
  for (int g = 0; g < NT / NG; ++g) {
    float acc[MT * NG * 4];
#pragma unroll
    for (int i = 0; i < MT * NG * 4; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int np = 0; np < NG / 2; ++np)
        mma_pair<MT>(acc + 2 * np * 4, NG * 4, a + kt * 4, KT * 4,
                     w_off + (uint32_t)((g * NG * 8 + np * 16 + ln.br) * w_stride + kt * 16 + ln.bc) * 2);
      k_fence();
    }
    pack_group<MT, NG, NT>(acc, an, g, act);
  }
}

// W: hidden width (16, 32, 64, 128); MT: m16 tiles a warp. With
// n_hidden == 0 (launched as W = 16) the one layer reads x directly. Each
// layer is computed NG n tiles (8 * NG columns) at a time, so that the
// accumulators of one group, not of the whole layer, are live beside the
// layer's input and output fragments.
template <int W, int MT>
__global__ void __launch_bounds__(32 * kMaxWarps, W == 128 ? 1 : 2) ffmlp_forward_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NT = W / 8;   // n tiles of a hidden layer
  constexpr int KT = W / 16;  // k tiles of a layer that reads a hidden layer
  constexpr int NG = W == 128 ? 8 : NT > 4 ? 4 : NT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_layers = p.n_hidden + 1;

  // Stage every weight matrix, rows padded by w_pad bf16.
  {
    const __nv_bfloat16* src = p.weights;
    uint32_t dst = smem_u32(smem);
    for (int l = 0; l < n_layers; ++l) {
      const int fan_in = l == 0 ? p.in_w : W;
      const int fan_out = l == n_layers - 1 ? p.out_w : W;
      const int chunks = fan_in / 8;
      const int stride = fan_in + p.w_pad;
      for (int i = threadIdx.x; i < fan_out * chunks; i += blockDim.x) {
        const int r = i / chunks;
        const int c = i - r * chunks;
        cp_async16(dst + (uint32_t)(r * stride + c * 8) * 2, src + (size_t)r * fan_in + c * 8, 16);
      }
      src += (size_t)fan_out * fan_in;
      dst += (uint32_t)(fan_out * stride) * 2;
    }
  }

  unsigned char* wp = smem + p.weight_bytes + warp * p.warp_bytes;
  const int x_tile_bytes = 16 * MT * (p.in_w + 8) * 2;
  const uint32_t x_buf0 = smem_u32(wp);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(wp + p.x_bufs * x_tile_bytes);
  const int stride = gridDim.x * warps;
  int tile = blockIdx.x * warps + warp;
  if (tile < p.n_tiles) load_x<MT>(p, tile, x_buf0, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tile >= p.n_tiles) return;

  const uint32_t w_base = smem_u32(smem);
  const Lanes ln{a_row(lane), a_col(lane), b_row(lane), b_col(lane)};
  const int x_stride = p.in_w + 8;
  int buf = 0;
  for (; tile < p.n_tiles; tile += stride) {
    const int next = tile + stride;
    if (p.x_bufs == 2) {
      if (next < p.n_tiles) load_x<MT>(p, next, x_buf0 + (buf ^ 1) * x_tile_bytes, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const uint32_t xs = x_buf0 + buf * x_tile_bytes;
    const int row0 = tile * 16 * MT;

    if (p.n_hidden == 0) {
      // One layer, x -> out, 16 output columns at a time.
      const int w_stride = p.in_w + p.w_pad;
      for (int chunk = 0; chunk < p.out_w / 16; ++chunk) {
        float acc[MT * 8];
#pragma unroll
        for (int i = 0; i < MT * 8; ++i) acc[i] = 0.0f;
        for (int kt = 0; kt < p.in_w / 16; ++kt) {
          uint32_t xa[MT * 4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(*reinterpret_cast<uint32_t(*)[4]>(xa + mt * 4),
                        xs + (uint32_t)((mt * 16 + ln.ar) * x_stride + kt * 16 + ln.ac) * 2);
          mma_pair<MT>(acc, 8, xa, 4, w_base + (uint32_t)((chunk * 16 + ln.br) * w_stride + kt * 16 + ln.bc) * 2);
          k_fence();
        }
        store_chunk<MT>(p, acc, row0, chunk, stage, lane);
      }
    } else {
      uint32_t a[MT * KT * 4];
      layer_from_x<MT, NT, NG>(xs, x_stride, p.in_w / 16, w_base, p.in_w + p.w_pad, ln, a, p.act);
      uint32_t w_off = w_base + (uint32_t)(W * (p.in_w + p.w_pad)) * 2;
      const int hs = W + p.w_pad;
      for (int l = 1; l < p.n_hidden; ++l) {
        uint32_t an[MT * KT * 4];
        layer_from_regs<MT, KT, NT, NG>(a, w_off, hs, ln, an, p.act);
#pragma unroll
        for (int i = 0; i < MT * KT * 4; ++i) a[i] = an[i];
        w_off += (uint32_t)(W * hs) * 2;
      }
      // Output layer: W -> out_w, 16 columns at a time.
      for (int chunk = 0; chunk < p.out_w / 16; ++chunk) {
        float oc[MT * 8];
#pragma unroll
        for (int i = 0; i < MT * 8; ++i) oc[i] = 0.0f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          mma_pair<MT>(oc, 8, a + kt * 4, KT * 4, w_off + (uint32_t)((chunk * 16 + ln.br) * hs + kt * 16 + ln.bc) * 2);
          k_fence();
        }
        store_chunk<MT>(p, oc, row0, chunk, stage, lane);
      }
    }

    __syncwarp();
    if (p.x_bufs == 2) {
      buf ^= 1;
    } else if (next < p.n_tiles) {
      load_x<MT>(p, next, x_buf0, lane);
      cp_async_commit();
    }
  }
}

using KernelFn = void (*)(Args);

// The instantiation for a hidden width and rows a warp (n_hidden == 0 runs
// as width 16), or null.
KernelFn pick(int width, int n_hidden, int rows_per_warp) {
  const int w = n_hidden == 0 ? 16 : width;
  const int mt = rows_per_warp / 16;
  if (rows_per_warp != 16 * mt) return nullptr;
  switch (w * 10 + mt) {
    case 161: return ffmlp_forward_kernel<16, 1>;
    case 162: return ffmlp_forward_kernel<16, 2>;
    case 321: return ffmlp_forward_kernel<32, 1>;
    case 322: return ffmlp_forward_kernel<32, 2>;
    case 641: return ffmlp_forward_kernel<64, 1>;
    case 642: return ffmlp_forward_kernel<64, 2>;
    case 1281: return ffmlp_forward_kernel<128, 1>;
    default: return nullptr;
  }
}

}  // namespace

// Once per instantiation and device: lets the kernel take up to the card's
// dynamic shared memory. Then writes the blocks of `threads` threads and
// `smem_bytes` of dynamic shared memory one SM holds at once to
// *blocks_per_sm. Returns the cudaError_t (0 on success).
extern "C" int tcnn_ffmlp_forward_occupancy(int width, int n_hidden, int rows_per_warp, int threads,
                                            int smem_bytes, int* blocks_per_sm) {
  static bool set[kMaxDevices][8] = {};
  const KernelFn fn = pick(width, n_hidden, rows_per_warp);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int slot = (n_hidden == 0 ? 0 : width == 16 ? 0 : width == 32 ? 2 : width == 64 ? 4 : 6) +
                   (rows_per_warp == 32 ? 1 : 0);
  if (dev >= kMaxDevices || !set[dev][slot]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) set[dev][slot] = true;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem_bytes);
}

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. `plan` is the host plan's int32 array
// (ops/ffmlp.py:ForwardPlan); tcnn_ffmlp_forward_occupancy has run for its
// instantiation on this device.
extern "C" int tcnn_ffmlp_forward(const void* x, const void* weights, void* out, int batch, int in_w, int width,
                                  int n_hidden, int out_w, int act, int out_act, const void* plan,
                                  void* stream) {
  if (batch <= 0) return 0;
  const Plan pl = *static_cast<const Plan*>(plan);
  const KernelFn fn = pick(width, n_hidden, pl.rows_per_warp);
  if (fn == nullptr || pl.smem_bytes > kMaxSmem || pl.warps < 1 || pl.warps > kMaxWarps || pl.blocks < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.weights = static_cast<const __nv_bfloat16*>(weights);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.batch = batch;
  a.in_w = in_w;
  a.n_hidden = n_hidden;
  a.out_w = out_w;
  a.act = act;
  a.out_act = out_act;
  a.n_tiles = (batch + pl.rows_per_warp - 1) / pl.rows_per_warp;
  a.w_pad = pl.w_pad;
  a.x_bufs = pl.x_bufs;
  a.weight_bytes = pl.weight_bytes;
  a.warp_bytes = pl.warp_bytes;
  fn<<<pl.blocks, 32 * pl.warps, pl.smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

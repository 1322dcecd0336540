// Fully fused MLP backward for Hopper (sm_90a): a walk kernel, a split-K
// tensor-core weight gradient and a fixed-order reduce.
//
// Replaces: the Pallas kernel tcnn_tpu/ops/ffmlp.py:mlp_backward_pallas
// (bodies _mlp_bwd_kernel and _mlp_bwd_kernel_cf) with its wrapper
// _ffmlp_bwd, itself the TPU form of the reference's
// kernel_mlp_fused_backward (src/fully_fused_mlp.cu:151-259). The TPU
// kernel walks one batch tile at a time in grid order and carries the dW
// sum from step to step in VMEM; on the card blocks run in no order, so the
// batch sum becomes a product of its own.
//
// What it computes (the plain version is ops/ffmlp.py:ffmlp_backward_plain):
// per 16-row tile, the forward again from x (bf16 operands, fp32 sums,
// activation in fp32, bf16 layer inputs), keeping the fp32 pre-activations
// z; delta = act'(z_last) * g in fp32; then for each layer in reverse:
// d16 = bf16(delta), dh = d16 W_l (fp32), delta = act'(z_{l-1}) * dh;
// finally dx = bf16(dh). dW_l = d16_l^T h_l summed over the whole batch in
// fp32 and rounded to bf16 once.
//
// 1. tcnn_ffmlp_bwd_walk: one warp per 16-row tile, persistent blocks. It
//    writes dx and, to device scratch the wrapper allocates, every layer's
//    d16 tile D_l (rows_padded x n_out(l), bf16) and every hidden layer
//    input H_l, l >= 1 (rows_padded x width, bf16; H_0 is x). Rows past the
//    batch are written as zeros. With no dW partial in shared memory the
//    weights are staged there wherever they fit beside two warps, else read
//    through L2; one launch serves every depth and width. Where the
//    per-warp fp32 z tiles would leave fewer than four warps beside the
//    weights (width 128: 42 KB a warp at 128 x 5), they move to a global
//    slot a resident warp (~39 MB at 128 x 5, held in L2), so that 7-11
//    warps share the staged weights instead of 2-4 reading them through L2.
//    The activation and its derivative run on the accumulator fragments,
//    beside the z fragment, so z is written once and read once.
// 2. tcnn_ffmlp_bwd_dw: dW_l = D_l^T H_l as a split-K product, K = the
//    batch: one block of 4 warps per (layer, 64 x 64 output tile, K split),
//    mma.sync m16n8k16 bf16 -> fp32 on fragments that ldmatrix.trans loads
//    from row-major (batch-major) tiles, staged 32 rows at a time with
//    cp.async, double-buffered. Each block sums its K range in registers
//    and writes an fp32 partial (splits x n_weights); no atomics. Then one
//    small kernel sums the partials in split order and rounds once to bf16.
//    Products of bf16 values are exact in fp32, so only the order of fp32
//    sums differs from the plain version, and the same inputs give the same
//    bits on every call.
//
// What bounds it on this card: 6 * sum(fan_in * fan_out) flops a row
// (43,008 at the flagship's 32 -> 64 -> 64 -> 16) against 2 * (2 * in +
// out) bytes of inputs and outputs (160): 269 flop/byte, near the bf16
// ridge (~295), so the roofline is ~13 us for 2^18 rows. This design adds
// the scratch: 2 * (sum n_out + n_hidden * width) bytes a row written by
// the walk and read again by the product (544 B at the flagship, ~143 MB at
// 2^18 rows, ~0.085 ms at 3.35 TB/s), and the partials (splits x
// n_weights x 4 bytes, ~5 MB). The walk is bound by the rate of its
// 16 x 16 wmma steps and its shared-memory round trips (one warp per
// tile); the product runs at tensor-core rate on tiles that cp.async keeps
// ahead of it. wgmma/TMA and register-resident walk tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "activations.cuh"

using namespace nvcuda;
using tcnn_act::activate;
using tcnn_act::activate_backward;

namespace {

constexpr int kWalkMaxWarps = 16;  // the walk's block, as far as shared memory allows
constexpr size_t kMaxSmem = 232448;   // what one block may use on sm_90
constexpr size_t kSmPerSm = 233472;   // shared memory of one SM

__host__ __device__ inline size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// Shapes of the net; every width is a multiple of 16.
struct Net {
  int in_w, width, n_hidden, out_w;
  __host__ __device__ int n_layers() const { return n_hidden + 1; }
  __host__ __device__ int n_in(int l) const { return l == 0 ? in_w : width; }
  __host__ __device__ int n_out(int l) const { return l == n_hidden ? out_w : width; }
  // First weight of layer l in the flat buffer (l == n_layers: the total).
  __host__ __device__ size_t woff(int l) const {
    if (l == 0) return 0;
    if (n_hidden == 0) return (size_t)out_w * in_w;
    if (l <= n_hidden) return (size_t)width * in_w + (size_t)(l - 1) * width * width;
    return (size_t)width * in_w + (size_t)(n_hidden - 1) * width * width + (size_t)out_w * width;
  }
  __host__ __device__ int dmax() const { return n_hidden && width > out_w ? width : out_w; }
  __host__ __device__ int hmax() const { return n_hidden && width > in_w ? width : in_w; }
  // First column of layer l in a row of all layers' outputs (n_hidden *
  // width + out_w columns): D_l in the delta scratch, z_l in a z tile.
  __host__ __device__ size_t doff(int l) const { return (size_t)l * width; }
  __host__ __device__ int z_cols() const { return n_hidden * width + out_w; }
  // Per-warp shared-memory layout of the walk, byte offsets (multiples of
  // 128). The forward's two layer-input tiles (ping-pong) and the
  // backward's two delta tiles share the first region, since the backward
  // starts after the forward's last read of a layer input; then a 16 x 16
  // fp32 scratch tile; then, where they stay in shared memory, every
  // layer's fp32 z tile (16 x z_cols).
  __host__ __device__ size_t scratch_off() const { return 64 * (size_t)(hmax() > dmax() ? hmax() : dmax()); }
  __host__ __device__ size_t front_bytes() const { return scratch_off() + 16 * 16 * 4; }
  __host__ __device__ size_t h_off(int i) const { return 32 * (size_t)hmax() * i; }
  __host__ __device__ size_t warp_bytes(bool z_in_smem) const {
    return front_bytes() + (z_in_smem ? 64 * (size_t)z_cols() : 0);
  }
};

// 16 rows of a bf16 tile in shared memory (row stride `stride` elements) to
// global memory (row stride `cols`), `cols` / 8 vectors a row; rows at or
// past `valid_rows` are written as zeros.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, const __nv_bfloat16* src,
                                           int stride, int cols, int valid_rows, int lane) {
  const int vec = cols / 8;
  for (int i = lane; i < 16 * vec; i += 32) {
    const int r = i / vec;
    const int v = i % vec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid_rows) val = reinterpret_cast<const uint4*>(src + r * stride)[v];
    reinterpret_cast<uint4*>(dst + (size_t)r * cols)[v] = val;
  }
}

__global__ void ffmlp_walk_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                                  const __nv_bfloat16* __restrict__ weights, __nv_bfloat16* __restrict__ dx,
                                  __nv_bfloat16* __restrict__ d_scratch, __nv_bfloat16* __restrict__ h_scratch,
                                  float* __restrict__ z_global, int batch, int rows_padded, Net net, int act,
                                  int out_act, int stage_weights) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int L = net.n_layers();
  const size_t n_weights = net.woff(L);
  const size_t w_bytes = stage_weights ? round_up(n_weights * 2, 128) : 0;

  const __nv_bfloat16* W = weights;
  if (stage_weights) {
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
    for (size_t i = threadIdx.x; i < n_weights / 8; i += blockDim.x) {
      reinterpret_cast<uint4*>(w_s)[i] = reinterpret_cast<const uint4*>(weights)[i];
    }
    W = w_s;
    __syncthreads();
  }
  unsigned char* wp = smem + w_bytes + warp * net.warp_bytes(z_global == nullptr);
  float* scratch = reinterpret_cast<float*>(wp + net.scratch_off());
  // The warp's z tiles: after its front region, or in its own slot of the
  // global z scratch (one slot a resident warp, so it stays in L2).
  float* z_tiles = z_global ? z_global + ((size_t)blockIdx.x * n_warps + warp) * 16 * net.z_cols()
                            : reinterpret_cast<float*>(wp + net.front_bytes());

  const int dmax = net.dmax();
  const int64_t n_tiles = rows_padded / 16;
  for (int64_t tg = blockIdx.x; tg * n_warps < n_tiles; tg += gridDim.x) {
    const int64_t tile = tg * n_warps + warp;
    if (tile >= n_tiles) break;
    const int64_t row0 = tile * 16;
    // Rows of the tile inside the batch (0 or less for a padding tile).
    const int64_t left = (int64_t)batch - row0;
    const int valid_rows = left < 16 ? (int)(left > 0 ? left : 0) : 16;

    // The tile's input rows; rows past the batch read as zeros.
    {
      __nv_bfloat16* h0 = reinterpret_cast<__nv_bfloat16*>(wp + net.h_off(0));
      const int vec_per_row = net.in_w / 8;
      for (int i = lane; i < 16 * vec_per_row; i += 32) {
        const int r = i / vec_per_row;
        const int v = i % vec_per_row;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < valid_rows) val = reinterpret_cast<const uint4*>(x + (row0 + r) * net.in_w)[v];
        reinterpret_cast<uint4*>(h0 + r * net.in_w)[v] = val;
      }
      __syncwarp();
    }

    // Forward recompute: z_l (fp32) and h_{l+1} = bf16(act(z_l)), which
    // also goes to H_{l+1}. The activation runs on the accumulator
    // fragment, so the z tiles are only written here.
    for (int l = 0; l < L; ++l) {
      const int n_in = net.n_in(l);
      const int n_out = net.n_out(l);
      const __nv_bfloat16* hin = reinterpret_cast<const __nv_bfloat16*>(wp + net.h_off(l & 1));
      __nv_bfloat16* hn = reinterpret_cast<__nv_bfloat16*>(wp + net.h_off((l + 1) & 1));
      const __nv_bfloat16* wl = W + net.woff(l);
      float* z = z_tiles + 16 * net.doff(l);
      for (int j = 0; j < n_out / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int k = 0; k < n_in / 16; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, hin + k * 16, n_in);
          // B(k, c) = W[c][k]: row-major W read as a column-major K x N tile.
          wmma::load_matrix_sync(fb, wl + (size_t)j * 16 * n_in + k * 16, n_in);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(z + j * 16, acc, n_out, wmma::mem_row_major);
        if (l < L - 1) {
          for (int i = 0; i < acc.num_elements; ++i) acc.x[i] = activate(acc.x[i], act);
          wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            hn[(e / 16) * n_out + j * 16 + e % 16] = __float2bfloat16_rn(scratch[e]);
          }
          __syncwarp();
        }
      }
      if (l < L - 1) {
        store_rows(h_scratch + (size_t)l * rows_padded * net.width + row0 * net.width, hn, n_out, n_out,
                   valid_rows, lane);
      }
    }
    __syncwarp();

    // Output delta: act'(z_last) * g, rounded to bf16 (zeros past the
    // batch), 16 columns at a time: g through the scratch tile into an
    // accumulator fragment beside z's.
    __nv_bfloat16* dcur = reinterpret_cast<__nv_bfloat16*>(wp);
    __nv_bfloat16* dnext = dcur + 16 * dmax;
    {
      const float* zl = z_tiles + 16 * net.doff(L - 1);
      for (int c0 = 0; c0 < net.out_w; c0 += 16) {
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16;
          scratch[e] = r < valid_rows ? __bfloat162float(g[(row0 + r) * net.out_w + c0 + e % 16]) : 0.0f;
        }
        __syncwarp();
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> gf, zf;
        wmma::load_matrix_sync(gf, scratch, 16, wmma::mem_row_major);
        wmma::load_matrix_sync(zf, zl + c0, net.out_w, wmma::mem_row_major);
        for (int i = 0; i < gf.num_elements; ++i) gf.x[i] = activate_backward(gf.x[i], zf.x[i], out_act);
        __syncwarp();
        wmma::store_matrix_sync(scratch, gf, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16;
          dcur[r * dmax + c0 + e % 16] = __float2bfloat16_rn(r < valid_rows ? scratch[e] : 0.0f);
        }
        __syncwarp();
      }
    }

    for (int l = L - 1; l >= 0; --l) {
      const int n_in = net.n_in(l);
      const int n_out = net.n_out(l);
      const __nv_bfloat16* wl = W + net.woff(l);
      // D_l: this layer's d16 tile (zeros past the batch).
      store_rows(d_scratch + (size_t)rows_padded * net.doff(l) + row0 * n_out, dcur, dmax, n_out, 16, lane);
      // dh[:, k] = sum_j d16[:, j] W_l[j, k], then act'(z_{l-1}) on the
      // fragment beside z_{l-1}'s.
      const float* zp = l > 0 ? z_tiles + 16 * net.doff(l - 1) : nullptr;
      for (int k = 0; k < n_in / 16; ++k) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int j = 0; j < n_out / 16; ++j) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, dcur + j * 16, dmax);
          wmma::load_matrix_sync(fb, wl + (size_t)j * 16 * n_in + k * 16, n_in);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        if (l > 0) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> zf;
          wmma::load_matrix_sync(zf, zp + k * 16, n_in, wmma::mem_row_major);
          for (int i = 0; i < acc.num_elements; ++i) acc.x[i] = activate_backward(acc.x[i], zf.x[i], act);
        }
        wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16;
          const int c = k * 16 + e % 16;
          if (l > 0) {
            dnext[r * dmax + c] = __float2bfloat16_rn(r < valid_rows ? scratch[e] : 0.0f);
          } else if (r < valid_rows) {
            dx[(row0 + r) * net.in_w + c] = __float2bfloat16_rn(scratch[e]);
          }
        }
        __syncwarp();
      }
      __nv_bfloat16* t = dcur;
      dcur = dnext;
      dnext = t;
    }
  }
}

// ---- The weight gradient: split-K dW_l = D_l^T H_l, then the reduce. ----

constexpr int kMaxLayers = 64;
constexpr int kTileM = 64;            // output rows (n_out) of a block
constexpr int kTileN = 64;            // output columns (n_in) of a block
constexpr int kTileK = 32;            // batch rows a stage
constexpr int kRowStride = kTileN + 8;  // padded shared row (bf16): ldmatrix rows on distinct banks
constexpr int kDwThreads = 128;

struct DwLayer {
  const __nv_bfloat16* d;   // D_l: rows_padded x m (row-major)
  const __nv_bfloat16* h;   // H_l: h_rows valid rows x n (row-major)
  long long woff;           // first weight of the layer
  int m, n, h_rows, tiles_n, first_job;
};

struct DwArgs {
  DwLayer layer[kMaxLayers];
  int n_layers, k_tiles, tiles_per_split;
  long long n_weights;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with src_bytes 0 the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Four 8 x 8 bf16 matrices, each transposed on the way to the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block: the (layer, m tile, n tile) of blockIdx.x over the K tiles of
// split blockIdx.y. Four warps in a 2 x 2 grid, each 32 x 32 of the output:
// two m16 by four n8 accumulator tiles. Shared tiles are batch-major, as
// the scratch is: the D tile [k][m] is A^T and the H tile [k][n] is B, so
// both go through ldmatrix.trans.
__global__ void __launch_bounds__(kDwThreads) ffmlp_dw_kernel(const __grid_constant__ DwArgs args,
                                                                   float* __restrict__ partial) {
  __shared__ __align__(128) __nv_bfloat16 ds[2][kTileK][kRowStride];
  __shared__ __align__(128) __nv_bfloat16 hs[2][kTileK][kRowStride];
  const int job = blockIdx.x;
  int li = 0;
  while (li + 1 < args.n_layers && args.layer[li + 1].first_job <= job) ++li;
  const DwLayer& ly = args.layer[li];
  const int t = job - ly.first_job;
  const int m0 = (t / ly.tiles_n) * kTileM;
  const int n0 = (t % ly.tiles_n) * kTileN;
  const int kt0 = blockIdx.y * args.tiles_per_split;
  const int kt1 = min(args.k_tiles, kt0 + args.tiles_per_split);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  auto load = [&](int kt, int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kDwThreads;   // 256 chunks of 8 columns: 32 rows x 8
      const int r = c / 8;
      const int col = (c % 8) * 8;
      const int64_t row = (int64_t)kt * kTileK + r;
      if (m0 + col < ly.m) cp_async16(&ds[s][r][col], ly.d + row * ly.m + m0 + col, 16);
      if (n0 + col < ly.n) {
        const bool in = row < ly.h_rows;
        cp_async16(&hs[s][r][col], in ? ly.h + row * ly.n + n0 + col : ly.h, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  // ldmatrix lane addresses: matrix i = lane / 8, row lane % 8 of it.
  const int mi8 = lane >> 3;
  const int r8 = lane & 7;
  const int a_k = r8 + ((mi8 >> 1) << 3), a_m = (mi8 & 1) << 3;   // A: (k 0-7|8-15) x (m 0-7|8-15)
  const int b_k = r8 + ((mi8 & 1) << 3), b_n = (mi8 >> 1) << 3;   // B: (k 0-7|8-15) x (n 0-7|8-15)

  if (kt0 < kt1) load(kt0, 0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load(kt + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (m0 + wm + mi * 16 < ly.m) ldmatrix_x4_trans(a[mi], &ds[s][kk + a_k][wm + mi * 16 + a_m]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        if (n0 + wn + nj * 16 < ly.n) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, &hs[s][kk + b_k][wn + nj * 16 + b_n]);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (m0 + wm + mi * 16 < ly.m && n0 + wn + (ni >> 1) * 16 < ly.n) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
        }
      }
    }
    __syncthreads();
  }

  // The block's partial: accumulator (row g, cols 2t..2t+1) and (row g + 8).
  float* out = partial + (int64_t)blockIdx.y * args.n_weights + ly.woff;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + gid;
      const int col = n0 + wn + ni * 8 + tig * 2;
      if (m0 + wm + mi * 16 < ly.m && n0 + wn + (ni >> 1) * 16 < ly.n) {
        *reinterpret_cast<float2*>(out + (int64_t)row * ly.n + col) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(out + (int64_t)(row + 8) * ly.n + col) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

// dW = bf16(sum of the partials in split order): the same bits every call.
__global__ void dw_reduce_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dw16, int splits,
                                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s = __fadd_rn(s, partial[(int64_t)k * n + i]);
  dw16[i] = __float2bfloat16_rn(s);
}

}  // namespace

namespace {

// The walk's launch shape. Weights and every warp's z tiles in shared
// memory when at least kMinSmemZWarps warps fit so; else the weights there
// and the z tiles in a global slot a resident warp (z_floats of them, read
// back by the warp that wrote them, so they stay in L2) for as many warps
// as fit; else (weights past 227 KB) the weights read through L2.
constexpr int kMinSmemZWarps = 4;

struct WalkPlan {
  int stage, z_global, warps;
  size_t smem;
  int64_t max_blocks;
  long long z_floats;
};

cudaError_t plan_walk(const Net& net, WalkPlan* p) {
  const size_t w_bytes = round_up(net.woff(net.n_layers()) * 2, 128);
  auto fit = [](size_t fixed, size_t per_warp) {
    int w = kWalkMaxWarps;
    while (w > 0 && fixed + w * per_warp > kMaxSmem) --w;
    return w;
  };
  const int with_z = fit(w_bytes, net.warp_bytes(true));
  const int without_z = fit(w_bytes, net.warp_bytes(false));
  if (with_z >= kMinSmemZWarps) {
    *p = {1, 0, with_z, 0, 0, 0};
  } else if (without_z >= 2) {
    *p = {1, 1, without_z, 0, 0, 0};
  } else {
    *p = {0, 0, fit(0, net.warp_bytes(true)), 0, 0, 0};
    if (p->warps < 1) return cudaErrorInvalidValue;
  }
  p->smem = (p->stage ? w_bytes : 0) + p->warps * net.warp_bytes(!p->z_global);
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const int64_t per_sm = kSmPerSm / (p->smem + 1024) > 0 ? kSmPerSm / (p->smem + 1024) : 1;
  p->max_blocks = sms * per_sm;
  p->z_floats = p->z_global ? (long long)p->max_blocks * p->warps * 16 * net.z_cols() : 0;
  return cudaSuccess;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. The walk of the new design: writes dx
// (batch x in_w), D (rows_padded x (n_hidden * width + out_w)) and H
// (n_hidden layers of rows_padded x width); rows_padded is the batch
// rounded up to a multiple of 32 and the rows past the batch are written as
// zeros. `z_scratch` holds `z_floats` floats, at least what
// tcnn_ffmlp_bwd_walk_scratch gives for the shapes (unused when that is 0).
extern "C" int tcnn_ffmlp_bwd_walk(const void* x, const void* g, const void* weights, void* dx, void* d_scratch,
                                   void* h_scratch, void* z_scratch, long long z_floats, int batch, int rows_padded,
                                   int in_w, int width, int n_hidden, int out_w, int act, int out_act, void* stream) {
  if (rows_padded <= 0) return 0;
  if (rows_padded % kTileK || rows_padded < batch) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Net net{in_w, width, n_hidden, out_w};
  WalkPlan p;
  cudaError_t err = plan_walk(net, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.z_global && z_floats < p.z_floats) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(ffmlp_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem)) !=
      cudaSuccess) {
    return (int)err;
  }
  const int64_t n_tiles = rows_padded / 16;
  const int64_t want = (n_tiles + p.warps - 1) / p.warps;
  const int64_t blocks = want < p.max_blocks ? want : p.max_blocks;
  ffmlp_walk_kernel<<<(unsigned)blocks, 32 * p.warps, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(weights), static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(d_scratch), static_cast<__nv_bfloat16*>(h_scratch),
      p.z_global ? static_cast<float*>(z_scratch) : nullptr, batch, rows_padded, net, act, out_act, p.stage);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the query (0 on success) and writes to
// `z_floats` the fp32 count of the walk's global z scratch for these shapes
// on the current device: 0 when the z tiles stay in shared memory.
extern "C" int tcnn_ffmlp_bwd_walk_scratch(int in_w, int width, int n_hidden, int out_w, long long* z_floats) {
  WalkPlan p;
  const cudaError_t err = plan_walk(Net{in_w, width, n_hidden, out_w}, &p);
  *z_floats = err == cudaSuccess ? p.z_floats : 0;
  return (int)err;
}

// Returns the cudaError_t of the launches (0 on success). Launches on
// `stream` and does not synchronise. The weight gradient of the new design
// from the walk's scratch and x: the split-K product into `partial` (splits
// x n_weights fp32, overwritten; split k covers K tiles [k tps, (k + 1) tps)
// of 32 rows) and the reduce into `dw16` (bf16, the layout of the weights).
extern "C" int tcnn_ffmlp_bwd_dw(const void* x, const void* d_scratch, const void* h_scratch, void* partial,
                                 void* dw16, int batch, int rows_padded, int in_w, int width, int n_hidden, int out_w,
                                 int tiles_per_split, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Net net{in_w, width, n_hidden, out_w};
  const int L = net.n_layers();
  const int64_t n_weights = (int64_t)net.woff(L);
  const int k_tiles = rows_padded / kTileK;
  if (L > kMaxLayers || rows_padded % kTileK || rows_padded < batch || splits < 1 || tiles_per_split < 1 ||
      (int64_t)splits * tiles_per_split < k_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  DwArgs args;
  int jobs = 0;
  for (int l = 0; l < L; ++l) {
    DwLayer& ly = args.layer[l];
    ly.d = static_cast<const __nv_bfloat16*>(d_scratch) + (size_t)rows_padded * net.doff(l);
    ly.h = l == 0 ? static_cast<const __nv_bfloat16*>(x)
                  : static_cast<const __nv_bfloat16*>(h_scratch) + (size_t)(l - 1) * rows_padded * width;
    ly.woff = (long long)net.woff(l);
    ly.m = net.n_out(l);
    ly.n = net.n_in(l);
    ly.h_rows = l == 0 ? batch : rows_padded;
    ly.tiles_n = (ly.n + kTileN - 1) / kTileN;
    ly.first_job = jobs;
    jobs += ((ly.m + kTileM - 1) / kTileM) * ly.tiles_n;
  }
  args.n_layers = L;
  args.k_tiles = k_tiles;
  args.tiles_per_split = tiles_per_split;
  args.n_weights = n_weights;
  ffmlp_dw_kernel<<<dim3((unsigned)jobs, (unsigned)splits), kDwThreads, 0, s>>>(args, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((n_weights + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(dw16), splits, n_weights);
  return (int)cudaGetLastError();
}

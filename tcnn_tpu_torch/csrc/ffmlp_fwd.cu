// Fully fused MLP forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel tcnn_tpu/ops/ffmlp.py:mlp_forward_pallas
// (bodies _mlp_kernel and _mlp_kernel_cf), itself the TPU form of the
// reference's kernel_mlp_fused (src/fully_fused_mlp.cu:499-557).
//
// What it computes: for a tile of rows, every layer z = h @ W^T with bf16
// operands and fp32 accumulation, the activation in fp32, then one round to
// bf16 (__float2bfloat16_rn) before the next layer; the last layer uses the
// output activation. Weights arrive as one bf16 buffer of row-major
// (fan_out, fan_in) matrices in flat-parameter order.
//
// What bounds it on this card: a row costs 2 * sum(fan_in * fan_out) flops
// against 2 * (in + out) bytes of device memory: 14,336 flops per 96 bytes
// (149 flop/byte) at the flagship's 32 -> 64 -> 64 -> 16, below the bf16
// ridge (~295), so at the roofline HBM would bound it (~7.5 us for 2^18
// rows). This first design is far from that: it is bound by the issue of
// its many small wmma steps and their shared-memory traffic (the scratch
// round trip per 16x16 block, the weights restaged by every block).
//
// Design: one block stages all weight matrices in shared memory once (the
// flagship's 7,168 weights are 14 KB; width 128 with 5 hidden layers is
// ~140 KB, hence dynamic shared memory). Each warp owns 16 rows: their
// activations stay in shared memory between layers (ping-pong buffers), and
// every 16x16 output block is a chain of bf16 wmma products with an fp32
// accumulator. The activation is applied to the accumulator elements, which
// are then rounded to bf16 through a per-warp fp32 scratch tile. Products
// of two bf16 values are exact in fp32, so only the order of the fp32 sums
// differs from the plain chain. The ragged last tile reads zero rows and
// skips their stores. wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "activations.cuh"

using namespace nvcuda;
using tcnn_act::activate;

namespace {

constexpr int kWarpRows = 16;
constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90

__host__ __device__ inline size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// Per-warp shared memory: two (16 x max_w) bf16 activation tiles and one
// 16x16 fp32 scratch tile. A multiple of 128 bytes, so every wmma pointer
// below stays 32-byte aligned.
__host__ __device__ inline size_t warp_bytes(int max_w) {
  return 2 * kWarpRows * (size_t)max_w * 2 + 16 * 16 * 4;
}

__global__ void ffmlp_forward_kernel(const __nv_bfloat16* __restrict__ x,
                                     const __nv_bfloat16* __restrict__ weights,
                                     __nv_bfloat16* __restrict__ out, int batch, int in_w,
                                     int width, int n_hidden, int out_w, int act, int out_act,
                                     int n_weights, int max_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Stage all weights (n_weights is a multiple of 256: every dimension is
  // a multiple of 16).
  const int n_vec = n_weights / 8;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    reinterpret_cast<uint4*>(w_s)[i] = reinterpret_cast<const uint4*>(weights)[i];
  }

  unsigned char* wp = smem + round_up((size_t)n_weights * 2, 128) + warp * warp_bytes(max_w);
  __nv_bfloat16* h_in = reinterpret_cast<__nv_bfloat16*>(wp);
  __nv_bfloat16* h_out = h_in + kWarpRows * max_w;
  float* scratch = reinterpret_cast<float*>(h_out + kWarpRows * max_w);
  const int64_t row0 = ((int64_t)blockIdx.x * (blockDim.x / 32) + warp) * kWarpRows;

  // This warp's 16 input rows; rows past the batch read as zeros.
  const int vec_per_row = in_w / 8;
  for (int i = lane; i < kWarpRows * vec_per_row; i += 32) {
    const int r = i / vec_per_row;
    const int v = i % vec_per_row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < batch) val = reinterpret_cast<const uint4*>(x + (row0 + r) * in_w)[v];
    reinterpret_cast<uint4*>(h_in + r * max_w)[v] = val;
  }
  __syncthreads();

  const __nv_bfloat16* wl = w_s;
  int n_in = in_w;
  const int n_layers = n_hidden + 1;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    const int n_out = last ? out_w : width;
    const int a = last ? out_act : act;
    for (int j = 0; j < n_out / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < n_in / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, h_in + k * 16, max_w);
        // B(k, c) = W[c][k]: row-major W read as a column-major K x N tile.
        wmma::load_matrix_sync(fb, wl + (size_t)j * 16 * n_in + k * 16, n_in);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      for (int e = 0; e < acc.num_elements; ++e) acc.x[e] = activate(acc.x[e], a);
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16;
        const int c = e % 16;
        const __nv_bfloat16 v = __float2bfloat16_rn(scratch[e]);
        if (last) {
          if (row0 + r < batch) out[(row0 + r) * out_w + j * 16 + c] = v;
        } else {
          h_out[r * max_w + j * 16 + c] = v;
        }
      }
      __syncwarp();
    }
    wl += (size_t)n_out * n_in;
    __nv_bfloat16* t = h_in;
    h_in = h_out;
    h_out = t;
    n_in = n_out;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int tcnn_ffmlp_forward(const void* x, const void* weights, void* out, int batch,
                                  int in_w, int width, int n_hidden, int out_w, int act,
                                  int out_act, void* stream) {
  if (batch <= 0) return 0;
  const int n_weights = n_hidden == 0
                            ? out_w * in_w
                            : width * in_w + (n_hidden - 1) * width * width + out_w * width;
  int max_w = in_w > out_w ? in_w : out_w;
  if (n_hidden > 0 && width > max_w) max_w = width;
  const size_t w_bytes = round_up((size_t)n_weights * 2, 128);
  int warps = kMaxWarps;
  while (warps > 1 && w_bytes + warps * warp_bytes(max_w) > kMaxSmem) warps /= 2;
  const size_t smem = w_bytes + warps * warp_bytes(max_w);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffmlp_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = kWarpRows * warps;
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  ffmlp_forward_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(weights),
      static_cast<__nv_bfloat16*>(out), batch, in_w, width, n_hidden, out_w, act, out_act,
      n_weights, max_w);
  return (int)cudaGetLastError();
}

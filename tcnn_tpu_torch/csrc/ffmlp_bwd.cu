// Fully fused MLP backward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel tcnn_tpu/ops/ffmlp.py:mlp_backward_pallas
// (bodies _mlp_bwd_kernel and _mlp_bwd_kernel_cf) with its wrapper
// _ffmlp_bwd, itself the TPU form of the reference's
// kernel_mlp_fused_backward (src/fully_fused_mlp.cu:151-259).
//
// What it computes, for every 16-row tile: the forward again from x (bf16
// operands, fp32 sums, activation in fp32, bf16 layer inputs), keeping the
// fp32 pre-activations z; delta = act'(z_last) * g in fp32; then for each
// layer in reverse: d16 = bf16(delta), dW_l += d16^T h_l (fp32),
// dh = d16 W_l (fp32), delta = act'(z_{l-1}) * dh; finally dx = bf16(dh).
// dW is summed over the whole batch in fp32 and rounded to bf16 once, by a
// second small kernel, as _ffmlp_bwd rounds the summed partials.
//
// What bounds it on this card: 6 * sum(fan_in * fan_out) flops a row
// (43,008 at the flagship's 32 -> 64 -> 64 -> 16) against 2 * (2 * in +
// out) bytes of device memory (160): 269 flop/byte, near the bf16 ridge
// (~295), so tensor-core issue and HBM would bound it about equally at the
// roofline (~13 us for 2^18 rows). This first design is bound instead by
// the issue of its small wmma steps, the shared-memory round trips of the
// 16x16 scratch tile and the shared-memory atomics of the dW partials.
//
// Design: persistent blocks of up to 8 warps; each warp owns one 16-row
// tile at a time and keeps the tile's layer inputs (bf16), pre-activations
// (fp32) and two delta tiles in shared memory. The weights are staged in
// shared memory when they fit beside the rest, else read through L2. The
// block sums its tiles' dW in an fp32 shared-memory partial (atomicAdd
// from the warps' 16x16 product tiles) and adds it to the device buffer
// once, with atomicAdd. When the partial for all layers does not fit (wide,
// deep nets), the launch is repeated for groups of layers; every pass
// recomputes the walk and the first one writes dx. Products of bf16 values
// are exact in fp32, so only the order of fp32 sums differs from the plain
// version. wgmma/TMA and register-resident tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "activations.cuh"

using namespace nvcuda;
using tcnn_act::activate;
using tcnn_act::activate_backward;

namespace {

constexpr int kMaxWarps = 8;
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
  // Per-warp shared-memory layout, byte offsets (all multiples of 128).
  __host__ __device__ size_t h_off(int l) const {
    return l == 0 ? 0 : 32 * (size_t)in_w + 32 * (size_t)(l - 1) * width;
  }
  __host__ __device__ size_t z_base() const { return h_off(n_hidden + 1); }
  __host__ __device__ size_t z_off(int l) const { return z_base() + 64 * (size_t)l * width; }
  __host__ __device__ size_t d_base() const { return z_off(n_hidden) + 64 * (size_t)out_w; }
  __host__ __device__ size_t scratch_off() const { return d_base() + 64 * (size_t)dmax(); }
  __host__ __device__ size_t warp_bytes() const { return scratch_off() + 16 * 16 * 4; }
};

__global__ void ffmlp_backward_kernel(const __nv_bfloat16* __restrict__ x,
                                      const __nv_bfloat16* __restrict__ g,
                                      const __nv_bfloat16* __restrict__ weights,
                                      __nv_bfloat16* __restrict__ dx, float* __restrict__ dw,
                                      int batch, Net net, int act, int out_act, int stage_weights,
                                      int g_lo, int g_hi, int write_dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int L = net.n_layers();
  const size_t n_weights = net.woff(L);
  const size_t w_bytes = stage_weights ? round_up(n_weights * 2, 128) : 0;
  const size_t dw_lo = net.woff(g_lo);
  const size_t dw_n = net.woff(g_hi) - dw_lo;

  const __nv_bfloat16* W = weights;
  if (stage_weights) {
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
    for (size_t i = threadIdx.x; i < n_weights / 8; i += blockDim.x) {
      reinterpret_cast<uint4*>(w_s)[i] = reinterpret_cast<const uint4*>(weights)[i];
    }
    W = w_s;
  }
  float* dw_s = reinterpret_cast<float*>(smem + w_bytes);
  for (size_t i = threadIdx.x; i < dw_n; i += blockDim.x) dw_s[i] = 0.0f;
  unsigned char* wp = smem + w_bytes + round_up(dw_n * 4, 128) + warp * net.warp_bytes();
  float* scratch = reinterpret_cast<float*>(wp + net.scratch_off());
  __syncthreads();

  const int dmax = net.dmax();
  const int64_t n_tiles = ((int64_t)batch + 15) / 16;
  for (int64_t tg = blockIdx.x; tg * n_warps < n_tiles; tg += gridDim.x) {
    const int64_t tile = tg * n_warps + warp;
    if (tile >= n_tiles) break;
    const int64_t row0 = tile * 16;
    const int valid_rows = (int)(batch - row0 < 16 ? batch - row0 : 16);

    // The tile's input rows; rows past the batch read as zeros.
    __nv_bfloat16* h0 = reinterpret_cast<__nv_bfloat16*>(wp);
    const int vec_per_row = net.in_w / 8;
    for (int i = lane; i < 16 * vec_per_row; i += 32) {
      const int r = i / vec_per_row;
      const int v = i % vec_per_row;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < valid_rows) val = reinterpret_cast<const uint4*>(x + (row0 + r) * net.in_w)[v];
      reinterpret_cast<uint4*>(h0 + r * net.in_w)[v] = val;
    }
    __syncwarp();

    // Forward recompute: z_l (fp32) and h_{l+1} = bf16(act(z_l)).
    for (int l = 0; l < L; ++l) {
      const int n_in = net.n_in(l);
      const int n_out = net.n_out(l);
      const __nv_bfloat16* hin = reinterpret_cast<const __nv_bfloat16*>(wp + net.h_off(l));
      const __nv_bfloat16* wl = W + net.woff(l);
      float* z = reinterpret_cast<float*>(wp + net.z_off(l));
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
      }
      __syncwarp();
      if (l < L - 1) {
        __nv_bfloat16* hn = reinterpret_cast<__nv_bfloat16*>(wp + net.h_off(l + 1));
        for (int e = lane; e < 16 * n_out; e += 32) hn[e] = __float2bfloat16_rn(activate(z[e], act));
        __syncwarp();
      }
    }

    // Output delta: act'(z_last) * g, rounded to bf16.
    __nv_bfloat16* dcur = reinterpret_cast<__nv_bfloat16*>(wp + net.d_base());
    __nv_bfloat16* dnext = dcur + 16 * dmax;
    {
      const float* zl = reinterpret_cast<const float*>(wp + net.z_off(L - 1));
      for (int e = lane; e < 16 * net.out_w; e += 32) {
        const int r = e / net.out_w;
        const int c = e % net.out_w;
        float dv = 0.0f;
        if (r < valid_rows) {
          const float gv = __bfloat162float(g[(row0 + r) * net.out_w + c]);
          dv = activate_backward(gv, zl[e], out_act);
        }
        dcur[r * dmax + c] = __float2bfloat16_rn(dv);
      }
      __syncwarp();
    }

    const int stop = write_dx ? 0 : g_lo;
    for (int l = L - 1; l >= stop; --l) {
      const int n_in = net.n_in(l);
      const int n_out = net.n_out(l);
      const __nv_bfloat16* hin = reinterpret_cast<const __nv_bfloat16*>(wp + net.h_off(l));
      const __nv_bfloat16* wl = W + net.woff(l);
      if (l >= g_lo && l < g_hi) {
        // dW_l tile (j, k) = d16[:, j]^T h_l[:, k] over the tile's 16 rows.
        float* dwl = dw_s + (net.woff(l) - dw_lo);
        for (int j = 0; j < n_out / 16; ++j) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
          wmma::load_matrix_sync(fa, dcur + j * 16, dmax);
          for (int k = 0; k < n_in / 16; ++k) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.0f);
            wmma::load_matrix_sync(fb, hin + k * 16, n_in);
            wmma::mma_sync(acc, fa, fb, acc);
            wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
              atomicAdd(dwl + (size_t)(j * 16 + e / 16) * n_in + k * 16 + e % 16, scratch[e]);
            }
            __syncwarp();
          }
        }
      }
      if (l > stop || (l == 0 && write_dx)) {
        // dh[:, k] = sum_j d16[:, j] W_l[j, k].
        const float* zp = l > 0 ? reinterpret_cast<const float*>(wp + net.z_off(l - 1)) : nullptr;
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
          wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = e / 16;
            const int c = k * 16 + e % 16;
            if (l > 0) {
              const float dv = r < valid_rows ? activate_backward(scratch[e], zp[r * n_in + c], act) : 0.0f;
              dnext[r * dmax + c] = __float2bfloat16_rn(dv);
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

  __syncthreads();
  for (size_t i = threadIdx.x; i < dw_n; i += blockDim.x) {
    const float v = dw_s[i];
    if (v != 0.0f) atomicAdd(dw + dw_lo + i, v);
  }
}

__global__ void round_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                     int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success). Launches on
// `stream` and does not synchronise. `dw32` is fp32 scratch of n_weights
// values (overwritten); `dw16` receives the bf16-rounded weight gradient in
// the layout of `weights`.
extern "C" int tcnn_ffmlp_backward(const void* x, const void* g, const void* weights, void* dx,
                                   void* dw32, void* dw16, int batch, int in_w, int width,
                                   int n_hidden, int out_w, int act, int out_act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Net net{in_w, width, n_hidden, out_w};
  const int L = net.n_layers();
  const size_t n_weights = net.woff(L);
  cudaError_t err = cudaMemsetAsync(dw32, 0, n_weights * 4, s);
  if (err != cudaSuccess) return (int)err;

  if (batch > 0) {
    const size_t per_warp = net.warp_bytes();
    const size_t w_bytes = round_up(n_weights * 2, 128);
    // Stage the weights when they, the whole dW partial and one warp fit.
    const int stage = w_bytes + round_up(n_weights * 4, 128) + per_warp <= kMaxSmem;
    const size_t budget = kMaxSmem - (stage ? w_bytes : 0) - per_warp;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
      return (int)err;
    }
    const int64_t n_tiles = ((int64_t)batch + 15) / 16;
    int g_lo = 0;
    bool first = true;
    while (g_lo < L) {
      // The largest group of layers whose fp32 dW partial fits the budget.
      int g_hi = g_lo + 1;
      while (g_hi < L && round_up((net.woff(g_hi + 1) - net.woff(g_lo)) * 4, 128) <= budget) ++g_hi;
      const size_t dw_bytes = round_up((net.woff(g_hi) - net.woff(g_lo)) * 4, 128);
      if (dw_bytes > budget) return (int)cudaErrorInvalidValue;
      int warps = kMaxWarps;
      while (warps > 1 && (stage ? w_bytes : 0) + dw_bytes + warps * per_warp > kMaxSmem) warps /= 2;
      const size_t smem = (stage ? w_bytes : 0) + dw_bytes + warps * per_warp;
      err = cudaFuncSetAttribute(ffmlp_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      const int64_t per_sm = kSmPerSm / (smem + 1024) > 0 ? kSmPerSm / (smem + 1024) : 1;
      const int64_t want = (n_tiles + warps - 1) / warps;
      const int64_t blocks = want < sms * per_sm ? want : sms * per_sm;
      ffmlp_backward_kernel<<<(unsigned)blocks, 32 * warps, smem, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
          static_cast<const __nv_bfloat16*>(weights), static_cast<__nv_bfloat16*>(dx),
          static_cast<float*>(dw32), batch, net, act, out_act, stage, g_lo, g_hi, first ? 1 : 0);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      first = false;
      g_lo = g_hi;
    }
  }

  const int threads = 256;
  const unsigned blocks = (unsigned)((n_weights + threads - 1) / threads);
  round_to_bf16_kernel<<<blocks, threads, 0, s>>>(static_cast<const float*>(dw32),
                                                  static_cast<__nv_bfloat16*>(dw16),
                                                  (int64_t)n_weights);
  return (int)cudaGetLastError();
}

// Fused Adam step over the flat parameter vector, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel tcnn_tpu/ops/fused_adam.py:adam_step_fused
// (body _adam_kernel), the one-pass form of the reference's adam_step
// (optimizers/adam.h:47-127).
//
// What it computes, per parameter i (tiny-cuda-nn's Adam, as
// tcnn_tpu/optimizers/adam.py:_step_xla): the gradient descaled by the loss
// scale; the matrix/non-matrix split at n_matrix (l2, learning-rate factor,
// enable flags); non-matrix entries whose descaled gradient is exactly zero
// skipped (moments and step count kept) when skip_zero_grad is set; l2 and
// gradient clipping; both moments; the per-parameter step count and its
// debias sqrt(1 - b2^t) / (1 - b1^t) with powf of the fp32 betas; the
// AdaBound bounds from the global step; relative and absolute weight decay;
// weight clipping. Every product and sum is rounded on its own (the _rn
// intrinsics), in the order of the plain torch version, so that nvcc fuses
// no multiply-add the plain version does not have.
//
// What bounds it on this card: HBM. Each parameter reads params, grads, both
// moments and its step count and writes four of them back: 36 bytes for ~30
// flops. At the flagship's 715,760 parameters that is 25.8 MB, ~7.7 us at
// 3.35 TB/s; at the 3D model's 13.05 M, 470 MB, ~0.14 ms.
//
// Design: in place (the outputs alias the inputs), hyperparameters in one
// struct passed by value, the global step read from the device so that no
// host synchronisation is needed. A grid-stride loop over 4 blocks of 256
// threads an SM; each thread takes 4 entries at a time with 16-byte loads
// and stores, the next 4 loaded before the current ones are computed (the
// n_matrix boundary may fall inside them; a scalar tail; scalar access
// throughout where a pointer is not 16-byte aligned), with 32-bit indices.
// The debiased learning rates lr * sqrt(1 - b2^t) / (1 - b1^t) at the
// global step t, and the AdaBound bounds, are computed once a thread, while
// its first loads are in flight, with the same operations in the same
// order; an entry whose own step count is t (every matrix entry, every
// non-matrix entry that was never skipped) takes them, the others compute
// their own. The results are bitwise those of computing every entry's. (A
// block-wide copy computed by one thread behind a barrier ran 0.0172 ms
// against 0.0148 at 715,760 parameters: the barrier held every load of a
// one-wave kernel behind two powf chains.)

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Blocks an SM the grid-stride loop is sized to (when they fit): at the
// flagship's 715,760 parameters 4 ran 0.0144 ms, 8 0.0149, 2 0.0167 (one
// H100, PERF.md §6).
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

// Layout must match tcnn_tpu_torch/ops/fused_adam.py:AdamHyperparams.
struct AdamHyperparams {
  float loss_scale;
  float beta1, beta2, epsilon;
  float one_minus_beta1, one_minus_beta2;  // 1 - beta in double, then fp32
  float lr_matrix, lr_non_matrix;          // base lr, base lr * non-matrix factor
  float l2_reg, non_matrix_l2_reg;
  float relative_decay, absolute_decay;
  float weight_clip, gradient_clip;
  int32_t adabound, optimize_matrix, optimize_non_matrix, skip_zero_grad;
  int64_t n, n_matrix;
};

// What every entry of a step shares: the global step, the debiased
// learning rates at it (matrix, non-matrix) and the AdaBound bounds.
struct StepConstants {
  int32_t step;
  float lr[2];
  float lower, upper;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// The debiased learning rate at per-parameter step count t (>= 1).
__device__ __forceinline__ float debiased(float lr, float t, const AdamHyperparams& hp) {
  return __fdiv_rn(__fmul_rn(lr, sqrtf(__fsub_rn(1.0f, powf(hp.beta2, t)))), __fsub_rn(1.0f, powf(hp.beta1, t)));
}

// One entry in place: tiny-cuda-nn's Adam (see the top of the file).
__device__ __forceinline__ void update(float& weight_io, float grad, float& m_io, float& v_io, int32_t& ps_io,
                                       bool is_matrix, const AdamHyperparams& hp, const StepConstants& sh) {
  const float weight = weight_io;
  float gradient = __fdiv_rn(grad, hp.loss_scale);

  bool active = is_matrix ? hp.optimize_matrix != 0 : hp.optimize_non_matrix != 0;
  if (hp.skip_zero_grad) active = active && (is_matrix || gradient != 0.0f);

  gradient = __fadd_rn(gradient, __fmul_rn(is_matrix ? hp.l2_reg : hp.non_matrix_l2_reg, weight));
  if (hp.gradient_clip != 0.0f) gradient = clampf(gradient, -hp.gradient_clip, hp.gradient_clip);

  const float first = __fadd_rn(__fmul_rn(hp.beta1, m_io), __fmul_rn(hp.one_minus_beta1, gradient));
  const float second = __fadd_rn(__fmul_rn(hp.beta2, v_io),
                                 __fmul_rn(__fmul_rn(hp.one_minus_beta2, gradient), gradient));

  const int32_t ps = ps_io + (active ? 1 : 0);
  const float lr = ps == sh.step ? sh.lr[is_matrix ? 0 : 1]
                                 : debiased(is_matrix ? hp.lr_matrix : hp.lr_non_matrix,
                                            (float)(ps > 1 ? ps : 1), hp);
  const float effective_lr = clampf(__fdiv_rn(lr, __fadd_rn(sqrtf(second), hp.epsilon)), sh.lower, sh.upper);

  const float sign = weight > 0.0f ? 1.0f : (weight < 0.0f ? -1.0f : 0.0f);
  const float decayed = __fsub_rn(__fmul_rn(__fsub_rn(1.0f, __fmul_rn(hp.relative_decay, lr)), weight),
                                  __fmul_rn(sign, __fmul_rn(hp.absolute_decay, lr)));
  float new_weight = __fsub_rn(decayed, __fmul_rn(effective_lr, first));
  if (hp.weight_clip != 0.0f) new_weight = clampf(new_weight, -hp.weight_clip, hp.weight_clip);

  if (active) {
    weight_io = new_weight;
    m_io = first;
    v_io = second;
  }
  ps_io = ps;
}

// The loads of one 4-entry vector.
struct Vec {
  float4 w, g, m, v;
  int4 ps;
};

__device__ __forceinline__ Vec load_vec(const float* params, const float* grads, const float* m, const float* v,
                                        const int32_t* ps, int i) {
  return {reinterpret_cast<const float4*>(params)[i], reinterpret_cast<const float4*>(grads)[i],
          reinterpret_cast<const float4*>(m)[i], reinterpret_cast<const float4*>(v)[i],
          reinterpret_cast<const int4*>(ps)[i]};
}

// The StepConstants of the global step.
__device__ __forceinline__ StepConstants step_constants(const AdamHyperparams& hp, int32_t step) {
  StepConstants sh;
  sh.step = step;
  const float t = (float)(step > 1 ? step : 1);
  sh.lr[0] = debiased(hp.lr_matrix, t, hp);
  sh.lr[1] = debiased(hp.lr_non_matrix, t, hp);
  sh.lower = 0.0f;
  sh.upper = FLT_MAX;
  if (hp.adabound) {
    const float ts = (float)step;
    sh.lower = __fsub_rn(0.1f, __fdiv_rn(0.1f, __fadd_rn(__fmul_rn(hp.one_minus_beta2, ts), 1.0f)));
    sh.upper = __fadd_rn(0.1f, __fdiv_rn(0.1f, __fmul_rn(hp.one_minus_beta2, ts)));
  }
  return sh;
}

// VEC: 4 entries at a time with 16-byte access (every pointer 16-byte
// aligned), the next vector's loads issued before the current one is
// computed, then the scalar tail; else one entry at a time. Each thread
// computes the step constants once, while its first loads are in flight.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, VEC ? kBlocksPerSm : 2)
    adam_step_kernel(float* __restrict__ params, const float* __restrict__ grads,
                     float* __restrict__ first_moments, float* __restrict__ second_moments,
                     int32_t* __restrict__ param_steps, const int32_t* __restrict__ step, AdamHyperparams hp) {
  const int n = (int)hp.n;
  const int n_matrix = (int)(hp.n_matrix < hp.n ? hp.n_matrix : hp.n);
  const int stride = gridDim.x * blockDim.x;
  const int n4 = VEC ? n / 4 : 0;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  Vec x;
  if (i < n4) x = load_vec(params, grads, first_moments, second_moments, param_steps, i);
  const StepConstants sh = step_constants(hp, *step);
  for (; i < n4; i += stride) {
    Vec next;
    if (i + stride < n4) next = load_vec(params, grads, first_moments, second_moments, param_steps, i + stride);
    const int e = 4 * i;
    update(x.w.x, x.g.x, x.m.x, x.v.x, x.ps.x, e < n_matrix, hp, sh);
    update(x.w.y, x.g.y, x.m.y, x.v.y, x.ps.y, e + 1 < n_matrix, hp, sh);
    update(x.w.z, x.g.z, x.m.z, x.v.z, x.ps.z, e + 2 < n_matrix, hp, sh);
    update(x.w.w, x.g.w, x.m.w, x.v.w, x.ps.w, e + 3 < n_matrix, hp, sh);
    reinterpret_cast<float4*>(params)[i] = x.w;
    reinterpret_cast<float4*>(first_moments)[i] = x.m;
    reinterpret_cast<float4*>(second_moments)[i] = x.v;
    reinterpret_cast<int4*>(param_steps)[i] = x.ps;
    x = next;
  }
  for (int j = 4 * n4 + blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    update(params[j], grads[j], first_moments[j], second_moments[j], param_steps[j], j < n_matrix, hp, sh);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. `step` points to the device int32
// global step count after this step's increment; `hp` to a host struct
// (n below 2^31).
extern "C" int tcnn_adam_step(void* params, const void* grads, void* first_moments,
                              void* second_moments, void* param_steps, const void* step,
                              const void* hp, void* stream) {
  // Per device: the SM count, then the blocks of each instantiation an SM
  // holds at once.
  static int sms[kMaxDevices][3] = {};
  const AdamHyperparams h = *static_cast<const AdamHyperparams*>(hp);
  if (h.n <= 0) return 0;
  if (h.n > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(params) | reinterpret_cast<uintptr_t>(grads) |
                        reinterpret_cast<uintptr_t>(first_moments) | reinterpret_cast<uintptr_t>(second_moments) |
                        reinterpret_cast<uintptr_t>(param_steps);
  const bool vec = any % 16 == 0;
  auto* kernel = vec ? adam_step_kernel<true> : adam_step_kernel<false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int local[3] = {};
  int* info = dev < kMaxDevices ? sms[dev] : local;
  if (info[0] == 0) {
    err = cudaDeviceGetAttribute(&info[0], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int& per_sm = info[vec ? 1 : 2];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t items = vec ? (h.n + 3) / 4 : h.n;
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)info[0] * per_sm;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(params), static_cast<const float*>(grads), static_cast<float*>(first_moments),
      static_cast<float*>(second_moments), static_cast<int32_t*>(param_steps), static_cast<const int32_t*>(step), h);
  return (int)cudaGetLastError();
}

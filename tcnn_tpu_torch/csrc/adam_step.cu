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
// 3.35 TB/s.
//
// Design: one thread per parameter, in place (the outputs alias the inputs),
// hyperparameters in one struct passed by value, the global step read from
// the device so that no host synchronisation is needed.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

__global__ void adam_step_kernel(float* __restrict__ params, const float* __restrict__ grads,
                                 float* __restrict__ first_moments,
                                 float* __restrict__ second_moments,
                                 int32_t* __restrict__ param_steps, const int32_t* __restrict__ step,
                                 AdamHyperparams hp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hp.n) return;
  const bool is_matrix = i < hp.n_matrix;
  const float weight = params[i];
  float gradient = __fdiv_rn(grads[i], hp.loss_scale);

  bool active = is_matrix ? hp.optimize_matrix != 0 : hp.optimize_non_matrix != 0;
  if (hp.skip_zero_grad) active = active && (is_matrix || gradient != 0.0f);

  gradient = __fadd_rn(gradient, __fmul_rn(is_matrix ? hp.l2_reg : hp.non_matrix_l2_reg, weight));
  if (hp.gradient_clip != 0.0f) gradient = clampf(gradient, -hp.gradient_clip, hp.gradient_clip);

  const float m_old = first_moments[i];
  const float v_old = second_moments[i];
  const float first = __fadd_rn(__fmul_rn(hp.beta1, m_old), __fmul_rn(hp.one_minus_beta1, gradient));
  const float second = __fadd_rn(__fmul_rn(hp.beta2, v_old),
                                 __fmul_rn(__fmul_rn(hp.one_minus_beta2, gradient), gradient));

  const int32_t ps = param_steps[i] + (active ? 1 : 0);
  const float t = (float)(ps > 1 ? ps : 1);
  float lr = is_matrix ? hp.lr_matrix : hp.lr_non_matrix;
  lr = __fdiv_rn(__fmul_rn(lr, sqrtf(__fsub_rn(1.0f, powf(hp.beta2, t)))),
                 __fsub_rn(1.0f, powf(hp.beta1, t)));

  float lower = 0.0f;
  float upper = FLT_MAX;
  if (hp.adabound) {
    const float ts = (float)*step;
    lower = __fsub_rn(0.1f, __fdiv_rn(0.1f, __fadd_rn(__fmul_rn(hp.one_minus_beta2, ts), 1.0f)));
    upper = __fadd_rn(0.1f, __fdiv_rn(0.1f, __fmul_rn(hp.one_minus_beta2, ts)));
  }
  const float effective_lr = clampf(__fdiv_rn(lr, __fadd_rn(sqrtf(second), hp.epsilon)), lower, upper);

  const float sign = weight > 0.0f ? 1.0f : (weight < 0.0f ? -1.0f : 0.0f);
  const float decayed = __fsub_rn(__fmul_rn(__fsub_rn(1.0f, __fmul_rn(hp.relative_decay, lr)), weight),
                                  __fmul_rn(sign, __fmul_rn(hp.absolute_decay, lr)));
  float new_weight = __fsub_rn(decayed, __fmul_rn(effective_lr, first));
  if (hp.weight_clip != 0.0f) new_weight = clampf(new_weight, -hp.weight_clip, hp.weight_clip);

  if (active) {
    params[i] = new_weight;
    first_moments[i] = first;
    second_moments[i] = second;
  }
  param_steps[i] = ps;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise. `step` points to the device int32
// global step count after this step's increment; `hp` to a host struct.
extern "C" int tcnn_adam_step(void* params, const void* grads, void* first_moments,
                              void* second_moments, void* param_steps, const void* step,
                              const void* hp, void* stream) {
  const AdamHyperparams h = *static_cast<const AdamHyperparams*>(hp);
  if (h.n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((h.n + threads - 1) / threads);
  adam_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(params), static_cast<const float*>(grads),
      static_cast<float*>(first_moments), static_cast<float*>(second_moments),
      static_cast<int32_t*>(param_steps), static_cast<const int32_t*>(step), h);
  return (int)cudaGetLastError();
}

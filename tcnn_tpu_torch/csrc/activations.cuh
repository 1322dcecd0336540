// The ten activations of the fused MLP kernels and their derivatives, as
// device functions shared by ffmlp_fwd.cu and ffmlp_bwd.cu.
//
// Codes: tcnn_tpu_torch/networks/activations.py ACTIVATION_CODES. Forward
// formulas are those of tcnn_tpu/networks/activations.py; the derivatives
// are what JAX autodiff gives for them, with ReLU's taken as 0 at z == 0 as
// the JAX fused backward does (tcnn_tpu/ops/ffmlp.py:_act_vjp). Products
// and sums are written with the _rn intrinsics so that nvcc does not fuse
// them into multiply-adds the plain torch version does not have.

#pragma once

#include <cuda_runtime.h>

namespace tcnn_act {

constexpr float kAct = 10.0f;  // Squareplus / Softplus sharpness (K_ACT)

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 0: return x;                                          // None
    case 1: return fmaxf(x, 0.0f);                             // ReLU
    case 2: return __fmul_rn(x, x > 0.0f ? 1.0f : 0.01f);      // LeakyReLU
    case 3: return __fmul_rn(x, sigmoid_f(x));                 // SiLU
    case 4: return expf(x);                                    // Exponential
    case 5: return sinf(x);                                    // Sine
    case 6: return sigmoid_f(x);                               // Sigmoid
    case 7: {                                                  // Squareplus
      const float xk = __fmul_rn(x, kAct);
      const float r = sqrtf(__fadd_rn(__fmul_rn(xk, xk), 4.0f));
      return __fdiv_rn(__fmul_rn(0.5f, __fadd_rn(xk, r)), kAct);
    }
    case 8: {                                                  // Softplus
      const float xk = __fmul_rn(x, kAct);
      const float sp = __fadd_rn(fmaxf(xk, 0.0f), log1pf(expf(-fabsf(xk))));
      return __fdiv_rn(sp, kAct);
    }
    case 9: return tanhf(x);                                   // Tanh
    default: return x;
  }
}

// dL/dz given dL/da = g where a = activate(z, act).
__device__ __forceinline__ float activate_backward(float g, float z, int act) {
  switch (act) {
    case 0: return g;                                               // None
    case 1: return z > 0.0f ? g : 0.0f;                             // ReLU
    case 2: return __fmul_rn(g, z > 0.0f ? 1.0f : 0.01f);           // LeakyReLU
    case 3: {                                                       // SiLU
      const float s = sigmoid_f(z);
      const float ds = __fmul_rn(s, __fsub_rn(1.0f, s));
      return __fadd_rn(__fmul_rn(g, s), __fmul_rn(__fmul_rn(g, z), ds));
    }
    case 4: return __fmul_rn(g, expf(z));                           // Exponential
    case 5: return __fmul_rn(g, cosf(z));                           // Sine
    case 6: {                                                       // Sigmoid
      const float s = sigmoid_f(z);
      return __fmul_rn(g, __fmul_rn(s, __fsub_rn(1.0f, s)));
    }
    case 7: {                                                       // Squareplus
      const float xk = __fmul_rn(z, kAct);
      const float r = sqrtf(__fadd_rn(__fmul_rn(xk, xk), 4.0f));
      return __fmul_rn(g, __fmul_rn(0.5f, __fadd_rn(1.0f, __fdiv_rn(xk, r))));
    }
    case 8: return __fmul_rn(g, sigmoid_f(__fmul_rn(z, kAct)));     // Softplus
    case 9: {                                                       // Tanh
      const float t = tanhf(z);
      return __fmul_rn(g, __fsub_rn(1.0f, __fmul_rn(t, t)));
    }
    default: return g;
  }
}

}  // namespace tcnn_act

// Dynamics models the fused kernels take, as device functors: the
// continuous dynamics f(x, u, t) and its Jacobians ∂f/∂x, ∂f/∂u.
//
// The JAX kernels trace the model's Python function and differentiate it
// with jax.linearize (backward_fused_pallas.py:259-265); a CUDA kernel
// cannot, so each model is written here once and named by the Python model
// (`cuda_model`).  Held against torch.func.jacfwd of the Python model by the
// kernel-vs-plain checks.
#pragma once

#include <cuda_runtime.h>

namespace altro {

// Kinematic unicycle (altro_tpu/models/unicycle.py): x = (px, py, θ),
// u = (v, ω); ẋ = (v cosθ, v sinθ, ω).
struct Unicycle {
  static constexpr int n = 3;
  static constexpr int m = 2;

  template <typename T>
  __device__ __forceinline__ static void f(const T* x, const T* u, T /*t*/, T* xdot) {
    xdot[0] = u[0] * cos(x[2]);
    xdot[1] = u[0] * sin(x[2]);
    xdot[2] = u[1];
  }

  // A [n][n] = ∂f/∂x, Bc [n][m] = ∂f/∂u, row-major
  template <typename T>
  __device__ __forceinline__ static void jac(const T* x, const T* u, T /*t*/, T* A, T* Bc) {
    const T c = cos(x[2]);
    const T s = sin(x[2]);
#pragma unroll
    for (int i = 0; i < n * n; ++i) A[i] = T(0);
#pragma unroll
    for (int i = 0; i < n * m; ++i) Bc[i] = T(0);
    A[0 * n + 2] = -(u[0] * s);
    A[1 * n + 2] = u[0] * c;
    Bc[0 * m + 0] = c;
    Bc[1 * m + 0] = s;
    Bc[2 * m + 1] = T(1);
  }
};

}  // namespace altro

// Dynamics models the fused kernels take, as device functors: the
// continuous dynamics f(p, x, u, t), where p holds the model's parameters in
// the order of the Python model's `cuda_params` (AltroProblem.dyn, converted
// to the kernel's scalar type).  f is written once for any scalar S of the
// state and controls, so the same code evaluates the model (S = T) and one
// directional derivative of it (S = Dual<T>).
//
// The JAX kernels trace the model's Python function and differentiate it
// with jax.linearize (backward_fused_pallas.py:259-265); a CUDA kernel
// cannot, so each model is written here once and named by the Python model
// (`cuda_model`).  The fused backward kernel builds each column of the RK4
// Jacobian [A Bd] as one tangent (JVP) of the whole step
// (fused_common.cuh:dyn_tangent), the rule torch.func.jvp applies to the
// Python model (ops/backward_fused.py:step_jacobian_by_tangents).
//
// Each functor states its operation counts, which chip_smoke.py's bounds
// read through altro_model_ops(): kFOps for one evaluation of f, and
// kTangentOps for one directional derivative of f at a point whose value
// is known, the part of an evaluation in Dual that the tangent adds (as
// jax.linearize splits it).  Each add, multiply, divide, negate, sin and
// cos counts one; the tangent parts of the Dual rules below count Dual·Dual
// 3, T·Dual 1, Dual±Dual 1, Dual−T 0, −Dual 1, Dual/Dual 3 (the quotient is
// the value's), Dual/T 1, sin 1 and cos 2 (every model that takes sin or
// cos of an argument takes both, so f's value already holds them).
#pragma once

#include <cuda_runtime.h>

namespace altro {

// Forward-mode dual number: value v and one directional derivative d.  The
// math functions are hidden friends, so they are found only for Dual
// arguments and never hide the scalar sin / cos.
template <typename T>
struct Dual {
  T v, d;
  __device__ __forceinline__ Dual(T v_ = T(0), T d_ = T(0)) : v(v_), d(d_) {}

  friend __device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
  friend __device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
  friend __device__ __forceinline__ Dual operator-(Dual a, T b) { return Dual(a.v - b, a.d); }
  friend __device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
  friend __device__ __forceinline__ Dual operator*(Dual a, Dual b) {
    return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
  }
  friend __device__ __forceinline__ Dual operator*(T a, Dual b) { return Dual(a * b.v, a * b.d); }
  friend __device__ __forceinline__ Dual operator*(Dual a, T b) { return Dual(a.v * b, a.d * b); }
  friend __device__ __forceinline__ Dual operator/(Dual a, Dual b) {
    const T q = a.v / b.v;
    return Dual(q, (a.d - q * b.d) / b.v);
  }
  friend __device__ __forceinline__ Dual operator/(Dual a, T b) { return Dual(a.v / b, a.d / b); }
  friend __device__ __forceinline__ Dual sin(Dual a) { return Dual(sin(a.v), cos(a.v) * a.d); }
  friend __device__ __forceinline__ Dual cos(Dual a) { return Dual(cos(a.v), -(sin(a.v) * a.d)); }
};

// Kinematic unicycle (altro_tpu/models/unicycle.py): x = (px, py, θ),
// u = (v, ω); ẋ = (v cosθ, v sinθ, ω).  No parameters.
struct Unicycle {
  static constexpr int n = 3;
  static constexpr int m = 2;
  static constexpr int np = 0;
  static constexpr int kFOps = 4;        // cos, sin, 2 multiplies
  static constexpr int kTangentOps = 9;  // cos 2, sin 1, 2 Dual·Dual

  template <typename T, typename S>
  __device__ __forceinline__ static void f(const T* /*p*/, const S* x, const S* u, T /*t*/, S* xdot) {
    xdot[0] = u[0] * cos(x[2]);
    xdot[1] = u[0] * sin(x[2]);
    xdot[2] = u[1];
  }
};

// Cartpole (altro_tpu/models/cartpole.py): x = (p, θ, ṗ, θ̇), u = (force);
// p = (mass_cart, mass_pole, length, gravity).
struct Cartpole {
  static constexpr int n = 4;
  static constexpr int m = 1;
  static constexpr int np = 4;
  static constexpr int kFOps = 26;
  static constexpr int kTangentOps = 40;

  template <typename T, typename S>
  __device__ __forceinline__ static void f(const T* p, const S* x, const S* u, T /*t*/, S* xdot) {
    const T mc = p[0], mp = p[1], l = p[2], g = p[3];
    const S s = sin(x[1]);
    const S c = cos(x[1]);
    const S thdot2 = x[3] * x[3];
    const S denom = S(mc) + mp * (s * s);
    const S pddot = (u[0] + mp * s * (l * thdot2 + g * c)) / denom;
    const S thddot = (-u[0] * c - mp * l * thdot2 * c * s - (mc + mp) * g * s) / (l * denom);
    xdot[0] = x[2];
    xdot[1] = x[3];
    xdot[2] = pddot;
    xdot[3] = thddot;
  }
};

// Quadrotor (altro_tpu/models/quadrotor.py): x = (position 3, unit
// quaternion wxyz 4, world velocity 3, body rates 3), u = four rotor
// thrusts; p = (mass, J diagonal 3, gravity, kf, km, arm_length).
struct Quadrotor {
  static constexpr int n = 13;
  static constexpr int m = 4;
  static constexpr int np = 8;
  static constexpr int kFOps = 81;
  static constexpr int kTangentOps = 132;

  template <typename T, typename S>
  __device__ __forceinline__ static void f(const T* p, const S* x, const S* u, T /*t*/, S* xdot) {
    const T mass = p[0], g = p[4], kf = p[5], km = p[6], L = p[7];
    const T J[3] = {p[1], p[2], p[3]};
    const S qw = x[3], qx = x[4], qy = x[5], qz = x[6];
    const S* v = x + 7;
    const S* w = x + 10;
    // total thrust along body z and the torques
    const S Fz = kf * u[0] + kf * u[1] + kf * u[2] + kf * u[3];
    const S tau[3] = {
        L * kf * (u[1] - u[3]),
        L * kf * (u[2] - u[0]),
        km * (u[0] - u[1] + u[2] - u[3]),
    };
#pragma unroll
    for (int i = 0; i < 3; ++i) xdot[i] = v[i];
    // q̇ = ½ q ⊗ (0, ω)
    xdot[3] = T(0.5) * (-(qx * w[0]) - qy * w[1] - qz * w[2]);
    xdot[4] = T(0.5) * (qw * w[0] + qy * w[2] - qz * w[1]);
    xdot[5] = T(0.5) * (qw * w[1] - qx * w[2] + qz * w[0]);
    xdot[6] = T(0.5) * (qw * w[2] + qx * w[1] - qy * w[0]);
    // v̇ = (0, 0, -g) + R(q) (0, 0, Fz) / mass, with R(q)b = b + 2 q⃗ × (q⃗ × b + qw b)
    const S a0 = qy * Fz;          // (q⃗ × b)₀ + qw b₀ with b = (0, 0, Fz)
    const S a1 = -(qx * Fz);       // (q⃗ × b)₁ + qw b₁
    const S a2 = qw * Fz;          // (q⃗ × b)₂ + qw b₂
    const S r0 = T(2) * (qy * a2 - qz * a1);
    const S r1 = T(2) * (qz * a0 - qx * a2);
    const S r2 = Fz + T(2) * (qx * a1 - qy * a0);
    xdot[7] = r0 / mass;
    xdot[8] = r1 / mass;
    xdot[9] = r2 / mass - g;
    // ω̇ = J⁻¹ (τ − ω × Jω)
    const S Jw[3] = {J[0] * w[0], J[1] * w[1], J[2] * w[2]};
    xdot[10] = (tau[0] - (w[1] * Jw[2] - w[2] * Jw[1])) / J[0];
    xdot[11] = (tau[1] - (w[2] * Jw[0] - w[0] * Jw[2])) / J[1];
    xdot[12] = (tau[2] - (w[0] * Jw[1] - w[1] * Jw[0])) / J[2];
  }
};

// Triple integrator (altro_tpu/models/triple_integrator.py): x = (position,
// velocity, acceleration), DOF each, u = jerk (DOF); ẋ = (velocity,
// acceleration, jerk), linear, no parameters.  f only copies, so neither an
// evaluation nor a tangent adds an operation.
template <int DOF>
struct TripleIntegrator {
  static constexpr int n = 3 * DOF;
  static constexpr int m = DOF;
  static constexpr int np = 0;
  static constexpr int kFOps = 0;
  static constexpr int kTangentOps = 0;

  template <typename T, typename S>
  __device__ __forceinline__ static void f(const T* /*p*/, const S* x, const S* u, T /*t*/, S* xdot) {
#pragma unroll
    for (int i = 0; i < 2 * DOF; ++i) xdot[i] = x[DOF + i];
#pragma unroll
    for (int i = 0; i < DOF; ++i) xdot[2 * DOF + i] = u[i];
  }
};

// the instantiations the fused kernels' entry points name
using TripleIntegrator2 = TripleIntegrator<2>;

}  // namespace altro

// Problem evaluation shared by the fused backward and forward kernels: the
// quadratic cost and its expansion, the AL terms of the structured
// constraints, and the integrator step with its chain-rule Jacobian.
//
// Counterparts of _tile_quad / _tile_con_rows / _al_value
// (altro_tpu/ops/forward_pallas.py:431-532), _tile_quad_expansion /
// _tile_al_expansion (backward_fused_pallas.py:148-242) and _tile_dyn_step
// / _tile_dyn_jacobian (forward_pallas.py:361, backward_fused_pallas.py:
// 244-299), with one lane per thread in place of one (sub, 128) tile.
#pragma once

#include "altro_abi.h"
#include "lane_algebra.cuh"

namespace altro {

// ------------------------------------------------------------ costs
// One knot's cost row (see AltroCostFam) and the family row a knot reads
template <int n, int m>
struct CostRow {
  static constexpr int Q = 0, R = n * n, H = R + m * m, q = H + n * m, r = q + n, c = r + m;
  static constexpr int size = c + 1;
};

template <typename T, int n, int m>
__device__ __forceinline__ const T* cost_row(const T* tab, const AltroCostFam& f, int k) {
  return tab + f.offset + (f.stacked ? (k - f.k0) * CostRow<n, m>::size : 0);
}

// ½xᵀQx + xᵀHu + ½uᵀRu + qᵀx + rᵀu + c of one cost row, reading Q and R's
// upper triangle; u == nullptr drops the control terms (terminal knot)
template <typename T, int n, int m>
__device__ __forceinline__ T quad_value(const T* __restrict__ cr, const T* x, const T* u) {
  using L = CostRow<n, m>;
  T J = cr[L::c];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    J += cr[L::q + i] * x[i];
    J += T(0.5) * cr[L::Q + i * n + i] * x[i] * x[i];
#pragma unroll
    for (int j = i + 1; j < n; ++j) J += cr[L::Q + i * n + j] * x[i] * x[j];
  }
  if (u != nullptr) {
#pragma unroll
    for (int i = 0; i < m; ++i) {
      J += cr[L::r + i] * u[i];
      J += T(0.5) * cr[L::R + i * m + i] * u[i] * u[i];
#pragma unroll
      for (int j = i + 1; j < m; ++j) J += cr[L::R + i * m + j] * u[i] * u[j];
    }
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < m; ++j) J += cr[L::H + i * m + j] * x[i] * u[j];
    }
  }
  return J;
}

// gradient and Hessian of quad_value added into lx, lxx (and lu, lxu, luu
// when u != nullptr)
template <typename T, int n, int m>
__device__ __forceinline__ void quad_expand_add(const T* __restrict__ cr, const T* x, const T* u,
                                                T* lx, T* lu, T* lxx, T* lxu, T* luu) {
  using L = CostRow<n, m>;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T g = cr[L::q + i] + cr[L::Q + i * n + i] * x[i];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j != i) g += cr[L::Q + (i < j ? i : j) * n + (i < j ? j : i)] * x[j];
    }
    if (u != nullptr) {
#pragma unroll
      for (int j = 0; j < m; ++j) g += cr[L::H + i * m + j] * u[j];
    }
    lx[i] += g;
#pragma unroll
    for (int j = 0; j < n; ++j) lxx[i * n + j] += cr[L::Q + (i < j ? i : j) * n + (i < j ? j : i)];
  }
  if (u == nullptr) return;
#pragma unroll
  for (int i = 0; i < m; ++i) {
    T g = cr[L::r + i] + cr[L::R + i * m + i] * u[i];
#pragma unroll
    for (int j = 0; j < m; ++j) {
      if (j != i) g += cr[L::R + (i < j ? i : j) * m + (i < j ? j : i)] * u[j];
    }
#pragma unroll
    for (int j = 0; j < n; ++j) g += cr[L::H + j * m + i] * x[j];
    lu[i] += g;
#pragma unroll
    for (int j = 0; j < m; ++j) luu[i * m + j] += cr[L::R + (i < j ? i : j) * m + (i < j ? j : i)];
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < m; ++j) lxu[i * m + j] += cr[L::H + i * m + j];
  }
}

// ------------------------------------------------------------ AL terms
// One constraint row: AL value parts and, with EXP, its gradient weight
// w = dΠ·Π(λ−ρc) and Gauss-Newton weight hw = ρ·dΠ
// (constraint_values.hpp:111-177; diagonal cones).
template <typename T>
__device__ __forceinline__ void al_row(int cone, T lam, T rho, T c, T& acc, T& lam2, T& w, T& hw) {
  const T s = lam - rho * c;
  T proj, dp;
  if (cone == ALTRO_CONE_ZERO) {  // dual cone IDENTITY: Π = id
    proj = s;
    dp = T(1);
  } else {  // NEGATIVE_ORTHANT is self-dual; min keeps a NaN
    proj = (s > T(0)) ? T(0) : s;
    dp = (s <= T(0)) ? T(1) : T(0);
  }
  acc += proj * proj;
  lam2 += lam * lam;
  w = dp * proj;
  hw = rho * dp;
}

// AL value (‖Π(λ−ρc)‖² − ‖λ‖²)/2ρ of one family at one knot; with EXP
// its gradient and Gauss-Newton Hessian are added into lx, lu, lxx, luu.
// lam points at the family's first multiplier of this lane, rows `stride`
// apart; u == nullptr evaluates a control bound at u = 0 (terminal knot).
template <typename T, int n, int m, bool EXP>
__device__ __forceinline__ T al_family(const AltroConFam& f, const T* x, const T* u,
                                       const T* lam, long stride, T rho,
                                       T* lx, T* lu, T* lxx, T* luu) {
  T acc = T(0), lam2 = T(0), w, hw;
  if (f.kind == ALTRO_GOAL) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      al_row(f.cone, lam[i * stride], rho, x[i] - T(f.a[i]), acc, lam2, w, hw);
      if (EXP) {
        lx[i] -= w;
        lxx[i * n + i] += hw;
      }
    }
  } else {  // ALTRO_CONTROL_BOUND
    int r = 0;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      if ((f.lo_mask >> j) & 1) {
        const T uj = u != nullptr ? u[j] : T(0);
        al_row(f.cone, lam[r * stride], rho, T(f.a[j]) - uj, acc, lam2, w, hw);
        if (EXP && u != nullptr) {
          lu[j] += w;
          luu[j * m + j] += hw;
        }
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < m; ++j) {
      if ((f.hi_mask >> j) & 1) {
        const T uj = u != nullptr ? u[j] : T(0);
        al_row(f.cone, lam[r * stride], rho, uj - T(f.b[j]), acc, lam2, w, hw);
        if (EXP && u != nullptr) {
          lu[j] -= w;
          luu[j * m + j] += hw;
        }
        ++r;
      }
    }
  }
  return (acc - lam2) / (T(2) * rho);
}

// ------------------------------------------------------------ dynamics
// The model's parameters (AltroProblem.dyn) in the kernel's scalar type;
// every lane reads the same entries
template <typename T, class Model>
struct DynParams {
  T p[Model::np > 0 ? Model::np : 1];
  __device__ __forceinline__ explicit DynParams(const AltroProblem* pr) {
#pragma unroll
    for (int i = 0; i < Model::np; ++i) p[i] = T(pr->dyn[i]);
  }
};

// x_{k+1} of the RK4 (method 0) or explicit Euler (method 1) step
template <typename T, class Model>
__device__ __forceinline__ void dyn_step(int method, const T* p, const T* x, const T* u, T t, T h,
                                         T* xn) {
  constexpr int n = Model::n;
  T k1[n];
  Model::f(p, x, u, t, k1);
  if (method == 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) xn[i] = x[i] + h * k1[i];
    return;
  }
  T k2[n], k3[n], k4[n], xs[n];
#pragma unroll
  for (int i = 0; i < n; ++i) xs[i] = x[i] + T(0.5) * h * k1[i];
  Model::f(p, xs, u, t + T(0.5) * h, k2);
#pragma unroll
  for (int i = 0; i < n; ++i) xs[i] = x[i] + T(0.5) * h * k2[i];
  Model::f(p, xs, u, t + T(0.5) * h, k3);
#pragma unroll
  for (int i = 0; i < n; ++i) xs[i] = x[i] + h * k3[i];
  Model::f(p, xs, u, t + h, k4);
#pragma unroll
  for (int i = 0; i < n; ++i) xn[i] = x[i] + h * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]) / T(6);
}

// Discrete A [n][n], Bd [n][m] of the step by the chain rule over the four
// continuous Jacobians (integration.hpp:132-169), built stage by stage so
// that only one continuous Jacobian is live at a time.
template <typename T, class Model>
__device__ __forceinline__ void dyn_jacobian(int method, const T* p, const T* x, const T* u, T t,
                                             T h, T* A, T* Bd) {
  constexpr int n = Model::n;
  constexpr int m = Model::m;
  T Ac[n * n], Bc[n * m];
  Model::jac(p, x, u, t, Ac, Bc);
  if (method == 1) {
#pragma unroll
    for (int i = 0; i < n * n; ++i) A[i] = ((i % (n + 1)) == 0 ? T(1) : T(0)) + h * Ac[i];
#pragma unroll
    for (int i = 0; i < n * m; ++i) Bd[i] = h * Bc[i];
    return;
  }
  T kk[n], xs[n], dA[n * n], dB[n * m], M[n * n], tmpA[n * n], tmpB[n * m];
  // stage 1
#pragma unroll
  for (int i = 0; i < n * n; ++i) dA[i] = h * Ac[i];
#pragma unroll
  for (int i = 0; i < n * m; ++i) dB[i] = h * Bc[i];
#pragma unroll
  for (int i = 0; i < n * n; ++i) A[i] = dA[i];
#pragma unroll
  for (int i = 0; i < n * m; ++i) Bd[i] = dB[i];
  Model::f(p, x, u, t, kk);
  // stages 2..4: dA_s = h·A_s(I + c·dA_{s-1}), dB_s = h·B_s + c·h·A_s dB_{s-1}
#pragma unroll
  for (int s = 2; s <= 4; ++s) {
    const T c = (s == 4) ? T(1) : T(0.5);
    const T ts = (s == 4) ? t + h : t + T(0.5) * h;
#pragma unroll
    for (int i = 0; i < n; ++i) xs[i] = x[i] + c * h * kk[i];
    Model::jac(p, xs, u, ts, Ac, Bc);
    if (s < 4) Model::f(p, xs, u, ts, kk);
#pragma unroll
    for (int i = 0; i < n * n; ++i) M[i] = ((i % (n + 1)) == 0 ? T(1) : T(0)) + c * dA[i];
    mm<T, n, n, n>(Ac, M, tmpA);
    mm<T, n, n, m>(Ac, dB, tmpB);
    const T wgt = (s == 4) ? T(1) : T(2);
#pragma unroll
    for (int i = 0; i < n * n; ++i) {
      dA[i] = h * tmpA[i];
      A[i] += wgt * dA[i];
    }
#pragma unroll
    for (int i = 0; i < n * m; ++i) {
      dB[i] = h * Bc[i] + c * h * tmpB[i];
      Bd[i] += wgt * dB[i];
    }
  }
#pragma unroll
  for (int i = 0; i < n * n; ++i) A[i] = ((i % (n + 1)) == 0 ? T(1) : T(0)) + A[i] / T(6);
#pragma unroll
  for (int i = 0; i < n * m; ++i) Bd[i] = Bd[i] / T(6);
}

}  // namespace altro

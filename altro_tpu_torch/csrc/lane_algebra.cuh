// Per-lane arithmetic of the kernels: compensated sums, and the small
// Cholesky factorization and solve that every thread of a sweep group runs
// on its lane's m×m Quu (sweep_group.cuh), in registers.
//
// Counterpart of the unrolled tile helpers _chol and _chol_solve_mat of
// altro_tpu/ops/riccati_pallas.py:37-108.  Matrices are row-major arrays
// whose sizes are template constants, so every loop below unrolls and
// every entry lives in a register.
#pragma once

#include <cuda_runtime.h>

namespace altro {

// ------------------------------------------------------------ rounding
// Kahan summation and the compensated circle rows only work if the
// compiler neither contracts nor reorders their operations; the _rn
// intrinsics are never contracted into FMAs or reassociated, whatever the
// flags.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// J += term with compensation `comp` (forward_pallas.py:576-580)
template <typename T>
__device__ __forceinline__ void kahan_add(T& J, T& comp, T term) {
  const T y = sub_rn(term, comp);
  const T t = add_rn(J, y);
  comp = sub_rn(sub_rn(t, J), y);
  J = t;
}

// r² − dx² − dy² of one circle row in compensated arithmetic, the TPU
// kernel's _comp_circle (altro_tpu/ops/forward_pallas.py:457-492) operation
// for operation: Dekker-split squares (split constant 4097 in f32 and f64
// alike, as there) and error-free differences, the error terms summed and
// added last.  The plain f32 expression's error is ε·O(r²) absolute, which
// the AL penalties (up to 1e8) amplify; this one's is ε·|c|.  Every
// operation is an _rn intrinsic, so the rows equal the plain version's
// (ops/backward_fused.py:comp_circle) bit for bit.
template <typename T>
__device__ __forceinline__ void two_sq(T a, T& sq, T& err) {
  const T t = mul_rn(a, T(4097));
  const T hi = sub_rn(t, sub_rn(t, a));
  const T lo = sub_rn(a, hi);
  sq = mul_rn(a, a);
  err = add_rn(add_rn(sub_rn(mul_rn(hi, hi), sq), mul_rn(mul_rn(T(2), hi), lo)), mul_rn(lo, lo));
}

template <typename T>
__device__ __forceinline__ void two_diff(T a, T b, T& s, T& err) {
  s = sub_rn(a, b);
  const T bb = sub_rn(s, a);
  err = sub_rn(sub_rn(a, sub_rn(s, bb)), add_rn(b, bb));
}

template <typename T>
__device__ __forceinline__ T comp_circle(T dx, T dy, T r) {
  T r2, r2e, x2, x2e, y2, y2e, s1, e1, s2, e2;
  two_sq(r, r2, r2e);
  two_sq(dx, x2, x2e);
  two_sq(dy, y2, y2e);
  two_diff(r2, x2, s1, e1);
  two_diff(s1, y2, s2, e2);
  return add_rn(s2, add_rn(add_rn(sub_rn(sub_rn(r2e, x2e), y2e), e1), e2));
}

// max(s, lo) that keeps a NaN s, like jnp.maximum
template <typename T>
__device__ __forceinline__ T nan_max(T s, T lo) {
  return (s >= lo || s != s) ? s : lo;
}

// ------------------------------------------------------------ Cholesky
// Lower factor of M + diag_add·I in L (row-major, upper part unused).
// NaN-safe failure flag as in riccati_pallas._chol: NaN > 0 is false, so a
// non-finite pivot fails too; the pivot is floored at 1e-30 so a failed
// lane still produces finite numbers.
template <typename T, int M>
__device__ __forceinline__ bool chol(const T* Mat, T diag_add, T* L) {
  bool failed = false;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T s = Mat[j * M + j] + diag_add;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j * M + k] * L[j * M + k];
    failed |= !(s > T(0));
    const T dj = sqrt(nan_max(s, T(1e-30)));
    L[j * M + j] = dj;
    const T inv = T(1) / dj;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      T r = Mat[i * M + j];
#pragma unroll
      for (int k = 0; k < j; ++k) r = r - L[i * M + k] * L[j * M + k];
      L[i * M + j] = r * inv;
    }
  }
  return failed;
}

// X[M][R] solving (L Lᵀ) X = Rhs[M][R]
template <typename T, int M, int R>
__device__ __forceinline__ void chol_solve(const T* L, const T* Rhs, T* X) {
  T y[M * R];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      T acc = Rhs[i * R + c];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - L[i * M + k] * y[k * R + c];
      y[i * R + c] = acc / L[i * M + i];
    }
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      T acc = y[i * R + c];
#pragma unroll
      for (int k = i + 1; k < M; ++k) acc = acc - L[k * M + i] * X[k * R + c];
      X[i * R + c] = acc / L[i * M + i];
    }
  }
}

}  // namespace altro

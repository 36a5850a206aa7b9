// One knot of the Riccati backward sweep for one batch lane on one thread,
// the stand-alone sweep's (riccati.cu).  The fused backward kernel
// (backward_fused.cu:sweep_knot_group) runs the same statements, in the
// same order, on a group of threads per lane.
//
// Counterpart of the step body of altro_tpu/ops/riccati_pallas.py:_kernel
// (:138-178), which backward_fused_pallas.py reuses the same way: the Q
// terms, the Cholesky of Quu + ρI with the NaN-safe failure test, K and d,
// the bp_gain_limit guard, the P and p update reusing (Qxu K)ᵀ, and ΔV1,
// ΔV2.  P, p and ΔV freeze at the lane's first failure.
#pragma once

#include "lane_algebra.cuh"

namespace altro {

// Consumes the knot's expansion (A [n][n], Bd [n][m], lxx [n][n],
// lxu [n][m], luu [m][m], lx [n], lu [m], all row-major) and the carry
// (P, p, dv1, dv2, failed), which it updates; writes the knot's gains
// K [m][n] and d [m].
template <typename T, int n, int m>
__device__ __forceinline__ void riccati_step(const T* A, const T* Bd, const T* lxx, const T* lxu,
                                             const T* luu, const T* lx, const T* lu, T rho,
                                             T glim, T* P, T* p, T& dv1, T& dv2, bool& failed,
                                             T* K, T* d) {
  constexpr int w = n > m ? n : m;
  T AtP[n * n], Qxx[n * n], Qxu[n * m], Quu[m * m], Qx[n], Qu[m], tmp[w * w];
  mtm<T, n, n, n>(A, P, AtP);
  mm<T, n, n, n>(AtP, A, tmp);
#pragma unroll
  for (int i = 0; i < n * n; ++i) Qxx[i] = lxx[i] + tmp[i];
  mm<T, n, n, m>(AtP, Bd, tmp);
#pragma unroll
  for (int i = 0; i < n * m; ++i) Qxu[i] = lxu[i] + tmp[i];
  {
    T PB[n * m];
    mm<T, n, n, m>(P, Bd, PB);
    mtm<T, m, n, m>(Bd, PB, tmp);
  }
#pragma unroll
  for (int i = 0; i < m * m; ++i) Quu[i] = luu[i] + tmp[i];
  mtv<T, n, n>(A, p, tmp);
#pragma unroll
  for (int i = 0; i < n; ++i) Qx[i] = lx[i] + tmp[i];
  mtv<T, m, n>(Bd, p, tmp);
#pragma unroll
  for (int i = 0; i < m; ++i) Qu[i] = lu[i] + tmp[i];

  T L[m * m];
  bool fail_k = chol<T, m>(Quu, rho, L);
  {
    T QxuT[m * n];
#pragma unroll
    for (int i = 0; i < m; ++i) {
#pragma unroll
      for (int j = 0; j < n; ++j) QxuT[i * n + j] = Qxu[j * m + i];
    }
    chol_solve<T, m, n>(L, QxuT, K);
    chol_solve<T, m, 1>(L, Qu, d);
  }
  bool big = false;
#pragma unroll
  for (int i = 0; i < m * n; ++i) {
    K[i] = -K[i];
    big |= !(fabs(K[i]) <= glim);
  }
#pragma unroll
  for (int i = 0; i < m; ++i) {
    d[i] = -d[i];
    big |= !(fabs(d[i]) <= glim);
  }
  fail_k |= big;

  // cost-to-go (knot_point_function_type.hpp:220-230)
  T KtQuu[n * m], Pn[n * n], pn[n], QK[n * n];
  mtm<T, n, m, m>(K, Quu, KtQuu);
  {
    T v1[n], v2[n], v3[n];
    mv<T, n, m>(KtQuu, d, v1);
    mtv<T, n, m>(K, Qu, v2);
    mv<T, n, m>(Qxu, d, v3);
#pragma unroll
    for (int i = 0; i < n; ++i) pn[i] = Qx[i] + v1[i] + v2[i] + v3[i];
  }
  mm<T, n, m, n>(Qxu, K, QK);
  mm<T, n, m, n>(KtQuu, K, tmp);
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      Pn[i * n + j] = Qxx[i * n + j] + tmp[i * n + j] + QK[j * n + i] + QK[i * n + j];
    }
  }
  T dV1 = d[0] * Qu[0];
#pragma unroll
  for (int i = 1; i < m; ++i) dV1 += d[i] * Qu[i];
  T Qd[m];
  mv<T, m, m>(Quu, d, Qd);
  T dV2 = d[0] * Qd[0];
#pragma unroll
  for (int i = 1; i < m; ++i) dV2 += d[i] * Qd[i];
  dV2 = T(0.5) * dV2;

  failed = failed || fail_k;
  if (!failed) {
#pragma unroll
    for (int i = 0; i < n * n; ++i) P[i] = Pn[i];
#pragma unroll
    for (int i = 0; i < n; ++i) p[i] = pn[i];
    dv1 = dv1 + dV1;
    dv2 = dv2 + dV2;
  }
}

}  // namespace altro

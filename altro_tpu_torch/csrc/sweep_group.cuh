// One knot of the Riccati backward sweep for one batch lane on a group of
// threads: the step of both backward kernels, the fused one
// (backward_fused.cuh, over the expansions its producers build in shared
// memory) and the stand-alone one (riccati.cu, over materialized
// expansions staged in shared memory).  It is the only copy of the step.
//
// Counterpart of the step body of altro_tpu/ops/riccati_pallas.py:_kernel
// (:138-178), which backward_fused_pallas.py reuses the same way: the Q
// terms, the Cholesky of Quu + ρI with the NaN-safe failure test, K and d,
// the bp_gain_limit guard, the P and p update reusing (Qxu K)ᵀ, and ΔV1,
// ΔV2.  P, p and ΔV freeze at the lane's first failure.
//
// A group of G threads (sweep_group_size: one per row of P and the Q terms
// and one for d, a power of two) runs one lane; each output row is
// computed by the thread of its row r, every sum in the order of the
// one-thread step it replaced (AᵀP, then AᵀP·A and AᵀP·B, P·B, Bᵀ(PB),
// each a sum over j from 0).  The carry P, p and the Q terms the group
// shares live in the lane's scratch in shared memory (SweepScratch), so at
// n=13 a thread's share of a knot is one row and nothing spills.  The
// group lies within one warp, so __syncwarp orders its phases.
//
// Where the knot's A, Bd and quadratic terms come from is the caller's
// accessor `src`: A(i,j), Bd(i,j), lxx(r,c), lxu(r,c), luu(r,c), lx(r),
// lu(r), each the value of the knot and lane.
#pragma once

#include "lane_algebra.cuh"

namespace altro {

// Threads per lane in the sweep: one per row and one for d, a power of two
// (ops/backward_fused.py:sweep_group)
template <int n>
__host__ __device__ constexpr int sweep_group_size() {
  return n < 4 ? 4 : n < 8 ? 8 : 16;
}

// One lane's scratch of the sweep, in values: the carry P, p and the terms
// the group shares.  ops/backward_fused.py:sweep_scratch mirrors it.
template <int n, int m>
struct SweepScratch {
  static constexpr int P = 0, p = P + n * n, PB = p + n, Quu = PB + n * m, Qu = Quu + m * m,
                       K = Qu + m, d = K + m * n, QK = d + m;
  static constexpr int size = QK + n * n;
};

// ΔV1, ΔV2 and the failure flag of one lane, on each thread of its group
template <typename T>
struct SweepCarry {
  T dv1 = T(0), dv2 = T(0);
  bool failed = false;
};

// `flag` OR-ed over this thread's group of G threads (tid / G), on every
// thread of it.  The whole warp takes part: call it from every thread of
// the warp, never behind a condition that differs between them.
template <int G>
__device__ __forceinline__ bool group_any(bool flag) {
  static_assert(32 % G == 0, "groups in whole warps");
  const unsigned lane = threadIdx.x % 32;
  const unsigned gmask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (lane / G * G);
  return (__ballot_sync(0xffffffffu, flag) & gmask) != 0u;
}

// P_N, p_N into the lane's scratch `sc` from the terminal knot's lxx, lx
template <typename T, int n, int m, class Src>
__device__ __forceinline__ void sweep_terminal_group(const Src& src, T* sc, int r) {
  using S = SweepScratch<n, m>;
  if (r < n) {
#pragma unroll
    for (int j = 0; j < n; ++j) sc[S::P + r * n + j] = src.lxx(r, j);
    sc[S::p + r] = src.lx(r);
  }
  __syncwarp();
}

// Knot k of lane b (row r of its group): updates the carry in `sc` and
// `cy`, and writes the knot's gains into Ko [N, m, n, B], dout [N, m, B]
// when b < B.  Every thread computes the m×m Cholesky of the same Quu and
// so the same failure flag; the gain guard's flag is OR-ed over the group.
template <typename T, int n, int m, class Src>
__device__ __forceinline__ void sweep_knot_group(const Src& src, T* sc, T rho, T glim,
                                                 SweepCarry<T>& cy, int r, T* Ko, T* dout, int k,
                                                 int b, int B) {
  using S = SweepScratch<n, m>;
  constexpr int G = sweep_group_size<n>();
  static_assert(G > n && 32 % G == 0, "one thread per row and one for d, in whole warps");
  T* P = sc + S::P;
  T* p = sc + S::p;
  T* PB = sc + S::PB;
  T* Quu = sc + S::Quu;
  T* Qu = sc + S::Qu;
  T* K = sc + S::K;
  T* d = sc + S::d;
  T* QK = sc + S::QK;

  // Qx[r], Qu, PB; row r of AᵀP, which only this thread reads
  T atp[n], qx = T(0);
  if (r < n) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      T acc = src.A(0, r) * P[c];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += src.A(j, r) * P[j * n + c];
      atp[c] = acc;
    }
#pragma unroll
    for (int c = 0; c < m; ++c) {
      T acc = P[r * n] * src.Bd(0, c);
#pragma unroll
      for (int j = 1; j < n; ++j) acc += P[r * n + j] * src.Bd(j, c);
      PB[r * m + c] = acc;
    }
    T acc = src.A(0, r) * p[0];
#pragma unroll
    for (int j = 1; j < n; ++j) acc += src.A(j, r) * p[j];
    qx = src.lx(r) + acc;
  }
  if (r < m) {
    T acc = src.Bd(0, r) * p[0];
#pragma unroll
    for (int j = 1; j < n; ++j) acc += src.Bd(j, r) * p[j];
    Qu[r] = src.lu(r) + acc;
  }
  __syncwarp();

  // rows r of Qxx = lxx + AᵀPA and Qxu = lxu + AᵀPB (this thread's only); Quu
  T qxx[n], qxu[m];
  if (r < n) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const T l = src.lxx(r, c);
      T acc = atp[0] * src.A(0, c);
#pragma unroll
      for (int j = 1; j < n; ++j) acc += atp[j] * src.A(j, c);
      qxx[c] = l + acc;
    }
#pragma unroll
    for (int c = 0; c < m; ++c) {
      const T l = src.lxu(r, c);
      T acc = atp[0] * src.Bd(0, c);
#pragma unroll
      for (int j = 1; j < n; ++j) acc += atp[j] * src.Bd(j, c);
      qxu[c] = l + acc;
    }
  }
  if (r < m) {
#pragma unroll
    for (int c = 0; c < m; ++c) {
      const T l = src.luu(r, c);
      T acc = src.Bd(0, r) * PB[c];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += src.Bd(j, r) * PB[j * m + c];
      Quu[r * m + c] = l + acc;
    }
  }
  __syncwarp();

  // Cholesky of Quu + ρI on every thread; column r of K (rhs: row r of
  // Qxu), d on thread n; the gain guard
  T Lc[m * m];
  const bool fail_chol = chol<T, m>(Quu, rho, Lc);
  bool big = false;
  if (r <= n) {
    T rhs[m], sol[m];
#pragma unroll
    for (int i = 0; i < m; ++i) rhs[i] = r < n ? qxu[i] : Qu[i];
    chol_solve<T, m, 1>(Lc, rhs, sol);
#pragma unroll
    for (int i = 0; i < m; ++i) {
      sol[i] = -sol[i];
      big |= !(fabs(sol[i]) <= glim);
      if (r < n) {
        K[i * n + r] = sol[i];
      } else {
        d[i] = sol[i];
      }
    }
  }
  const bool any_big = group_any<G>(big);
  const bool fail_k = fail_chol || any_big;
  __syncwarp();

  // p update and rows r of (Qxu K) and KᵀQuu K; ΔV on every thread
  T pn = T(0), ktqk[n];
  if (r < n) {
    T ktq[m];
#pragma unroll
    for (int c = 0; c < m; ++c) {
      T acc = K[r] * Quu[c];
#pragma unroll
      for (int j = 1; j < m; ++j) acc += K[j * n + r] * Quu[j * m + c];
      ktq[c] = acc;
    }
    T v1 = ktq[0] * d[0], v2 = K[r] * Qu[0], v3 = qxu[0] * d[0];
#pragma unroll
    for (int j = 1; j < m; ++j) {
      v1 += ktq[j] * d[j];
      v2 += K[j * n + r] * Qu[j];
      v3 += qxu[j] * d[j];
    }
    pn = qx + v1 + v2 + v3;
#pragma unroll
    for (int c = 0; c < n; ++c) {
      T acc = qxu[0] * K[c], acc2 = ktq[0] * K[c];
#pragma unroll
      for (int j = 1; j < m; ++j) {
        acc += qxu[j] * K[j * n + c];
        acc2 += ktq[j] * K[j * n + c];
      }
      QK[r * n + c] = acc;
      ktqk[c] = acc2;
    }
  }
  T dV1 = d[0] * Qu[0];
#pragma unroll
  for (int i = 1; i < m; ++i) dV1 += d[i] * Qu[i];
  T dV2 = T(0);
#pragma unroll
  for (int i = 0; i < m; ++i) {
    T qd = Quu[i * m] * d[0];
#pragma unroll
    for (int j = 1; j < m; ++j) qd += Quu[i * m + j] * d[j];
    dV2 = i == 0 ? d[0] * qd : dV2 + d[i] * qd;
  }
  dV2 = T(0.5) * dV2;
  __syncwarp();

  // P, p (frozen at the first failure), the gains out
  cy.failed = cy.failed || fail_k;
  if (r < n && !cy.failed) {
#pragma unroll
    for (int c = 0; c < n; ++c) P[r * n + c] = qxx[c] + ktqk[c] + QK[c * n + r] + QK[r * n + c];
    p[r] = pn;
  }
  if (!cy.failed) {
    cy.dv1 = cy.dv1 + dV1;
    cy.dv2 = cy.dv2 + dV2;
  }
  if (b < B && r <= n) {
    const long Bl = B;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      if (r < n) {
        Ko[((long(k) * m + i) * n + r) * Bl + b] = K[i * n + r];
      } else {
        dout[(long(k) * m + i) * Bl + b] = d[i];
      }
    }
  }
  __syncwarp();
}

}  // namespace altro

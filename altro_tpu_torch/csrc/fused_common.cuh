// Problem evaluation shared by the fused backward and forward kernels: the
// quadratic cost and its expansion, the AL terms of the structured
// constraints (goal, control bound, circle), the integrator step and its tangents, and the staging of
// the problem descriptor and of device rows into shared memory.
//
// Counterparts of _tile_quad / _tile_con_rows / _al_value
// (altro_tpu/ops/forward_pallas.py:431-532), _tile_quad_expansion /
// _tile_al_expansion (backward_fused_pallas.py:148-242) and _tile_dyn_step
// / _tile_dyn_jacobian (forward_pallas.py:361, backward_fused_pallas.py:
// 244-299), with one lane (or one Jacobian column of a lane) per thread in
// place of one (sub, 128) tile.
#pragma once

#include "altro_abi.h"
#include "lane_algebra.cuh"
#include "models.cuh"

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

// A cost row of the lane-params instantiations: each leaf (Q, R, H, q, r,
// c) from the cost table's row, or from this lane's staged rows when it is
// the lane's own (lane[leaf]: its entry 0, entries L apart).  Indexed as a
// row is; the index is a constant once the loops are unrolled, so the leaf
// it falls in is too.
template <typename T, int n, int m>
struct LaneCostRow {
  const T* tab;
  const T* lane[6];
  int L;
  __device__ __forceinline__ T operator[](int idx) const {
    using C = CostRow<n, m>;
    const int leaf = idx < C::R ? 0 : idx < C::H ? 1 : idx < C::q ? 2 : idx < C::r ? 3 : idx < C::c ? 4 : 5;
    const int start = leaf == 0 ? C::Q : leaf == 1 ? C::R : leaf == 2 ? C::H : leaf == 3 ? C::q
                      : leaf == 4 ? C::r : C::c;
    return lane[leaf] != nullptr ? lane[leaf][(idx - start) * L] : tab[idx];
  }
};

// One lane's staged lane rows (csrc/altro_abi.h:AltroLanes): its knot's
// per-knot rows (row w at knot[w * L]) and the static rows (row s at
// stat[s * L])
template <typename T>
struct LaneView {
  const T* knot;
  const T* stat;
  int L;
  // the lane's entry 0 of the leaf at `src`, or nullptr for a shared leaf
  __device__ __forceinline__ const T* at(const AltroLaneSrc& src) const {
    return src.off < 0 ? nullptr : (src.kstride != 0 ? knot : stat) + src.off * L;
  }
};

// cost family fi's row at knot k as the lane reads it
template <typename T, int n, int m>
__device__ __forceinline__ LaneCostRow<T, n, m> lane_cost_row(const AltroLanes& ln, const LaneView<T>& v,
                                                              const T* tab_row, int fi) {
  LaneCostRow<T, n, m> r;
  r.tab = tab_row;
  r.L = v.L;
#pragma unroll
  for (int leaf = 0; leaf < 6; ++leaf) r.lane[leaf] = v.at(ln.cost[fi][leaf]);
  return r;
}

// Q[i][j], R[i][j] of a cost row, read from the upper triangle
template <typename T, int n, int m, class Row = const T*>
__device__ __forceinline__ T quad_Q(const Row cr, int i, int j) {
  return cr[CostRow<n, m>::Q + (i < j ? i : j) * n + (i < j ? j : i)];
}
template <typename T, int n, int m, class Row = const T*>
__device__ __forceinline__ T quad_R(const Row cr, int i, int j) {
  return cr[CostRow<n, m>::R + (i < j ? i : j) * m + (i < j ? j : i)];
}

// ½xᵀQx + xᵀHu + ½uᵀRu + qᵀx + rᵀu + c of one cost row (the table's, or a
// LaneCostRow), reading Q and R's upper triangle; u == nullptr drops the
// control terms (terminal knot)
template <typename T, int n, int m, class Row>
__device__ __forceinline__ T quad_value(const Row cr, const T* x, const T* u) {
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

// gradient of quad_value added into lx (and lu when u != nullptr)
template <typename T, int n, int m, class Row>
__device__ __forceinline__ void quad_grad_add(const Row cr, const T* x, const T* u, T* lx, T* lu) {
  using L = CostRow<n, m>;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T g = cr[L::q + i] + cr[L::Q + i * n + i] * x[i];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j != i) g += quad_Q<T, n, m, Row>(cr, i, j) * x[j];
    }
    if (u != nullptr) {
#pragma unroll
      for (int j = 0; j < m; ++j) g += cr[L::H + i * m + j] * u[j];
    }
    lx[i] += g;
  }
  if (u == nullptr) return;
#pragma unroll
  for (int i = 0; i < m; ++i) {
    T g = cr[L::r + i] + cr[L::R + i * m + i] * u[i];
#pragma unroll
    for (int j = 0; j < m; ++j) {
      if (j != i) g += quad_R<T, n, m, Row>(cr, i, j) * u[j];
    }
#pragma unroll
    for (int j = 0; j < n; ++j) g += cr[L::H + j * m + i] * x[j];
    lu[i] += g;
  }
}

// rows[fi]: the row of cost family fi if its Hessian enters knot k of the
// sweep (a stage family over k for k < N, a terminal family for k == N),
// else nullptr.  Indexed by the family, so unrolled loops over
// ALTRO_MAX_FAMS keep the pointers in registers.
template <typename T, int n, int m>
__device__ __forceinline__ void cost_rows_at(const AltroProblem& pr, const T* tab, int k,
                                             const T* (&rows)[ALTRO_MAX_FAMS]) {
  const int N = pr.N;
#pragma unroll
  for (int fi = 0; fi < ALTRO_MAX_FAMS; ++fi) {
    const AltroCostFam& f = pr.cost[fi];
    const bool on = fi < pr.n_cost &&
                    (k == N ? f.k1 == N : (f.k0 <= k && k <= (f.k1 < N - 1 ? f.k1 : N - 1)));
    rows[fi] = on ? cost_row<T, n, m>(tab, f, k) : nullptr;
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

// The circle rows' expansion terms of a knot, summed over the rows of
// every circle family: the gradient's entries at xi and yi, the
// Gauss-Newton diagonal's, and the off-diagonal term at (xi, yi) and
// (yi, xi).  The fused backward kernel adds them into the knot's slot in
// shared memory, where xi and yi may index at run time: register arrays
// indexed so would be moved to local memory.
template <typename T>
struct CircleTerms {
  T gx = T(0), gy = T(0), hxx = T(0), hyy = T(0), hxy = T(0);
};

// The lane's own constraint params of the lane-params instantiations: for
// each of AltroConFam's a, b, r, the lane's entry 0 (entries L apart), or
// nullptr where the family's is shared
template <typename T>
struct LaneCon {
  const T* p[3] = {nullptr, nullptr, nullptr};
  int L = 0;
};

// constraint family fi's LaneCon as the lane reads it (empty without LP)
template <typename T, bool LP>
__device__ __forceinline__ LaneCon<T> lane_con(const AltroLanes* ln, const LaneView<T>& v, int fi) {
  LaneCon<T> c;
  if constexpr (LP) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.p[j] = v.at(ln->con[fi][j]);
    c.L = v.L;
  }
  return c;
}

// AL value (‖Π(λ−ρc)‖² − ‖λ‖²)/2ρ of one family at one knot; with EXP
// its gradient is added into lx, lu and its Gauss-Newton Hessian into hx,
// hu (the goal and control-bound Hessians are diagonal), and a circle
// family's terms into `ct`.  lam points at the family's first multiplier
// of this lane, rows `stride` apart; u == nullptr evaluates a control
// bound at u = 0 (terminal knot).  With LP, the params in `lc` are the
// lane's own.
template <typename T, int n, int m, bool EXP, bool LP = false>
__device__ __forceinline__ T al_family(const AltroConFam& f, const T* x, const T* u,
                                       const T* lam, long stride, T rho,
                                       T* lx, T* lu, T* hx, T* hu, CircleTerms<T>* ct,
                                       const LaneCon<T>& lc = LaneCon<T>()) {
  // entry i of the family's param a, b or r (which = 0, 1, 2)
  const auto par = [&](int which, int i) -> T {
    if constexpr (LP) {
      if (lc.p[which] != nullptr) return lc.p[which][i * lc.L];
    }
    return T(which == 0 ? f.a[i] : which == 1 ? f.b[i] : f.r[i]);
  };
  T acc = T(0), lam2 = T(0), w, hw;
  if (f.kind == ALTRO_GOAL) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      al_row(f.cone, lam[i * stride], rho, x[i] - par(0, i), acc, lam2, w, hw);
      if (EXP) {
        lx[i] -= w;
        hx[i] += hw;
      }
    }
  } else if (f.kind == ALTRO_CIRCLE) {
    // c = r² − dx² − dy²: C_x = (−2dx, −2dy) at (xi, yi)
    // (backward_fused_pallas.py:225-240).  x[xi] and x[yi] as masked
    // sums, which keep x in registers (exact for a finite x).
    T px = T(0), py = T(0);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      px += T(i == f.xi) * x[i];
      py += T(i == f.yi) * x[i];
    }
    T gx = T(0), gy = T(0), hxx = T(0), hyy = T(0), hxy = T(0);
    for (int o = 0; o < f.p; ++o) {
      const T dx = px - par(0, o), dy = py - par(1, o);
      al_row(f.cone, lam[o * stride], rho, comp_circle(dx, dy, par(2, o)), acc, lam2, w, hw);
      if (EXP) {
        gx += T(2) * dx * w;
        gy += T(2) * dy * w;
        hxx += T(4) * hw * dx * dx;
        hyy += T(4) * hw * dy * dy;
        hxy += T(4) * hw * dx * dy;
      }
    }
    if (EXP) {
      ct->gx += gx;
      ct->gy += gy;
      ct->hxx += hxx;
      ct->hyy += hyy;
      ct->hxy += hxy;
    }
  } else {  // ALTRO_CONTROL_BOUND
    int r = 0;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      if ((f.lo_mask >> j) & 1) {
        const T uj = u != nullptr ? u[j] : T(0);
        al_row(f.cone, lam[r * stride], rho, par(0, j) - uj, acc, lam2, w, hw);
        if (EXP && u != nullptr) {
          lu[j] += w;
          hu[j] += hw;
        }
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < m; ++j) {
      if ((f.hi_mask >> j) & 1) {
        const T uj = u != nullptr ? u[j] : T(0);
        al_row(f.cone, lam[r * stride], rho, uj - par(1, j), acc, lam2, w, hw);
        if (EXP && u != nullptr) {
          lu[j] -= w;
          hu[j] += hw;
        }
        ++r;
      }
    }
  }
  return (acc - lam2) / (T(2) * rho);
}

// ------------------------------------------------------------ dynamics
// The model's parameters (AltroProblem.dyn) in the kernel's scalar type;
// every lane reads the same entries, or with lanes each its own where a
// parameter is per lane (`stat`: the lane's static lane rows, L apart)
template <typename T, class Model>
struct DynParams {
  T p[Model::np > 0 ? Model::np : 1];
  __device__ __forceinline__ explicit DynParams(const AltroProblem& pr) {
#pragma unroll
    for (int i = 0; i < Model::np; ++i) p[i] = T(pr.dyn[i]);
  }
  __device__ __forceinline__ DynParams(const AltroProblem& pr, const AltroLanes& ln, const T* stat, int L) {
#pragma unroll
    for (int i = 0; i < Model::np; ++i) {
      p[i] = ln.dyn[i].off >= 0 ? stat[ln.dyn[i].off * L] : T(pr.dyn[i]);
    }
  }
};

// x_{k+1} of the RK4 (method 0) or explicit Euler (method 1) step; S is the
// scalar T, or Dual<T> for the step's tangent
template <typename T, class Model, typename S>
__device__ __forceinline__ void dyn_step(int method, const T* p, const S* x, const S* u, T t, T h,
                                         S* xn) {
  constexpr int n = Model::n;
  S k[n], acc[n], xs[n];
  Model::f(p, x, u, t, k);
  if (method == 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) xn[i] = x[i] + h * k[i];
    return;
  }
  // acc = ((k1 + 2k2) + 2k3) + k4, summed as the stages finish so that only
  // one stage derivative is live at a time
#pragma unroll
  for (int i = 0; i < n; ++i) {
    acc[i] = k[i];
    xs[i] = x[i] + T(0.5) * h * k[i];
  }
  Model::f(p, xs, u, t + T(0.5) * h, k);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    acc[i] = acc[i] + T(2) * k[i];
    xs[i] = x[i] + T(0.5) * h * k[i];
  }
  Model::f(p, xs, u, t + T(0.5) * h, k);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    acc[i] = acc[i] + T(2) * k[i];
    xs[i] = x[i] + h * k[i];
  }
  Model::f(p, xs, u, t + h, k);
#pragma unroll
  for (int i = 0; i < n; ++i) xn[i] = x[i] + h * (acc[i] + k[i]) / T(6);
}

// Column j of the step's Jacobian [A Bd] (j < n: column j of A; else column
// j − n of Bd): the tangent of the whole step along e_j, one Dual pass
// through its stages.  Through the four RK4 stages this is the TPU kernel's
// chain rule (integration.hpp:132-169) taken one column at a time:
// dA_s e_j = h·A_s(e_j + c·dA_{s−1} e_j), dB_s e_j = h·(B_s e_j + c·A_s dB_{s−1} e_j).
template <typename T, class Model>
__device__ __forceinline__ void dyn_tangent(int method, const T* p, const T* x, const T* u, T t,
                                            T h, int j, T* col) {
  constexpr int n = Model::n;
  constexpr int m = Model::m;
  Dual<T> xd[n], ud[m], xn[n];
#pragma unroll
  for (int i = 0; i < n; ++i) xd[i] = Dual<T>(x[i], i == j ? T(1) : T(0));
#pragma unroll
  for (int i = 0; i < m; ++i) ud[i] = Dual<T>(u[i], n + i == j ? T(1) : T(0));
  dyn_step<T, Model>(method, p, xd, ud, t, h, xn);
#pragma unroll
  for (int i = 0; i < n; ++i) col[i] = xn[i].d;
}

// ------------------------------------------------------------ staging
__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// bar.sync on named barrier `id` by `nthreads` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// `words` 32-bit words from device to shared memory, by the threads
// tid = 0 .. nthreads-1 together
__device__ __forceinline__ void block_copy(void* dst, const void* src, int words, int tid,
                                           int nthreads) {
  for (int i = tid; i < words; i += nthreads) {
    static_cast<int*>(dst)[i] = static_cast<const int*>(src)[i];
  }
}

// The problem descriptor and the cost table's first `tab_smem` entries in
// shared memory at `desc` and `tab`; returns the table the kernel reads
// (shared, or device memory when it was not staged).  Ends with a barrier.
template <typename T>
__device__ __forceinline__ const T* stage_problem(AltroProblem* desc, T* tab, const AltroProblem* pr,
                                                  const T* ctab, int tab_smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  block_copy(desc, pr, int(sizeof(AltroProblem) / 4), tid, nt);
  block_copy(tab, ctab, int(tab_smem * sizeof(T) / 4), tid, nt);
  __syncthreads();
  return tab_smem > 0 ? tab : ctab;
}

// cp.async of BYTES (4, 8 or 16) from device to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem_src), "n"(BYTES)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace altro

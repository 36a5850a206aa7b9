// Fused expansion + Riccati backward sweep: a block owns `lanes` batch
// lanes and walks their horizon backwards in chunks of `knots` knots, with
// the expansions of one chunk built while the sweep consumes the chunk
// before it.
//
// Replaces the TPU kernel BackwardFusedKernel._make_kernel
// (altro_tpu/ops/backward_fused_pallas.py:302-531, launched by _get_call
// :533-558).  Per lane, sweeping k = N-1 ... 0: the terminal expansion gives
// P_N, p_N (and the terminal cost into J); at each knot the quadratic-cost
// gradient and Hessian, the AL Gauss-Newton terms of the goal,
// control-bound and circle rows (the circle rows in compensated
// arithmetic, with their off-diagonal term), and the RK4 A, B; then the Q
// terms, the Cholesky of Quu + ρI with a NaN-safe failure flag, K and d,
// the gain guard, and the P, p update reusing (Qxu K)ᵀ.  ΔV1, ΔV2 and P, p freeze at a lane's first
// failure; J0 is a Kahan sum over the terminal terms, then k = N-1 ... 0.
// A pure function of its inputs and ρ, so the regularization retry loop can
// relaunch it.
//
// The model is a device functor of csrc/models.cuh, a template parameter;
// the kernel is instantiated for the unicycle, the cartpole and the
// quadrotor in f32 and f64 (entry points in backward_fused.cu and
// backward_fused_lanes.cu, which nvcc builds in parallel).
//
// What bounds it on the H100: the dependent chain of each lane's sweep,
// N Riccati steps in a row; the bytes (X, U, λ in; K, d out: 30 MB at
// B=4096, N=100 in f32, 9 µs at 3.35 TB/s) and the operations (dominated by
// the n+m Jacobian tangents per knot) are far below it.  So the design
// takes everything that does not depend on the carry (P, p) off that chain
// and fills the card with short chains:
//   - Producer warps build each knot's expansion in parallel over (lane,
//     knot, column): the cost value and gradient, the AL gradient, its
//     diagonal Gauss-Newton weights and the circle rows' one off-diagonal
//     weight, and each column of [A Bd] as one tangent of the RK4 step
//     (fused_common.cuh:dyn_tangent, 17 parallel columns at n=13).  They stage the chunk's x, u in shared memory
//     first, then write the expansions into one of two shared buffers.
//   - Consumer warps run the sweep over the other buffer, a group of
//     threads per lane (4 for the unicycle, 8 for the cartpole, 16 for the
//     quadrotor): one per row of P and the Q terms, which live in shared
//     memory, plus one for d, so a thread's share of a knot is one row and
//     at n=13 nothing spills to local memory (on one thread per lane the
//     n=13 sweep kept 13.7 KB per thread there).  The step is
//     sweep_group.cuh:sweep_knot_group, which riccati.cu runs too; this
//     kernel's accessor (FusedKnot) gives it the knot's slot.
//   - The cost Hessians Q, R, H are the same for every lane: the accessor
//     sums them from the cost table, staged once per block in shared
//     memory with the problem descriptor; per lane only what depends on it
//     is stored.
//   - Blocks of 8 lanes: B=2048 launches 256 blocks on 132 SMs.
// Launch geometry and the shared-memory layout come from the wrapper
// (ops/backward_fused.py:FusedKernel.geometry, AltroGeometry).
//
// Per-instance params (altro_abi.h:AltroLanes) reach a second instantiation
// per model and scalar type, backward_fused_lanes_kernel: the producers
// stage a knot's lane rows beside its x and u (the static rows once a
// block), take each lane's own dynamics params, cost rows and constraint
// params from them, and write the sums of the knot's cost Hessians into the
// slot, which the sweep's accessor reads in place of the cost table's rows:
// the same sums in the same order, so lanes whose per-lane leaves hold the
// shared values get the shared launch's bits.  Both kernels are the one
// body (LP = false / true); the shared-param kernel compiles to what it
// compiled to before.
//
// Measured on an H100 (chip_smoke.py kernel_scaling, PERF.md): the unicycle
// and cartpole instances stay flat in B up to 4096, a block's pipelined
// chunks taking about 3 µs per knot, the producers' Dual trig and the
// sweep's barriers being of one size there; at n=13 the kernel takes 255
// registers a thread, so one 256-thread block fills a multiprocessor and
// the time grows with B from 1024 on.  nvcc -Xptxas=-v, registers / stack
// bytes / spill-store bytes: unicycle f32 80 / 40 / 0, f64 128 / 64 / 0;
// cartpole f32 105 / 32 / 0, f64 128 / 72 / 24; quadrotor f32 255 / 16 / 0,
// f64 255 / 448 / 534.  The circle branch indexes only shared memory at
// run time (xi, yi): register arrays indexed so go to local memory.
#pragma once

#include <cuda_runtime.h>

#include "altro_abi.h"
#include "fused_common.cuh"
#include "models.cuh"
#include "sweep_group.cuh"

namespace altro {

constexpr int kBwdMaxThreads = 256;
constexpr int kTerms = 2 * ALTRO_MAX_FAMS;  // J terms of a knot: cost families, then constraint families

// Shared memory of one block: the descriptor, the cost table, the chunk's
// x, u, two expansion buffers of knots × lanes slots, and the sweep's
// per-lane scratch (sweep_group.cuh:SweepScratch).  The lane-params
// instantiation (LP) adds the lanes descriptor after the problem's, the
// chunk's W lane rows per knot after its x, u, the cost Hessians' sums in
// each slot, and the S static lane rows at the end.  ops/backward_fused.py
// mirrors it.
template <typename T, class Model, bool LP = false>
struct BwdLayout {
  static constexpr int n = Model::n, m = Model::m;
  static constexpr int G = sweep_group_size<n>();  // threads per lane in the sweep
  // one (knot, lane) slot of an expansion buffer: A, Bd, the gradients,
  // the AL Gauss-Newton diagonals hx, hu and the circle rows' term hxy at
  // (xi, yi) and (yi, xi), the J terms; with LP, the sums over the knot's
  // cost families of their Hessians Q (upper triangle), H and R
  // (upper triangle), each as n×n, n×m and m×m
  static constexpr int A = 0, Bd = A + n * n, lx = Bd + n * m, lu = lx + n, hx = lu + m,
                       hu = hx + n, hxy = hu + m, terms = hxy + 1, hq = terms + kTerms;
  static constexpr int slot = (hq + (LP ? n * n + n * m + m * m : 0)) | 1;  // odd: column writes spread over the banks
  static constexpr int scratch = SweepScratch<n, m>::size;

  int tab, xu, exp, scr, stat, total;  // byte offsets and size
  __host__ __device__ explicit BwdLayout(const AltroGeometry& g, int W = 0, int S = 0) {
    tab = align16(int(sizeof(AltroProblem))) + (LP ? align16(int(sizeof(AltroLanes))) : 0);
    xu = tab + align16(g.tab_smem * int(sizeof(T)));
    exp = xu + align16(g.knots * g.lanes * (n + m + W) * int(sizeof(T)));
    scr = exp + align16(2 * g.knots * g.lanes * slot * int(sizeof(T)));
    stat = scr + align16(g.lanes * scratch * int(sizeof(T)));
    total = stat + align16(S * g.lanes * int(sizeof(T)));
  }
};

// The J terms of a knot slot, Kahan-added in the TPU kernel's order (and
// the forward kernel's): the cost families, then the constraint families,
// with a gated zero for each family that has stage knots but not this one
template <typename T>
__device__ __forceinline__ void add_terms(const AltroProblem& pr, bool terminal, const T* terms, T& J,
                                          T& comp) {
  for (int fi = 0; fi < pr.n_cost; ++fi) {
    const AltroCostFam& f = pr.cost[fi];
    if (terminal ? f.k1 != pr.N : f.k0 > pr.N - 1) continue;
    kahan_add(J, comp, terms[fi]);
  }
  for (int fi = 0; fi < pr.n_con; ++fi) {
    const AltroConFam& f = pr.con[fi];
    if ((terminal ? f.term_row : f.stage_row) < 0) continue;
    kahan_add(J, comp, terms[ALTRO_MAX_FAMS + fi]);
  }
}

// The (xi, yi) pair of the problem's circle families ({-1, -1} without
// any): where the slot's off-diagonal word hxy enters lxx
struct CirclePair {
  int xi = -1, yi = -1;
  __device__ __forceinline__ explicit CirclePair(const AltroProblem& pr) {
    for (int fi = 0; fi < pr.n_con; ++fi) {
      if (pr.con[fi].kind == ALTRO_CIRCLE) {
        xi = pr.con[fi].xi;
        yi = pr.con[fi].yi;
      }
    }
  }
  // the column whose lxx entry in row r takes hxy (-1: none)
  __device__ __forceinline__ int partner(int r) const { return r == xi ? yi : r == yi ? xi : -1; }
};

// The carry-independent expansion of knot k (k == N: the terminal knot) of
// lane b into its slot: gradient lx, lu, AL diagonals hx, hu, the circle
// rows' off-diagonal hxy, and the J terms (a zero where a family is gated
// off).  The circle rows' terms are added last, at the problem's (xi, yi).
// With LP the lane's own params come from `ln` and `lv` (its staged lane
// rows), and the sums of the cost families' Hessians go into the slot too.
template <typename T, class Model, bool LP = false>
__device__ __forceinline__ void expand_knot(const AltroBackwardArgs& a, const AltroProblem& pr,
                                            const T* ctab, CirclePair pair, int k, int b, const T* x,
                                            const T* u, T* sl, const AltroLanes* ln = nullptr,
                                            const LaneView<T>& lv = LaneView<T>()) {
  using Lay = BwdLayout<T, Model, LP>;
  constexpr int n = Model::n, m = Model::m;
  const int N = pr.N;
  const long Bl = a.B;
  const bool term = k == N;
  T lx[n], lu[m], hx[n], hu[m];
  CircleTerms<T> ct;
#pragma unroll
  for (int i = 0; i < n; ++i) lx[i] = hx[i] = T(0);
#pragma unroll
  for (int i = 0; i < m; ++i) lu[i] = hu[i] = T(0);
  for (int fi = 0; fi < pr.n_cost; ++fi) {
    const AltroCostFam& f = pr.cost[fi];
    const bool on = term ? f.k1 == N : (f.k0 <= k && k <= (f.k1 < N - 1 ? f.k1 : N - 1));
    T v = T(0);
    if (on) {
      const T* cr = cost_row<T, n, m>(ctab, f, k);
      if constexpr (LP) {
        const LaneCostRow<T, n, m> lr = lane_cost_row<T, n, m>(*ln, lv, cr, fi);
        v = quad_value<T, n, m>(lr, x, term ? nullptr : u);
        quad_grad_add<T, n, m>(lr, x, term ? nullptr : u, lx, lu);
      } else {
        v = quad_value<T, n, m>(cr, x, term ? nullptr : u);
        quad_grad_add<T, n, m>(cr, x, term ? nullptr : u, lx, lu);
      }
    }
    sl[Lay::terms + fi] = v;
  }
  if constexpr (LP) {
    // the Hessian sums FusedKnot reads, each added in the order, and from
    // the value, of the shared-param FusedKnot's sum over the rows
#pragma unroll
    for (int i = 0; i < n * n + n * m + m * m; ++i) sl[Lay::hq + i] = T(0);
    for (int fi = 0; fi < pr.n_cost; ++fi) {
      const AltroCostFam& f = pr.cost[fi];
      if (!(term ? f.k1 == N : (f.k0 <= k && k <= (f.k1 < N - 1 ? f.k1 : N - 1)))) continue;
      const LaneCostRow<T, n, m> lr = lane_cost_row<T, n, m>(*ln, lv, cost_row<T, n, m>(ctab, f, k), fi);
#pragma unroll
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int j = i; j < n; ++j) sl[Lay::hq + i * n + j] += lr[CostRow<n, m>::Q + i * n + j];
#pragma unroll
        for (int j = 0; j < m; ++j) sl[Lay::hq + n * n + i * m + j] += lr[CostRow<n, m>::H + i * m + j];
      }
#pragma unroll
      for (int i = 0; i < m; ++i) {
#pragma unroll
        for (int j = i; j < m; ++j) sl[Lay::hq + n * n + n * m + i * m + j] += lr[CostRow<n, m>::R + i * m + j];
      }
    }
  }
  for (int fi = 0; fi < pr.n_con; ++fi) {
    const AltroConFam& f = pr.con[fi];
    T v = T(0);
    if (term && f.term_row >= 0) {
      const T* lamT = static_cast<const T*>(a.lamT) + long(f.term_row) * Bl + b;
      const T rho_c = static_cast<const T*>(a.lamT_rho)[long(f.term_fam) * Bl + b];
      v = al_family<T, n, m, true, LP>(f, x, nullptr, lamT, Bl, rho_c, lx, lu, hx, hu, &ct,
                                       lane_con<T, LP>(ln, lv, fi));
    } else if (!term && f.stage_row >= 0 && f.k0 <= k && k <= (f.k1 < N - 1 ? f.k1 : N - 1)) {
      const T* lam = static_cast<const T*>(a.lam) + (long(k) * a.Ps + f.stage_row) * Bl + b;
      const T rho_c = static_cast<const T*>(a.lam_rho)[(long(k) * a.Fs + f.stage_fam) * Bl + b];
      v = al_family<T, n, m, true, LP>(f, x, u, lam, Bl, rho_c, lx, lu, hx, hu, &ct,
                                       lane_con<T, LP>(ln, lv, fi));
    }
    sl[Lay::terms + ALTRO_MAX_FAMS + fi] = v;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    sl[Lay::lx + i] = lx[i];
    sl[Lay::hx + i] = hx[i];
  }
#pragma unroll
  for (int i = 0; i < m; ++i) {
    sl[Lay::lu + i] = lu[i];
    sl[Lay::hu + i] = hu[i];
  }
  // the circle rows' terms, at the run-time (xi, yi) of the problem's pair
  sl[Lay::hxy] = ct.hxy;
  if (pair.xi >= 0) {
    sl[Lay::lx + pair.xi] += ct.gx;
    sl[Lay::lx + pair.yi] += ct.gy;
    sl[Lay::hx + pair.xi] += ct.hxx;
    sl[Lay::hx + pair.yi] += ct.hyy;
  }
}

// The lane-params instantiation's inputs beside a block's (LP only): the
// lanes descriptor and the static lane rows in shared memory, the lane
// table, and its rows per knot
template <typename T>
struct LaneInputs {
  const AltroLanes* ln = nullptr;
  const T* stat = nullptr;
  const T* tab = nullptr;
  int W = 0;
};

// Producers: the expansions of chunk c (sweep positions c·knots ...; position
// q is knot N − q) into `buf`
template <typename T, class Model, bool LP = false>
__device__ __forceinline__ void produce(const AltroBackwardArgs& a, const AltroProblem& pr,
                                        const T* ctab, const T* dp, CirclePair pair, T* xu, T* buf,
                                        int c, int ptid, int nprod, const LaneInputs<T>& li = LaneInputs<T>()) {
  using Lay = BwdLayout<T, Model, LP>;
  constexpr int n = Model::n, m = Model::m, nm = n + m;
  const int N = pr.N, L = a.geo.lanes, KC = a.geo.knots, B = a.B;
  const long Bl = B;
  const int b0 = blockIdx.x * L;
  const T* __restrict__ X = static_cast<const T*>(a.X);
  const T* __restrict__ U = static_cast<const T*>(a.U);
  // rows of a staged knot: x, u (and with LP the knot's W lane rows)
  const int nr = LP ? nm + li.W : nm;
  if constexpr (LP) {
    for (int e = ptid; e < KC * nr * L; e += nprod) {
      const int l = e % L, q = e / L, pos = c * KC + q / nr, i = q % nr;
      if (pos > N || b0 + l >= B) continue;
      const int k = N - pos;
      xu[e] = i < n    ? X[(long(k) * n + i) * Bl + b0 + l]
              : i < nm ? (pos == 0 ? T(0) : U[(long(k) * m + i - n) * Bl + b0 + l])
                       : li.tab[(long(k) * li.W + i - nm) * Bl + b0 + l];
    }
  } else {
    // x, u of the chunk's knots, [knot][row][lane], batch-adjacent loads
    for (int e = ptid; e < KC * nm * L; e += nprod) {
      const int l = e % L, q = e / L, pos = c * KC + q / nm, i = q % nm;
      if (pos > N || b0 + l >= B) continue;
      const int k = N - pos;
      xu[e] = i < n ? X[(long(k) * n + i) * Bl + b0 + l]
                    : (pos == 0 ? T(0) : U[(long(k) * m + i - n) * Bl + b0 + l]);
    }
  }
  bar_sync(1, nprod);
  // items: (column j of [A Bd], or j == n+m the cost and AL terms) × knot × lane
  const int per = KC * L;
  for (int e = ptid; e < (nm + 1) * per; e += nprod) {
    const int l = e % L, kc = (e / L) % KC, j = e / per, pos = c * KC + kc;
    if (pos > N || b0 + l >= B || (pos == 0 && j < nm)) continue;
    const int k = N - pos;
    T x[n], u[m];
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] = xu[(kc * nr + i) * L + l];
#pragma unroll
    for (int i = 0; i < m; ++i) u[i] = xu[(kc * nr + n + i) * L + l];
    T* sl = buf + (kc * L + l) * Lay::slot;
    if (j < nm) {
      T col[n];
      if constexpr (LP) {
        const DynParams<T, Model> lp(pr, *li.ln, li.stat + l, L);
        dyn_tangent<T, Model>(pr.method, lp.p, x, u, static_cast<const T*>(a.t)[k],
                              static_cast<const T*>(a.h)[k], j, col);
      } else {
        dyn_tangent<T, Model>(pr.method, dp, x, u, static_cast<const T*>(a.t)[k],
                              static_cast<const T*>(a.h)[k], j, col);
      }
      if (j < n) {
#pragma unroll
        for (int i = 0; i < n; ++i) sl[Lay::A + i * n + j] = col[i];
      } else {
#pragma unroll
        for (int i = 0; i < n; ++i) sl[Lay::Bd + i * m + j - n] = col[i];
      }
    } else if constexpr (LP) {
      const LaneView<T> lv{xu + (kc * nr + nm) * L + l, li.stat + l, L};
      expand_knot<T, Model, true>(a, pr, ctab, pair, k, b0 + l, x, u, sl, li.ln, lv);
    } else {
      expand_knot<T, Model>(a, pr, ctab, pair, k, b0 + l, x, u, sl);
    }
  }
}

// A knot slot as the shared sweep reads it (sweep_group.cuh): A, Bd and the
// gradients from the slot; lxx, lxu, luu as the sum of the cost Hessians of
// the families over the knot (the cost table's rows) plus the AL weights:
// the diagonals hx, hu and the circle rows' hxy at (xi, yi) and (yi, xi).
// The Riccati kernel's accessor reads the full lxx instead (riccati.cu).
// With LP the cost Hessians' sums come from the slot instead: the producer
// summed them there, per lane, in the same order.
template <typename T, class Model, bool LP = false>
struct FusedKnot {
  using Lay = BwdLayout<T, Model, LP>;
  static constexpr int n = Model::n, m = Model::m;
  const T* sl;
  const T* rows[ALTRO_MAX_FAMS];
  CirclePair cp;
  __device__ __forceinline__ FusedKnot(const AltroProblem& pr, const T* ctab, int k, const T* slot,
                                       CirclePair pair)
      : sl(slot), cp(pair) {
    if constexpr (!LP) cost_rows_at<T, n, m>(pr, ctab, k, rows);
  }
  __device__ __forceinline__ T A(int i, int j) const { return sl[Lay::A + i * n + j]; }
  __device__ __forceinline__ T Bd(int i, int j) const { return sl[Lay::Bd + i * m + j]; }
  __device__ __forceinline__ T lx(int r) const { return sl[Lay::lx + r]; }
  __device__ __forceinline__ T lu(int r) const { return sl[Lay::lu + r]; }
  __device__ __forceinline__ T lxx(int r, int c) const {
    T l = T(0);
    if constexpr (LP) {
      l = sl[Lay::hq + (r < c ? r : c) * n + (r < c ? c : r)];
    } else {
#pragma unroll
      for (int q = 0; q < ALTRO_MAX_FAMS; ++q) {
        if (rows[q]) l += quad_Q<T, n, m>(rows[q], r, c);
      }
    }
    if (c == r) l += sl[Lay::hx + r];
    if (c == cp.partner(r)) l += sl[Lay::hxy];
    return l;
  }
  __device__ __forceinline__ T lxu(int r, int c) const {
    if constexpr (LP) return sl[Lay::hq + n * n + r * m + c];
    T l = T(0);
#pragma unroll
    for (int q = 0; q < ALTRO_MAX_FAMS; ++q) {
      if (rows[q]) l += rows[q][CostRow<n, m>::H + r * m + c];
    }
    return l;
  }
  __device__ __forceinline__ T luu(int r, int c) const {
    T l = T(0);
    if constexpr (LP) {
      l = sl[Lay::hq + n * n + n * m + (r < c ? r : c) * m + (r < c ? c : r)];
    } else {
#pragma unroll
      for (int q = 0; q < ALTRO_MAX_FAMS; ++q) {
        if (rows[q]) l += quad_R<T, n, m>(rows[q], r, c);
      }
    }
    if (c == r) l += sl[Lay::hu + r];
    return l;
  }
};

// The kernel's body; with LP (the lane-params instantiation) the lanes
// descriptor `lng` and the lane table are read as well: the descriptor and
// the block's static lane rows are staged once, a knot's lane rows with its
// x and u.  `a` is taken by value, as the kernel takes it: by reference the
// shared-param kernel's registers come out otherwise (and the quadrotor's
// f32 instance spills).
template <typename T, class Model, bool LP>
__device__ __forceinline__ void backward_body(AltroBackwardArgs a, const AltroProblem* __restrict__ prg,
                                              const AltroLanes* __restrict__ lng, const T* __restrict__ lane_tab) {
  using Lay = BwdLayout<T, Model, LP>;
  constexpr int G = Lay::G;
  extern __shared__ __align__(16) unsigned char smem[];
  int W = 0, S = 0;  // lane rows per knot, static lane rows
  if constexpr (LP) {
    W = lng->knot_rows;
    S = lng->static_rows;
  }
  const Lay lay(a.geo, W, S);
  AltroProblem& pr = *reinterpret_cast<AltroProblem*>(smem);
  const T* ctab = stage_problem<T>(&pr, reinterpret_cast<T*>(smem + lay.tab), prg,
                                   static_cast<const T*>(a.cost_tab), a.geo.tab_smem);
  LaneInputs<T> li;
  if constexpr (LP) {
    AltroLanes* ln = reinterpret_cast<AltroLanes*>(smem + align16(int(sizeof(AltroProblem))));
    T* stat = reinterpret_cast<T*>(smem + lay.stat);
    const int Ll = a.geo.lanes, b0 = blockIdx.x * Ll;
    block_copy(ln, lng, int(sizeof(AltroLanes) / 4), threadIdx.x, blockDim.x);
    for (int e = threadIdx.x; e < S * Ll; e += blockDim.x) {
      const int l = e % Ll, row = (pr.N + 1) * W + e / Ll;
      stat[e] = b0 + l < a.B ? lane_tab[long(row) * a.B + b0 + l] : T(0);
    }
    __syncthreads();
    li = LaneInputs<T>{ln, stat, lane_tab, W};
  }
  T* xu = reinterpret_cast<T*>(smem + lay.xu);
  T* expb = reinterpret_cast<T*>(smem + lay.exp);
  const int N = pr.N, L = a.geo.lanes, KC = a.geo.knots;
  const int ncons = (L * G + 31) / 32 * 32;  // consumer threads, whole warps
  const int tid = threadIdx.x;
  const int chunks = (N + 1 + KC - 1) / KC;
  const int buf_len = KC * L * Lay::slot;
  const DynParams<T, Model> dp(pr);
  const CirclePair pair(pr);

  // consumer identity: lane l of the block, row r of its group
  const int l = tid / G, r = tid % G;
  const int b = blockIdx.x * L + l;
  const bool lane_ok = tid < ncons && l < L && b < a.B;
  const T rho = lane_ok ? static_cast<const T*>(a.rho)[b] : T(0);
  T* sc = reinterpret_cast<T*>(smem + lay.scr) + (l < L ? l : 0) * Lay::scratch;
  const T glim = T(pr.gain_limit);
  T J = T(0), comp = T(0);  // J0's Kahan sum, on thread r == 0
  SweepCarry<T> cy;

  // chunk c is produced in iteration c and swept in iteration c + 1, in the
  // other buffer; the barrier ends each iteration
  for (int c = 0; c <= chunks; ++c) {
    if (tid >= ncons) {
      if (c < chunks) {
        produce<T, Model, LP>(a, pr, ctab, dp.p, pair, xu, expb + (c & 1) * buf_len, c, tid - ncons,
                              blockDim.x - ncons, li);
      }
    } else if (c > 0 && l < L) {
      const T* buf = expb + ((c - 1) & 1) * buf_len;
      for (int kc = 0; kc < KC; ++kc) {
        const int pos = (c - 1) * KC + kc;
        if (pos > N) break;
        const T* sl = buf + (kc * L + l) * Lay::slot;
        if (r == 0) add_terms<T>(pr, pos == 0, sl + Lay::terms, J, comp);
        const FusedKnot<T, Model, LP> src(pr, ctab, N - pos, sl, pair);
        if (pos == 0) {
          sweep_terminal_group<T, Model::n, Model::m>(src, sc, r);
        } else {
          sweep_knot_group<T, Model::n, Model::m>(src, sc, rho, glim, cy, r, static_cast<T*>(a.K),
                                                  static_cast<T*>(a.d), N - pos, b, a.B);
        }
      }
    }
    __syncthreads();
  }

  if (lane_ok && r == 0) {
    static_cast<T*>(a.dV1)[b] = cy.dv1;
    static_cast<T*>(a.dV2)[b] = cy.dv2;
    static_cast<int*>(a.failed)[b] = cy.failed ? 1 : 0;
    static_cast<T*>(a.J0)[b] = sub_rn(J, comp);
  }
}

template <typename T, class Model>
__global__ void __launch_bounds__(kBwdMaxThreads)
backward_fused_kernel(AltroBackwardArgs a, const AltroProblem* __restrict__ prg) {
  backward_body<T, Model, false>(a, prg, nullptr, nullptr);
}

// the lane-params instantiation: per-instance params from the lane table
template <typename T, class Model>
__global__ void __launch_bounds__(kBwdMaxThreads)
backward_fused_lanes_kernel(AltroBackwardArgs a, const AltroProblem* __restrict__ prg,
                            const AltroLanes* __restrict__ lng, const T* __restrict__ lane_tab) {
  backward_body<T, Model, true>(a, prg, lng, lane_tab);
}

// `lanes` (host) and `lanes_dev`, `lane_tab` (device): the lane-params
// instantiation's, nullptr for the shared-param one
template <typename T, class Model, bool LP = false>
int launch_backward(const AltroBackwardArgs* args, const AltroProblem* prob, void* stream,
                    const AltroLanes* lanes = nullptr, const AltroLanes* lanes_dev = nullptr,
                    const void* lane_tab = nullptr) {
  using Lay = BwdLayout<T, Model, LP>;
  const AltroGeometry& g = args->geo;
  const int ncons = (g.lanes * Lay::G + 31) / 32 * 32;
  const int W = LP ? lanes->knot_rows : 0, S = LP ? lanes->static_rows : 0;
  if (g.group != Lay::G || g.lanes < 1 || g.knots < 1 || g.threads > kBwdMaxThreads ||
      g.threads % 32 != 0 || g.threads - ncons < 32 || g.lanes * Lay::G % 32 != 0 ||
      Lay(g, W, S).total != g.smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (args->B + g.lanes - 1) / g.lanes;
  if (grid > 0) {
    static int smem_set = 48 * 1024;  // the most dynamic shared memory allowed so far
    if (g.smem > smem_set) {
      cudaError_t err;
      if constexpr (LP) {
        err = cudaFuncSetAttribute(backward_fused_lanes_kernel<T, Model>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      } else {
        err = cudaFuncSetAttribute(backward_fused_kernel<T, Model>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = g.smem;
    }
    if constexpr (LP) {
      backward_fused_lanes_kernel<T, Model><<<grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
          *args, prob, lanes_dev, static_cast<const T*>(lane_tab));
    } else {
      backward_fused_kernel<T, Model>
          <<<grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(*args, prob);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace altro

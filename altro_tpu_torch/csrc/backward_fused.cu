// Fused expansion + Riccati backward sweep: a block owns `lanes` batch
// lanes and walks their horizon backwards in chunks of `knots` knots, with
// the expansions of one chunk built while the sweep consumes the chunk
// before it.
//
// Replaces the TPU kernel BackwardFusedKernel._make_kernel
// (altro_tpu/ops/backward_fused_pallas.py:302-531, launched by _get_call
// :533-558).  Per lane, sweeping k = N-1 ... 0: the terminal expansion gives
// P_N, p_N (and the terminal cost into J); at each knot the quadratic-cost
// gradient and Hessian, the AL Gauss-Newton terms of the goal and
// control-bound rows, and the RK4 A, B; then the Q terms, the Cholesky of
// Quu + ρI with a NaN-safe failure flag, K and d, the gain guard, and the
// P, p update reusing (Qxu K)ᵀ.  ΔV1, ΔV2 and P, p freeze at a lane's first
// failure; J0 is a Kahan sum over the terminal terms, then k = N-1 ... 0.
// A pure function of its inputs and ρ, so the regularization retry loop can
// relaunch it.
//
// The model is a device functor of csrc/models.cuh, a template parameter;
// the kernel is instantiated for the unicycle, the cartpole and the
// quadrotor in f32 and f64 (entry points at the end of this file).
//
// What bounds it on the H100: the dependent chain of each lane's sweep,
// N Riccati steps in a row; the bytes (X, U, λ in; K, d out: 30 MB at
// B=4096, N=100 in f32, 9 µs at 3.35 TB/s) and the operations (dominated by
// the n+m Jacobian tangents per knot) are far below it.  So the design
// takes everything that does not depend on the carry (P, p) off that chain
// and fills the card with short chains:
//   - Producer warps build each knot's expansion in parallel over (lane,
//     knot, column): the cost value and gradient, the AL gradient and
//     diagonal Gauss-Newton weights, and each column of [A Bd] as one
//     tangent of the RK4 step (fused_common.cuh:dyn_tangent, 17 parallel
//     columns at n=13).  They stage the chunk's x, u in shared memory
//     first, then write the expansions into one of two shared buffers.
//   - Consumer warps run the sweep over the other buffer, a group of
//     threads per lane (4 for the unicycle, 8 for the cartpole, 16 for the
//     quadrotor): one per row of P and the Q terms, which live in shared
//     memory, plus one for d, so a thread's share of a knot is one row and
//     at n=13 nothing spills to local memory (on one thread per lane the
//     n=13 sweep kept 13.7 KB per thread there).
//   - The cost Hessians Q, R, H are the same for every lane: the consumer
//     reads them from the cost table, staged once per block in shared
//     memory with the problem descriptor; per lane only what depends on it
//     is stored.
//   - Blocks of 8 lanes: B=2048 launches 256 blocks on 132 SMs.
// Launch geometry and the shared-memory layout come from the wrapper
// (ops/backward_fused.py:FusedKernel.geometry, AltroGeometry).
//
// Measured on an H100 (chip_smoke.py kernel_scaling, PERF.md): the unicycle
// and cartpole instances stay flat in B up to 4096, a block's pipelined
// chunks taking about 3 µs per knot, the producers' Dual trig and the
// sweep's barriers being of one size there; at n=13 the kernel takes 255
// registers a thread, so one 256-thread block fills a multiprocessor and
// the time grows with B from 1024 on.  nvcc -Xptxas=-v, registers / stack
// bytes / spill-store bytes: unicycle f32 64 / 40 / 0, f64 120 / 64 / 0;
// cartpole f32 80 / 32 / 0, f64 156 / 48 / 0; quadrotor f32 255 / 16 / 0,
// f64 255 / 416 / 458.
#include <cuda_runtime.h>

#include "altro_abi.h"
#include "fused_common.cuh"
#include "models.cuh"

namespace altro {

constexpr int kBwdMaxThreads = 256;
constexpr int kTerms = 2 * ALTRO_MAX_FAMS;  // J terms of a knot: cost families, then constraint families

// Shared memory of one block: the descriptor, the cost table, the chunk's
// x, u, two expansion buffers of knots × lanes slots, and the cooperative
// sweep's per-lane scratch.  ops/backward_fused.py mirrors it.
template <typename T, class Model>
struct BwdLayout {
  static constexpr int n = Model::n, m = Model::m;
  // threads per lane in the sweep: one per row and one for d, a power of two
  static constexpr int G = n < 4 ? 4 : n < 8 ? 8 : 16;
  // one (knot, lane) slot of an expansion buffer
  static constexpr int A = 0, Bd = A + n * n, lx = Bd + n * m, lu = lx + n, hx = lu + m,
                       hu = hx + n, terms = hu + m;
  static constexpr int slot = (terms + kTerms) | 1;  // odd: column writes spread over the banks
  // per-lane scratch of the cooperative sweep
  static constexpr int P = 0, p = P + n * n, PB = p + n, Quu = PB + n * m, Qu = Quu + m * m,
                       K = Qu + m, d = K + m * n, QK = d + m;
  static constexpr int scratch = QK + n * n;

  int tab, xu, exp, scr, total;  // byte offsets and size
  __host__ __device__ explicit BwdLayout(const AltroGeometry& g) {
    tab = align16(int(sizeof(AltroProblem)));
    xu = tab + align16(g.tab_smem * int(sizeof(T)));
    exp = xu + align16(g.knots * g.lanes * (n + m) * int(sizeof(T)));
    scr = exp + align16(2 * g.knots * g.lanes * slot * int(sizeof(T)));
    total = scr + align16(g.lanes * scratch * int(sizeof(T)));
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

// The carry-independent expansion of knot k (k == N: the terminal knot) of
// lane b into its slot: gradient lx, lu, AL diagonals hx, hu, and the J
// terms (a zero where a family is gated off)
template <typename T, class Model>
__device__ __forceinline__ void expand_knot(const AltroBackwardArgs& a, const AltroProblem& pr,
                                            const T* ctab, int k, int b, const T* x, const T* u,
                                            T* sl) {
  using Lay = BwdLayout<T, Model>;
  constexpr int n = Model::n, m = Model::m;
  const int N = pr.N;
  const long Bl = a.B;
  const bool term = k == N;
  T lx[n], lu[m], hx[n], hu[m];
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
      v = quad_value<T, n, m>(cr, x, term ? nullptr : u);
      quad_grad_add<T, n, m>(cr, x, term ? nullptr : u, lx, lu);
    }
    sl[Lay::terms + fi] = v;
  }
  for (int fi = 0; fi < pr.n_con; ++fi) {
    const AltroConFam& f = pr.con[fi];
    T v = T(0);
    if (term && f.term_row >= 0) {
      const T* lamT = static_cast<const T*>(a.lamT) + long(f.term_row) * Bl + b;
      const T rho_c = static_cast<const T*>(a.lamT_rho)[long(f.term_fam) * Bl + b];
      v = al_family<T, n, m, true>(f, x, nullptr, lamT, Bl, rho_c, lx, lu, hx, hu);
    } else if (!term && f.stage_row >= 0 && f.k0 <= k && k <= (f.k1 < N - 1 ? f.k1 : N - 1)) {
      const T* lam = static_cast<const T*>(a.lam) + (long(k) * a.Ps + f.stage_row) * Bl + b;
      const T rho_c = static_cast<const T*>(a.lam_rho)[(long(k) * a.Fs + f.stage_fam) * Bl + b];
      v = al_family<T, n, m, true>(f, x, u, lam, Bl, rho_c, lx, lu, hx, hu);
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
}

// Producers: the expansions of chunk c (sweep positions c·knots ...; position
// q is knot N − q) into `buf`
template <typename T, class Model>
__device__ __forceinline__ void produce(const AltroBackwardArgs& a, const AltroProblem& pr,
                                        const T* ctab, const T* dp, T* xu, T* buf, int c, int ptid,
                                        int nprod) {
  using Lay = BwdLayout<T, Model>;
  constexpr int n = Model::n, m = Model::m, nm = n + m;
  const int N = pr.N, L = a.geo.lanes, KC = a.geo.knots, B = a.B;
  const long Bl = B;
  const int b0 = blockIdx.x * L;
  const T* __restrict__ X = static_cast<const T*>(a.X);
  const T* __restrict__ U = static_cast<const T*>(a.U);
  // x, u of the chunk's knots, [knot][row][lane], batch-adjacent loads
  for (int e = ptid; e < KC * nm * L; e += nprod) {
    const int l = e % L, q = e / L, pos = c * KC + q / nm, i = q % nm;
    if (pos > N || b0 + l >= B) continue;
    const int k = N - pos;
    xu[e] = i < n ? X[(long(k) * n + i) * Bl + b0 + l]
                  : (pos == 0 ? T(0) : U[(long(k) * m + i - n) * Bl + b0 + l]);
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
    for (int i = 0; i < n; ++i) x[i] = xu[(kc * nm + i) * L + l];
#pragma unroll
    for (int i = 0; i < m; ++i) u[i] = xu[(kc * nm + n + i) * L + l];
    T* sl = buf + (kc * L + l) * Lay::slot;
    if (j < nm) {
      T col[n];
      dyn_tangent<T, Model>(pr.method, dp, x, u, static_cast<const T*>(a.t)[k],
                            static_cast<const T*>(a.h)[k], j, col);
      if (j < n) {
#pragma unroll
        for (int i = 0; i < n; ++i) sl[Lay::A + i * n + j] = col[i];
      } else {
#pragma unroll
        for (int i = 0; i < n; ++i) sl[Lay::Bd + i * m + j - n] = col[i];
      }
    } else {
      expand_knot<T, Model>(a, pr, ctab, k, b0 + l, x, u, sl);
    }
  }
}

// The running sums and failure flag of one consumer thread (the carry P, p
// lives in the lane's scratch)
template <typename T>
struct Carry {
  T J = T(0), comp = T(0), dv1 = T(0), dv2 = T(0);
  bool failed = false;
};

// One knot of the sweep for one lane on a group of G threads: the
// statements of riccati_step.cuh, each output row on the thread of its row
// r, every sum in riccati_step's order (riccati.cu keeps the one-thread
// form).  The group lies within one warp, so __syncwarp orders its phases.  Every thread computes the m×m Cholesky of
// the same Quu and so the same failure flag; the gain guard's flag is
// OR-ed over the group with a ballot.
template <typename T, class Model>
__device__ __forceinline__ void sweep_knot_group(const AltroBackwardArgs& a, const AltroProblem& pr,
                                                 const T* ctab, int k, const T* sl, T* sc, T rho,
                                                 Carry<T>& cy,
                                                 int b, int r) {
  using Lay = BwdLayout<T, Model>;
  constexpr int n = Model::n, m = Model::m, G = Lay::G;
  static_assert(G > n && 32 % G == 0, "one thread per row and one for d, in whole warps");
  const T* rows[ALTRO_MAX_FAMS];
  cost_rows_at<T, n, m>(pr, ctab, k, rows);
  const T* A = sl + Lay::A;
  const T* Bd = sl + Lay::Bd;
  T* P = sc + Lay::P;
  T* p = sc + Lay::p;
  if (k == pr.N) {  // P_N, p_N
    if (r < n) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        T v = T(0);
#pragma unroll
        for (int q = 0; q < ALTRO_MAX_FAMS; ++q) {
          if (rows[q]) v += quad_Q<T, n, m>(rows[q], r, j);
        }
        if (j == r) v += sl[Lay::hx + r];
        P[r * n + j] = v;
      }
      p[r] = sl[Lay::lx + r];
    }
    __syncwarp();
    return;
  }
  T* PB = sc + Lay::PB;
  T* Quu = sc + Lay::Quu;
  T* Qu = sc + Lay::Qu;
  T* K = sc + Lay::K;
  T* d = sc + Lay::d;
  T* QK = sc + Lay::QK;

  // Qx[r], Qu, PB; row r of AᵀP, which only this thread reads
  T atp[n], qx = T(0);
  if (r < n) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      T acc = A[r] * P[c];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += A[j * n + r] * P[j * n + c];
      atp[c] = acc;
    }
#pragma unroll
    for (int c = 0; c < m; ++c) {
      T acc = P[r * n] * Bd[c];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += P[r * n + j] * Bd[j * m + c];
      PB[r * m + c] = acc;
    }
    T acc = A[r] * p[0];
#pragma unroll
    for (int j = 1; j < n; ++j) acc += A[j * n + r] * p[j];
    qx = sl[Lay::lx + r] + acc;
  }
  if (r < m) {
    T acc = Bd[r] * p[0];
#pragma unroll
    for (int j = 1; j < n; ++j) acc += Bd[j * m + r] * p[j];
    Qu[r] = sl[Lay::lu + r] + acc;
  }
  __syncwarp();

  // rows r of Qxx = lxx + AᵀPA and Qxu = lxu + AᵀPB (this thread's only); Quu
  T qxx[n], qxu[m];
  if (r < n) {
#pragma unroll
    for (int c = 0; c < n; ++c) {
      T l = T(0);
#pragma unroll
      for (int q = 0; q < ALTRO_MAX_FAMS; ++q) {
        if (rows[q]) l += quad_Q<T, n, m>(rows[q], r, c);
      }
      if (c == r) l += sl[Lay::hx + r];
      T acc = atp[0] * A[c];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += atp[j] * A[j * n + c];
      qxx[c] = l + acc;
    }
#pragma unroll
    for (int c = 0; c < m; ++c) {
      T l = T(0);
#pragma unroll
      for (int q = 0; q < ALTRO_MAX_FAMS; ++q) {
        if (rows[q]) l += rows[q][CostRow<n, m>::H + r * m + c];
      }
      T acc = atp[0] * Bd[c];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += atp[j] * Bd[j * m + c];
      qxu[c] = l + acc;
    }
  }
  if (r < m) {
#pragma unroll
    for (int c = 0; c < m; ++c) {
      T l = T(0);
#pragma unroll
      for (int q = 0; q < ALTRO_MAX_FAMS; ++q) {
        if (rows[q]) l += quad_R<T, n, m>(rows[q], r, c);
      }
      if (c == r) l += sl[Lay::hu + r];
      T acc = Bd[r] * PB[c];
#pragma unroll
      for (int j = 1; j < n; ++j) acc += Bd[j * m + r] * PB[j * m + c];
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
      big |= !(fabs(sol[i]) <= T(pr.gain_limit));
      if (r < n) {
        K[i * n + r] = sol[i];
      } else {
        d[i] = sol[i];
      }
    }
  }
  const unsigned lane = threadIdx.x % 32;
  const unsigned gmask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (lane / G * G);
  const unsigned bigs = __ballot_sync(0xffffffffu, big);  // the whole warp, whatever fail_chol
  const bool fail_k = fail_chol || (bigs & gmask) != 0u;
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
  if (b < a.B && r <= n) {
    const long Bl = a.B;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      if (r < n) {
        static_cast<T*>(a.K)[((long(k) * m + i) * n + r) * Bl + b] = K[i * n + r];
      } else {
        static_cast<T*>(a.d)[(long(k) * m + i) * Bl + b] = d[i];
      }
    }
  }
  __syncwarp();
}

template <typename T, class Model>
__global__ void __launch_bounds__(kBwdMaxThreads)
backward_fused_kernel(AltroBackwardArgs a, const AltroProblem* __restrict__ prg) {
  using Lay = BwdLayout<T, Model>;
  constexpr int G = Lay::G;
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay lay(a.geo);
  AltroProblem& pr = *reinterpret_cast<AltroProblem*>(smem);
  const T* ctab = stage_problem<T>(&pr, reinterpret_cast<T*>(smem + lay.tab), prg,
                                   static_cast<const T*>(a.cost_tab), a.geo.tab_smem);
  T* xu = reinterpret_cast<T*>(smem + lay.xu);
  T* expb = reinterpret_cast<T*>(smem + lay.exp);
  const int N = pr.N, L = a.geo.lanes, KC = a.geo.knots;
  const int ncons = (L * G + 31) / 32 * 32;  // consumer threads, whole warps
  const int tid = threadIdx.x;
  const int chunks = (N + 1 + KC - 1) / KC;
  const int buf_len = KC * L * Lay::slot;
  const DynParams<T, Model> dp(pr);

  // consumer identity: lane l of the block, row r of its group
  const int l = tid / G, r = tid % G;
  const int b = blockIdx.x * L + l;
  const bool lane_ok = tid < ncons && l < L && b < a.B;
  const T rho = lane_ok ? static_cast<const T*>(a.rho)[b] : T(0);
  T* sc = reinterpret_cast<T*>(smem + lay.scr) + (l < L ? l : 0) * Lay::scratch;
  Carry<T> cy;

  // chunk c is produced in iteration c and swept in iteration c + 1, in the
  // other buffer; the barrier ends each iteration
  for (int c = 0; c <= chunks; ++c) {
    if (tid >= ncons) {
      if (c < chunks) {
        produce<T, Model>(a, pr, ctab, dp.p, xu, expb + (c & 1) * buf_len, c, tid - ncons,
                          blockDim.x - ncons);
      }
    } else if (c > 0 && l < L) {
      const T* buf = expb + ((c - 1) & 1) * buf_len;
      for (int kc = 0; kc < KC; ++kc) {
        const int pos = (c - 1) * KC + kc;
        if (pos > N) break;
        const T* sl = buf + (kc * L + l) * Lay::slot;
        if (r == 0) add_terms<T>(pr, pos == 0, sl + Lay::terms, cy.J, cy.comp);
        sweep_knot_group<T, Model>(a, pr, ctab, N - pos, sl, sc, rho, cy, b, r);
      }
    }
    __syncthreads();
  }

  if (lane_ok && r == 0) {
    static_cast<T*>(a.dV1)[b] = cy.dv1;
    static_cast<T*>(a.dV2)[b] = cy.dv2;
    static_cast<int*>(a.failed)[b] = cy.failed ? 1 : 0;
    static_cast<T*>(a.J0)[b] = sub_rn(cy.J, cy.comp);
  }
}

template <typename T, class Model>
int launch_backward(const AltroBackwardArgs* args, const AltroProblem* prob, void* stream) {
  using Lay = BwdLayout<T, Model>;
  const AltroGeometry& g = args->geo;
  const int ncons = (g.lanes * Lay::G + 31) / 32 * 32;
  if (g.group != Lay::G || g.lanes < 1 || g.knots < 1 || g.threads > kBwdMaxThreads ||
      g.threads % 32 != 0 || g.threads - ncons < 32 || g.lanes * Lay::G % 32 != 0 ||
      Lay(g).total != g.smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (args->B + g.lanes - 1) / g.lanes;
  if (grid > 0) {
    static int smem_set = 48 * 1024;  // the most dynamic shared memory allowed so far
    if (g.smem > smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          backward_fused_kernel<T, Model>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = g.smem;
    }
    backward_fused_kernel<T, Model>
        <<<grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(*args, prob);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace altro

extern "C" {

void altro_abi_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(AltroProblem));
  out[1] = static_cast<int>(sizeof(AltroBackwardArgs));
  out[2] = static_cast<int>(sizeof(AltroForwardArgs));
  out[3] = static_cast<int>(sizeof(AltroRiccatiArgs));
}

void altro_model_ops(int* out) {
  const int ops[6] = {altro::Unicycle::kFOps,  altro::Unicycle::kTangentOps,
                      altro::Cartpole::kFOps,  altro::Cartpole::kTangentOps,
                      altro::Quadrotor::kFOps, altro::Quadrotor::kTangentOps};
  for (int i = 0; i < 6; ++i) out[i] = ops[i];
}

#define ALTRO_BACKWARD_ENTRY(NAME, MODEL, T)                                                \
  int altro_backward_fused_##NAME(const AltroBackwardArgs* args, const AltroProblem* prob,  \
                                  void* stream) {                                           \
    return altro::launch_backward<T, altro::MODEL>(args, prob, stream);                     \
  }
ALTRO_BACKWARD_ENTRY(unicycle_f32, Unicycle, float)
ALTRO_BACKWARD_ENTRY(unicycle_f64, Unicycle, double)
ALTRO_BACKWARD_ENTRY(cartpole_f32, Cartpole, float)
ALTRO_BACKWARD_ENTRY(cartpole_f64, Cartpole, double)
ALTRO_BACKWARD_ENTRY(quadrotor_f32, Quadrotor, float)
ALTRO_BACKWARD_ENTRY(quadrotor_f64, Quadrotor, double)
#undef ALTRO_BACKWARD_ENTRY

}  // extern "C"

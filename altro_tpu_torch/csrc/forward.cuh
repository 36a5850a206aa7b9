// Fused closed-loop rollout + AL cost: one thread per batch lane runs the
// rollout's chain, while the block stages that lane's inputs for the next
// chunk of knots in shared memory.
//
// Replaces the TPU kernel ForwardKernel._make_kernel(check_bounds)
// (altro_tpu/ops/forward_pallas.py:534-685, launched by _get_call
// :687-713).  Per lane, forward over k = 0 ... N-1: ū = u + K(x̄−x) + αd;
// the stage quadratic cost and the AL value of the stage constraints (circle
// rows in compensated arithmetic, fused_common.cuh:al_family); the
// RK4 step; with check_bounds, the divergence guard (freeze the state at
// the first ‖x‖² > state_max² or ‖ū‖² > control_max², status STATE_LIMIT /
// CONTROL_LIMIT); then the terminal cost and terminal AL terms.  J is a
// Kahan sum.  With α = 0 and K = d = 0 it is the open-loop rollout + cost
// that starts each inner solve (launched with check_bounds = 0).  The
// search mode (forward_kernel<T, Model, true>) runs each lane's whole
// backtracking line search: tries at α, α/f, ... until one is accepted
// or the lane's budget is spent, with the test between tries on the
// device (forward_body below).
//
// The model is a device functor of csrc/models.cuh, a template parameter;
// the kernel is instantiated for the unicycle, the cartpole and the
// quadrotor in f32 and f64 (entry points in forward.cu and forward_lanes.cu,
// which nvcc builds in parallel).
//
// What bounds it on the H100: the latency of each lane's dependent chain,
// ū from the carry x̄, then four dependent model evaluations per knot.  The
// bytes (x, u, K, d, λ, ρ in, x̄, ū out: 38 MB per launch in f32 at
// B=4096, N=100, 11 µs at 3.35 TB/s) and the operations are far below it.
// The chain stays on one thread per lane, with the state in registers;
// everything else is taken off it, onto a second warp:
//   - it copies the next chunk of `knots` knots of its lanes' X, U, K, d,
//     λ, ρ into shared memory with cp.async (16-byte copies of whole rows
//     of the block's lanes where the batch width allows), double-buffered
//     against the chunk the chain is on, so no knot waits on a
//     device-memory load;
//   - it adds the J terms (cost and AL values, Kahan-summed in the knots'
//     order) of the chunk before, from the x_k, ū_k the chain leaves in
//     shared memory;
//   - the problem descriptor and the cost table are staged in shared memory
//     once per block;
//   - blocks of 8 lanes: B=2048 launches 256 blocks on 132 SMs.
// X̄, Ū are stored directly: the stores of a knot do not stall the chain.
// `chain_only` replays the first chunk's inputs for every chunk, which
// times the chain alone (the floor of this design; chip_smoke.py's
// kernel_scaling phase).
//
// Per-instance params (altro_abi.h:AltroLanes) reach a second instantiation
// per model and scalar type, forward_lanes_kernel: the staging warp copies
// a knot's lane rows with its inputs (knot N's and the static rows once a
// block), the cost warp reads its lane's cost rows and constraint params
// from them, and each lane's chain takes its dynamics params into
// registers once, before its first knot.  Both kernels are the one body
// (LP = false / true); the shared-param kernel compiles to what it
// compiled to before.
//
// Measured on an H100 (kernel_scaling, PERF.md): the chain alone is most of
// a launch at B <= 4096, about 2 µs per knot for the unicycle, so what is
// left is the chain's own latency.  nvcc -Xptxas=-v, registers / stack
// bytes, no spill stores in any instance: unicycle f32 70 / 32, f64 112 /
// 40; cartpole f32 87 / 32, f64 130 / 40; quadrotor f32 162 / 0, f64 192 / 0.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "altro_abi.h"
#include "fused_common.cuh"
#include "models.cuh"

namespace altro {

constexpr int kFwdThreads = 64;  // the chain warp and the cost + staging warp
constexpr int kUnsolved = 1;      // SolverStatus.UNSOLVED
constexpr int kStateLimit = 2;    // SolverStatus.STATE_LIMIT
constexpr int kControlLimit = 3;  // SolverStatus.CONTROL_LIMIT

// Shared memory of one block: the descriptor, the cost table, two stages
// of knots × R rows × lanes, where a knot's R rows are x (n), u (m), K
// (m·n), d (m), λ (Ps) and ρ (Fs), and two trails of knots × (x, ū) × lanes
// that the chain leaves for the cost warp, then x_N.  The lane-params
// instantiation (LP) adds the lanes descriptor after the problem's, the
// knot's W lane rows to its R rows, and at the end knot N's W lane rows and
// the S static ones (the `tail`).  ops/forward.py mirrors it.
template <typename T, class Model, bool LP = false>
struct FwdLayout {
  static constexpr int n = Model::n, m = Model::m;
  static constexpr int X = 0, U = n, K = U + m, d = K + m * n, lam = d + m;  // row offsets
  int R, tab, stage, trail, tail, total;
  __host__ __device__ FwdLayout(const AltroGeometry& g, int Ps, int Fs, int W = 0, int S = 0) {
    R = lam + Ps + Fs + W;
    tab = align16(int(sizeof(AltroProblem))) + (LP ? align16(int(sizeof(AltroLanes))) : 0);
    stage = tab + align16(g.tab_smem * int(sizeof(T)));
    trail = stage + align16(2 * g.knots * R * g.lanes * int(sizeof(T)));
    tail = trail + align16((2 * g.knots * (n + m) + n) * g.lanes * int(sizeof(T)));
    total = tail + align16((W + S) * g.lanes * int(sizeof(T)));
  }
};

// Row q of knot k in device memory (its lane b0 at offset b0); with LP the
// rows after ρ are the knot's lane rows of the lane table (W a knot)
template <typename T, class Model, bool LP = false>
__device__ __forceinline__ const T* input_row(const AltroForwardArgs& a, int k, int q,
                                              const T* lane_tab = nullptr, int W = 0) {
  using Lay = FwdLayout<T, Model>;
  constexpr int n = Model::n, m = Model::m;
  const long Bl = a.B;
  if (q < Lay::U) return static_cast<const T*>(a.X) + (long(k) * n + q) * Bl;
  if (q < Lay::K) return static_cast<const T*>(a.U) + (long(k) * m + q - Lay::U) * Bl;
  if (q < Lay::d) return static_cast<const T*>(a.K) + (long(k) * m * n + q - Lay::K) * Bl;
  if (q < Lay::lam) return static_cast<const T*>(a.d) + (long(k) * m + q - Lay::d) * Bl;
  if (q < Lay::lam + a.Ps) return static_cast<const T*>(a.lam) + (long(k) * a.Ps + q - Lay::lam) * Bl;
  if constexpr (LP) {
    const int w = q - Lay::lam - a.Ps - a.Fs;
    if (w >= 0) return lane_tab + (long(k) * W + w) * Bl;
  }
  return static_cast<const T*>(a.lam_rho) + (long(k) * a.Fs + q - Lay::lam - a.Ps) * Bl;
}

// cp.async of chunk c's rows of the block's lanes into `dst`
// ([knot][row][lane]) by the threads tid = 0 .. nt-1; 16-byte copies when
// `vec`, else one per element, skipping lanes past B.  Knots past N are
// left alone.
template <typename T, class Model, bool LP = false>
__device__ __forceinline__ void stage_chunk(const AltroForwardArgs& a, int R, int N, int c, T* dst,
                                            bool vec, int tid, int nt, const T* lane_tab = nullptr,
                                            int W = 0) {
  const int L = a.geo.lanes, KC = a.geo.knots, b0 = blockIdx.x * L;
  if (vec) {
    constexpr int V = 16 / int(sizeof(T));
    const int per_row = L / V;
    for (int e = tid; e < KC * R * per_row; e += nt) {
      const int row = e / per_row, v = e % per_row, k = c * KC + row / R;
      if (k >= N) break;
      cp_async<16>(dst + row * L + v * V, input_row<T, Model, LP>(a, k, row % R, lane_tab, W) + b0 + v * V);
    }
  } else {
    for (int e = tid; e < KC * R * L; e += nt) {
      const int row = e / L, l = e % L, k = c * KC + row / R;
      if (k >= N) break;
      if (b0 + l < a.B) {
        cp_async<int(sizeof(T))>(dst + e, input_row<T, Model, LP>(a, k, row % R, lane_tab, W) + b0 + l);
      }
    }
  }
}

// The J terms of knot k (k == N: the terminal terms) for one lane, Kahan-
// added in the TPU kernel's order: the cost families, then the constraint
// families, a gated zero where a family with stage knots is off.  s: the knot's staged rows of this lane, row q
// at s[q * L] (stage knots only).  With LP the lane's own params come from
// `ln` and `lv`, its staged lane rows of knot k.
template <typename T, class Model, bool LP = false>
__device__ __forceinline__ void add_cost_terms(const AltroForwardArgs& a, const AltroProblem& pr,
                                               const T* ctab, int k, const T* x, const T* ub,
                                               const T* s, int L, int b, T& J, T& comp,
                                               const AltroLanes* ln = nullptr,
                                               const LaneView<T>& lv = LaneView<T>()) {
  using Lay = FwdLayout<T, Model>;
  constexpr int n = Model::n, m = Model::m;
  const int N = pr.N;
  const long Bl = a.B;
  // quad_value of family fi's row at knot kk
  const auto quad = [&](const AltroCostFam& f, int fi, int kk, const T* u) -> T {
    const T* cr = cost_row<T, n, m>(ctab, f, kk);
    if constexpr (LP) return quad_value<T, n, m>(lane_cost_row<T, n, m>(*ln, lv, cr, fi), x, u);
    return quad_value<T, n, m>(cr, x, u);
  };
  if (k == N) {
    for (int fi = 0; fi < pr.n_cost; ++fi) {
      const AltroCostFam& f = pr.cost[fi];
      if (f.k1 == N) kahan_add(J, comp, quad(f, fi, N, nullptr));
    }
    for (int fi = 0; fi < pr.n_con; ++fi) {
      const AltroConFam& f = pr.con[fi];
      if (f.term_row < 0) continue;
      const T rho_c = static_cast<const T*>(a.lamT_rho)[long(f.term_fam) * Bl + b];
      kahan_add(J, comp,
                al_family<T, n, m, false, LP>(f, x, nullptr, static_cast<const T*>(a.lamT) + long(f.term_row) * Bl + b,
                                              Bl, rho_c, nullptr, nullptr, nullptr, nullptr, nullptr,
                                              lane_con<T, LP>(ln, lv, fi)));
    }
    return;
  }
  for (int fi = 0; fi < pr.n_cost; ++fi) {
    const AltroCostFam& f = pr.cost[fi];
    if (f.k0 > N - 1) continue;
    const int hi = f.k1 < N - 1 ? f.k1 : N - 1;
    const bool inr = k >= f.k0 && k <= hi;
    kahan_add(J, comp, inr ? quad(f, fi, k, ub) : T(0));
  }
  for (int fi = 0; fi < pr.n_con; ++fi) {
    const AltroConFam& f = pr.con[fi];
    if (f.stage_row < 0) continue;
    const int hi = f.k1 < N - 1 ? f.k1 : N - 1;
    T Jc = T(0);
    if (k >= f.k0 && k <= hi) {
      const T rho_c = s[(Lay::lam + a.Ps + f.stage_fam) * L];
      Jc = al_family<T, n, m, false, LP>(f, x, ub, s + (Lay::lam + f.stage_row) * L, L, rho_c, nullptr,
                                         nullptr, nullptr, nullptr, nullptr, lane_con<T, LP>(ln, lv, fi));
    }
    kahan_add(J, comp, Jc);
  }
}

// The lane's next step size after a rejected try, α / f, rounded as the
// lockstep search's eager `alpha / f` rounds it on the card: PyTorch divides
// a CUDA tensor by a Python number as a product with the number's
// reciprocal, taken in double (the same as the quotient where f is a power
// of two, the default 2 among them)
template <typename T>
__device__ __forceinline__ T next_alpha(T alpha, double factor) {
  return mul_rn(alpha, T(__ddiv_rn(1.0, factor)));
}

// Two warps per block.  Warp 0 runs each lane's chain over chunk c of
// knots from the stage, leaving x_k, ū_k in the trail; meanwhile warp 1
// adds the J terms of chunk c − 1 from the trail, then stages chunk c + 1
// into the buffer those terms were read from.  The barrier ends each
// iteration.  With LP (the lane-params instantiation) the lanes descriptor
// `lng` and the lane table are read as well: a knot's lane rows are staged
// with its inputs, knot N's and the static ones once, and each lane's chain
// reads its dynamics params once, before its first knot.
//
// With SEARCH the block runs its lanes' line searches (altro_abi.h): after
// each try the cost warp tests each lane's try as the lockstep search does
// (valid, z = (J0 − J)/expected in [lower, upper], J < J0, with expected =
// −α(ΔV1 + αΔV2) and z = −1 where expected ≤ 0), in the same roundings;
// lanes that accept or have spent their budget stop, and while any lane of
// the block searches, the block stages its chunks again and runs the
// searching lanes' next try at α / f.  The others idle: a block waits for
// its own slowest lane only, and a lane with budget 0 runs no try.
template <typename T, class Model, bool LP, bool SEARCH>
__device__ __forceinline__ void forward_body(AltroForwardArgs a, const AltroProblem* __restrict__ prg,
                                             const AltroLanes* __restrict__ lng, const T* __restrict__ lane_tab) {
  using Lay = FwdLayout<T, Model, LP>;
  constexpr int n = Model::n;
  constexpr int m = Model::m;
  constexpr int nm = n + m;
  extern __shared__ __align__(16) unsigned char smem[];
  int W = 0, S = 0;  // lane rows per knot, static lane rows
  if constexpr (LP) {
    W = lng->knot_rows;
    S = lng->static_rows;
  }
  const Lay lay(a.geo, a.Ps, a.Fs, W, S);
  AltroProblem& pr = *reinterpret_cast<AltroProblem*>(smem);
  const T* ctab = stage_problem<T>(&pr, reinterpret_cast<T*>(smem + lay.tab), prg,
                                   static_cast<const T*>(a.cost_tab), a.geo.tab_smem);
  AltroLanes* ln = reinterpret_cast<AltroLanes*>(smem + align16(int(sizeof(AltroProblem))));
  T* tail = reinterpret_cast<T*>(smem + lay.tail);  // knot N's lane rows, then the static ones
  if constexpr (LP) block_copy(ln, lng, int(sizeof(AltroLanes) / 4), threadIdx.x, blockDim.x);
  T* stg = reinterpret_cast<T*>(smem + lay.stage);
  T* trail = reinterpret_cast<T*>(smem + lay.trail);
  const int N = pr.N, L = a.geo.lanes, KC = a.geo.knots, R = lay.R;
  const int buf_len = KC * R * L, trail_len = KC * nm * L;
  const int chunks = (N + KC - 1) / KC;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int b = blockIdx.x * L + l;
  const bool lane_ok = l < L && b < a.B;
  const long Bl = a.B;
  T* xfin = trail + 2 * trail_len + l;  // x_N of this lane, row i at xfin[i * L]

  // whole 16-byte rows when the block is full and every row starts aligned
  bool vec = L % (16 / int(sizeof(T))) == 0 && blockIdx.x * L + L <= a.B &&
             (a.B * sizeof(T)) % 16 == 0;
  const std::uintptr_t ptrs = reinterpret_cast<std::uintptr_t>(a.X) | reinterpret_cast<std::uintptr_t>(a.U) |
                              reinterpret_cast<std::uintptr_t>(a.K) | reinterpret_cast<std::uintptr_t>(a.d) |
                              reinterpret_cast<std::uintptr_t>(a.lam) |
                              reinterpret_cast<std::uintptr_t>(a.lam_rho) |
                              reinterpret_cast<std::uintptr_t>(lane_tab);
  vec = vec && (ptrs & 15u) == 0;
  // the lane runs the block's try: both warps hold the same `run`
  bool run = lane_ok;
  int budget = 0;
  if constexpr (SEARCH) {
    budget = lane_ok ? a.budget[b] : 0;
    run = budget > 0;
    if (!__syncthreads_or(run)) {  // no lane of the block searches
      if (warp == 1 && lane_ok) {
        static_cast<T*>(a.alpha_out)[b] = static_cast<const T*>(a.alpha)[b];
        static_cast<T*>(a.J)[b] = static_cast<const T*>(a.J0)[b];
        static_cast<T*>(a.z)[b] = T(-1);
        static_cast<int*>(a.success)[b] = 0;
        static_cast<int*>(a.tries)[b] = 0;
      } else if (warp == 0 && lane_ok) {
        static_cast<int*>(a.valid)[b] = 1;
        static_cast<int*>(a.status)[b] = kUnsolved;
      }
      return;
    }
  }
  if (warp == 1) {
    stage_chunk<T, Model, LP>(a, R, N, 0, stg, vec, l, 32, lane_tab, W);
    if constexpr (LP) {
      const int b0 = blockIdx.x * L;
      for (int e = l; e < (W + S) * L; e += 32) {
        const int le = e % L;
        if (b0 + le < a.B) cp_async<int(sizeof(T))>(tail + e, lane_tab + (long(N) * W + e / L) * Bl + b0 + le);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  const T* __restrict__ tt = static_cast<const T*>(a.t);
  const T* __restrict__ hh = static_cast<const T*>(a.h);
  T* __restrict__ Xn = static_cast<T*>(a.Xn);
  T* __restrict__ Ub = static_cast<T*>(a.Ubar);
  const T smax2 = T(pr.state_max2);
  const T cmax2 = T(pr.control_max2);
  T alpha = lane_ok && (SEARCH || warp == 0) ? static_cast<const T*>(a.alpha)[b] : T(0);
  // a lane's static lane rows (row s at stat[s * L])
  const T* stat = tail + W * L + (lane_ok ? l : 0);
  const DynParams<T, Model> dp = [&] {
    if constexpr (LP) return DynParams<T, Model>(pr, *ln, stat, L);
    else return DynParams<T, Model>(pr);
  }();
  // the search's state of the lane, kept by the cost warp, which tests the tries
  T J0 = T(0), dV1 = T(0), dV2 = T(0), Jv = T(0), zl = T(-1);
  int tries = 0;
  bool success = false;
  if constexpr (SEARCH) {
    if (warp == 1 && lane_ok) {
      J0 = static_cast<const T*>(a.J0)[b];
      dV1 = static_cast<const T*>(a.dV1)[b];
      dV2 = static_cast<const T*>(a.dV2)[b];
      Jv = J0;
    }
  }

  T x[n];
  T J, comp;
  bool valid = true;
  int status = kUnsolved;
  for (;;) {  // one try a pass; the plain kernel makes one
    if (warp == 0 && run) {
      valid = true;
      status = kUnsolved;
    }
#pragma unroll
    for (int i = 0; i < n; ++i) {
      x[i] = run && warp == 0 ? static_cast<const T*>(a.x0)[long(i) * Bl + b] : T(0);
    }
    J = T(0);
    comp = T(0);

    for (int c = 0; c <= chunks; ++c) {
      if (warp == 0) {
        if (c < chunks && run) {
          const T* sb = stg + (a.chain_only ? 0 : (c & 1) * buf_len) + l;
          T* tr = trail + (c & 1) * trail_len + l;
          for (int kc = 0; kc < KC; ++kc) {
            const int k = c * KC + kc;
            if (k >= N) break;
            const T* s = sb + kc * R * L;  // row q of this lane at s[q * L]
            const T t_k = tt[k];
            const T h_k = hh[k];
            T dx[n], ub[m];
#pragma unroll
            for (int j = 0; j < n; ++j) dx[j] = x[j] - s[(Lay::X + j) * L];
#pragma unroll
            for (int i = 0; i < m; ++i) {
              T fb = s[(Lay::K + i * n) * L] * dx[0];
#pragma unroll
              for (int j = 1; j < n; ++j) fb += s[(Lay::K + i * n + j) * L] * dx[j];
              ub[i] = s[(Lay::U + i) * L] + fb + alpha * s[(Lay::d + i) * L];
            }
#pragma unroll
            for (int i = 0; i < n; ++i) tr[(kc * nm + i) * L] = x[i];
#pragma unroll
            for (int i = 0; i < m; ++i) tr[(kc * nm + n + i) * L] = ub[i];

            T xn[n];
            dyn_step<T, Model>(pr.method, dp.p, x, ub, t_k, h_k, xn);
            if (a.check_bounds) {
              T xn2 = xn[0] * xn[0], un2 = ub[0] * ub[0];
#pragma unroll
              for (int i = 1; i < n; ++i) xn2 += xn[i] * xn[i];
#pragma unroll
              for (int i = 1; i < m; ++i) un2 += ub[i] * ub[i];
              const bool state_ok = xn2 <= smax2;
              const bool ctrl_ok = un2 <= cmax2;
              const bool step_ok = state_ok && ctrl_ok;
              if (valid && !step_ok) status = !state_ok ? kStateLimit : kControlLimit;
              valid = valid && step_ok;
              if (valid) {
#pragma unroll
                for (int i = 0; i < n; ++i) x[i] = xn[i];
              }
            } else {
#pragma unroll
              for (int i = 0; i < n; ++i) x[i] = xn[i];
            }
#pragma unroll
            for (int i = 0; i < n; ++i) Xn[(long(k) * n + i) * Bl + b] = x[i];
#pragma unroll
            for (int i = 0; i < m; ++i) Ub[(long(k) * m + i) * Bl + b] = ub[i];
          }
          if (c == chunks - 1) {
#pragma unroll
            for (int i = 0; i < n; ++i) xfin[i * L] = x[i];
          }
        }
      } else {
        if (c >= 1 && run) {
          const T* sb = stg + (a.chain_only ? 0 : ((c - 1) & 1) * buf_len) + l;
          const T* tr = trail + ((c - 1) & 1) * trail_len + l;
          for (int kc = 0; kc < KC; ++kc) {
            const int k = (c - 1) * KC + kc;
            if (k >= N) break;
            T xk[n], ub[m];
#pragma unroll
            for (int i = 0; i < n; ++i) xk[i] = tr[(kc * nm + i) * L];
#pragma unroll
            for (int i = 0; i < m; ++i) ub[i] = tr[(kc * nm + n + i) * L];
            add_cost_terms<T, Model, LP>(a, pr, ctab, k, xk, ub, sb + kc * R * L, L, b, J, comp, ln,
                                         LaneView<T>{sb + (kc * R + R - W) * L, stat, L});
          }
          if (c == chunks) {
            T xN[n];
#pragma unroll
            for (int i = 0; i < n; ++i) xN[i] = xfin[i * L];
            add_cost_terms<T, Model, LP>(a, pr, ctab, N, xN, nullptr, nullptr, L, b, J, comp, ln,
                                         LaneView<T>{tail + l, stat, L});
            if constexpr (!SEARCH) static_cast<T*>(a.J)[b] = sub_rn(J, comp);
          }
        }
        __syncwarp();  // the terms of chunk c - 1 are read before its buffer is refilled
        if (c + 1 < chunks && !a.chain_only) {
          stage_chunk<T, Model, LP>(a, R, N, c + 1, stg + ((c + 1) & 1) * buf_len, vec, l, 32, lane_tab, W);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    if constexpr (!SEARCH) {
      break;
    } else {
      // the trail is free once the last chunk's terms are in: it carries
      // each lane's `valid` to the cost warp, and its next α and whether it
      // goes on back to the chain warp
      T* sc = trail;
      if (warp == 0 && run) sc[l] = valid ? T(1) : T(0);
      __syncthreads();
      if (warp == 1 && run) {
        const T Jt = sub_rn(J, comp);
        const bool v = sc[l] != T(0);
        const T expected = mul_rn(-alpha, add_rn(dV1, mul_rn(alpha, dV2)));
        const T zt = expected > T(0) ? div_rn(sub_rn(J0, Jt), expected) : T(-1);
        const bool ok = v && T(a.lower) <= zt && zt <= T(a.upper) && Jt < J0;
        if (v) Jv = Jt;
        zl = zt;
        ++tries;
        success = ok;
        if (!ok) alpha = next_alpha(alpha, a.factor);
        run = !ok && tries < budget;
        sc[L + l] = alpha;
        sc[2 * L + l] = run ? T(1) : T(0);
      }
      if (!__syncthreads_or(warp == 1 && run)) break;
      if (warp == 0 && run) {
        alpha = sc[L + l];
        run = sc[2 * L + l] != T(0);
      }
      if (warp == 1) {
        stage_chunk<T, Model, LP>(a, R, N, 0, stg, vec, l, 32, lane_tab, W);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
    }
  }
  if (warp == 0 && lane_ok) {
    static_cast<int*>(a.valid)[b] = valid ? 1 : 0;
    static_cast<int*>(a.status)[b] = status;
  }
  if constexpr (SEARCH) {
    if (warp == 1) {
      if (lane_ok) {
        static_cast<T*>(a.alpha_out)[b] = alpha;
        static_cast<T*>(a.J)[b] = Jv;
        static_cast<T*>(a.z)[b] = zl;
        static_cast<int*>(a.success)[b] = success ? 1 : 0;
        static_cast<int*>(a.tries)[b] = tries;
      }
      // the block's tries, its lanes with a budget and the lane tries it
      // ran (its slowest lane's tries for each of its lanes), into the
      // launch's counts
      const unsigned sum = __reduce_add_sync(0xffffffffu, unsigned(tries));
      const unsigned slowest = __reduce_max_sync(0xffffffffu, unsigned(tries));
      const unsigned lanes = __popc(__ballot_sync(0xffffffffu, budget > 0));
      const unsigned block = __popc(__ballot_sync(0xffffffffu, lane_ok));
      if (l == 0 && a.counts != nullptr) {
        unsigned long long* cnt = static_cast<unsigned long long*>(a.counts);
        atomicAdd(cnt, static_cast<unsigned long long>(sum));
        atomicAdd(cnt + 1, static_cast<unsigned long long>(lanes));
        atomicAdd(cnt + 2, static_cast<unsigned long long>(slowest) * block);
      }
    }
  }
}

// minBlocksPerMultiprocessor 1: left to itself ptxas holds the kernel to 64
// registers and spills in f32 (the cartpole's, with the circle rows); the
// chain is what bounds it, not the blocks an SM holds.  SEARCH: the line
// search (altro_abi.h), the same body and name
template <typename T, class Model, bool SEARCH>
__global__ void __launch_bounds__(kFwdThreads, 1)
forward_kernel(AltroForwardArgs a, const AltroProblem* __restrict__ prg) {
  forward_body<T, Model, false, SEARCH>(a, prg, nullptr, nullptr);
}

// the lane-params instantiation: per-instance params from the lane table
template <typename T, class Model, bool SEARCH>
__global__ void __launch_bounds__(kFwdThreads, 1)
forward_lanes_kernel(AltroForwardArgs a, const AltroProblem* __restrict__ prg, const AltroLanes* __restrict__ lng,
                     const T* __restrict__ lane_tab) {
  forward_body<T, Model, true, SEARCH>(a, prg, lng, lane_tab);
}

template <typename T, class Model, bool LP, bool SEARCH>
int launch_forward_kernel(const AltroForwardArgs* args, const AltroProblem* prob, void* stream,
                          const AltroLanes* lanes_dev, const void* lane_tab) {
  const AltroGeometry& g = args->geo;
  const int grid = (args->B + g.lanes - 1) / g.lanes;
  if (grid > 0) {
    static int smem_set = 48 * 1024;  // the most dynamic shared memory allowed so far
    if (g.smem > smem_set) {
      cudaError_t err;
      if constexpr (LP) {
        err = cudaFuncSetAttribute(forward_lanes_kernel<T, Model, SEARCH>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
      } else {
        err = cudaFuncSetAttribute(forward_kernel<T, Model, SEARCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   g.smem);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = g.smem;
    }
    if constexpr (LP) {
      forward_lanes_kernel<T, Model, SEARCH><<<grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
          *args, prob, lanes_dev, static_cast<const T*>(lane_tab));
    } else {
      forward_kernel<T, Model, SEARCH>
          <<<grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(*args, prob);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// `lanes` (host) and `lanes_dev`, `lane_tab` (device): the lane-params
// instantiation's, nullptr for the shared-param one
template <typename T, class Model, bool LP = false>
int launch_forward(const AltroForwardArgs* args, const AltroProblem* prob, void* stream,
                   const AltroLanes* lanes = nullptr, const AltroLanes* lanes_dev = nullptr,
                   const void* lane_tab = nullptr) {
  using Lay = FwdLayout<T, Model, LP>;
  const AltroGeometry& g = args->geo;
  const int W = LP ? lanes->knot_rows : 0, S = LP ? lanes->static_rows : 0;
  if (g.lanes < 1 || g.lanes > 32 || g.knots < 1 || g.threads != kFwdThreads ||
      Lay(g, args->Ps, args->Fs, W, S).total != g.smem || (args->search && args->chain_only)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->search) return launch_forward_kernel<T, Model, LP, true>(args, prob, stream, lanes_dev, lane_tab);
  return launch_forward_kernel<T, Model, LP, false>(args, prob, stream, lanes_dev, lane_tab);
}

}  // namespace altro


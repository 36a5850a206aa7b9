// Fused closed-loop rollout + AL cost, one thread per batch lane.
//
// Replaces the TPU kernel ForwardKernel._make_kernel(check_bounds)
// (altro_tpu/ops/forward_pallas.py:534-685, launched by _get_call
// :687-713).  Per lane, forward over k = 0 ... N-1: ū = u + K(x̄−x) + αd;
// the stage quadratic cost and the AL value of the stage constraints; the
// RK4 step; with check_bounds, the divergence guard (freeze the state at
// the first ‖x‖² > state_max² or ‖ū‖² > control_max², status STATE_LIMIT /
// CONTROL_LIMIT); then the terminal cost and terminal AL terms.  J is a
// Kahan sum.  With α = 0 and K = d = 0 it is the open-loop rollout + cost
// that starts each inner solve (launched with check_bounds = 0).
//
// The model is a device functor of csrc/models.cuh, a template parameter;
// the kernel is instantiated for the unicycle, the cartpole and the
// quadrotor in f32 and f64 (entry points at the end of this file).
//
// What bounds it on the H100: the latency of each lane's dependent chain.
// Per knot a lane reads x, u, K, d, λ, ρ (18 values for the unicycle) and
// writes x̄, ū (5), about 38 MB per launch in f32 at B=4096, N=100 (11 µs at
// 3.35 TB/s), against ~150-200 flops per knot (four dynamics evaluations,
// the cost and the AL rows).  The state carry stays in registers and the
// batch-last layout keeps every load coalesced.  At B=4096 the grid is 32
// blocks of 128 threads on 132 SMs, so most of the card idles and each
// knot's dependent chain is exposed; filling the card is left to a later
// change.
#include <cuda_runtime.h>

#include "altro_abi.h"
#include "fused_common.cuh"
#include "models.cuh"

namespace altro {

constexpr int kFwdBlock = 128;
constexpr int kUnsolved = 1;      // SolverStatus.UNSOLVED
constexpr int kStateLimit = 2;    // SolverStatus.STATE_LIMIT
constexpr int kControlLimit = 3;  // SolverStatus.CONTROL_LIMIT

template <typename T, class Model>
__global__ void __launch_bounds__(kFwdBlock)
forward_kernel(AltroForwardArgs a, const AltroProblem* __restrict__ pr) {
  constexpr int n = Model::n;
  constexpr int m = Model::m;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = a.B;
  if (b >= B) return;
  const int N = pr->N;
  const long Bl = B;
  const T* __restrict__ ctab = static_cast<const T*>(a.cost_tab);
  const T* __restrict__ tt = static_cast<const T*>(a.t);
  const T* __restrict__ hh = static_cast<const T*>(a.h);
  const T* __restrict__ X = static_cast<const T*>(a.X);
  const T* __restrict__ U = static_cast<const T*>(a.U);
  const T* __restrict__ Kg = static_cast<const T*>(a.K);
  const T* __restrict__ dg = static_cast<const T*>(a.d);
  const T* __restrict__ lam = static_cast<const T*>(a.lam);
  const T* __restrict__ lam_rho = static_cast<const T*>(a.lam_rho);
  const T* __restrict__ lamT = static_cast<const T*>(a.lamT);
  const T* __restrict__ lamT_rho = static_cast<const T*>(a.lamT_rho);
  T* __restrict__ Xn = static_cast<T*>(a.Xn);
  T* __restrict__ Ub = static_cast<T*>(a.Ubar);
  const T smax2 = T(pr->state_max2);
  const T cmax2 = T(pr->control_max2);
  const T alpha = static_cast<const T*>(a.alpha)[b];
  const DynParams<T, Model> dp(pr);

  T x[n];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = static_cast<const T*>(a.x0)[long(i) * Bl + b];
  T J = T(0), comp = T(0);
  bool valid = true;
  int status = kUnsolved;

  for (int k = 0; k < N; ++k) {
    const T t_k = tt[k];
    const T h_k = hh[k];
    T dx[n], ub[m];
#pragma unroll
    for (int j = 0; j < n; ++j) dx[j] = x[j] - X[(long(k) * n + j) * Bl + b];
#pragma unroll
    for (int i = 0; i < m; ++i) {
      T fb = Kg[((long(k) * m + i) * n) * Bl + b] * dx[0];
#pragma unroll
      for (int j = 1; j < n; ++j) fb += Kg[((long(k) * m + i) * n + j) * Bl + b] * dx[j];
      ub[i] = U[(long(k) * m + i) * Bl + b] + fb + alpha * dg[(long(k) * m + i) * Bl + b];
    }

    // stage cost: quadratic families active at knot k
    for (int fi = 0; fi < pr->n_cost; ++fi) {
      const AltroCostFam& f = pr->cost[fi];
      if (f.k0 > N - 1) continue;
      const int hi = f.k1 < N - 1 ? f.k1 : N - 1;
      const bool inr = k >= f.k0 && k <= hi;
      kahan_add(J, comp, inr ? quad_value<T, n, m>(cost_row<T, n, m>(ctab, f, k), x, ub) : T(0));
    }
    // AL terms of the stage constraint families
    for (int fi = 0; fi < pr->n_con; ++fi) {
      const AltroConFam& f = pr->con[fi];
      if (f.stage_row < 0) continue;
      const int hi = f.k1 < N - 1 ? f.k1 : N - 1;
      T Jc = T(0);
      if (k >= f.k0 && k <= hi) {
        const T rho_c = lam_rho[(long(k) * a.Fs + f.stage_fam) * Bl + b];
        const T* lam_k = lam + (long(k) * a.Ps + f.stage_row) * Bl + b;
        Jc = al_family<T, n, m, false>(f, x, ub, lam_k, Bl, rho_c, nullptr, nullptr, nullptr,
                                       nullptr);
      }
      kahan_add(J, comp, Jc);
    }

    T xn[n];
    dyn_step<T, Model>(pr->method, dp.p, x, ub, t_k, h_k, xn);
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

  // terminal cost and terminal AL terms
  for (int fi = 0; fi < pr->n_cost; ++fi) {
    const AltroCostFam& f = pr->cost[fi];
    if (f.k1 == N) kahan_add(J, comp, quad_value<T, n, m>(cost_row<T, n, m>(ctab, f, N), x, nullptr));
  }
  for (int fi = 0; fi < pr->n_con; ++fi) {
    const AltroConFam& f = pr->con[fi];
    if (f.term_row < 0) continue;
    const T rho_c = lamT_rho[long(f.term_fam) * Bl + b];
    kahan_add(J, comp,
              al_family<T, n, m, false>(f, x, nullptr, lamT + long(f.term_row) * Bl + b, Bl,
                                        rho_c, nullptr, nullptr, nullptr, nullptr));
  }
  static_cast<T*>(a.J)[b] = sub_rn(J, comp);
  static_cast<int*>(a.valid)[b] = valid ? 1 : 0;
  static_cast<int*>(a.status)[b] = status;
}

template <typename T, class Model>
int launch_forward(const AltroForwardArgs* args, const AltroProblem* prob, void* stream) {
  const int grid = (args->B + kFwdBlock - 1) / kFwdBlock;
  if (grid > 0) {
    forward_kernel<T, Model><<<grid, kFwdBlock, 0, static_cast<cudaStream_t>(stream)>>>(*args, prob);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace altro

extern "C" {

#define ALTRO_FORWARD_ENTRY(NAME, MODEL, T)                                                   \
  int altro_forward_##NAME(const AltroForwardArgs* args, const AltroProblem* prob, void* stream) { \
    return altro::launch_forward<T, altro::MODEL>(args, prob, stream);                          \
  }
ALTRO_FORWARD_ENTRY(unicycle_f32, Unicycle, float)
ALTRO_FORWARD_ENTRY(unicycle_f64, Unicycle, double)
ALTRO_FORWARD_ENTRY(cartpole_f32, Cartpole, float)
ALTRO_FORWARD_ENTRY(cartpole_f64, Cartpole, double)
ALTRO_FORWARD_ENTRY(quadrotor_f32, Quadrotor, float)
ALTRO_FORWARD_ENTRY(quadrotor_f64, Quadrotor, double)
#undef ALTRO_FORWARD_ENTRY

}  // extern "C"

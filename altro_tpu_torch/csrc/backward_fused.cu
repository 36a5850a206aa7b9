// Fused expansion + Riccati backward sweep, one thread per batch lane.
//
// Replaces the TPU kernel BackwardFusedKernel._make_kernel
// (altro_tpu/ops/backward_fused_pallas.py:302-531, launched by _get_call
// :533-558).  Per lane, sweeping k = N-1 ... 0: the terminal expansion gives
// P_N, p_N (and the terminal cost into J); at each knot the quadratic-cost
// gradient and Hessian, the AL Gauss-Newton terms of the goal and
// control-bound rows, and the RK4 A, B by the chain rule; then the Q terms,
// the Cholesky of Quu + ρI with a NaN-safe failure flag, K and d, the gain
// guard, and the P, p update reusing (Qxu K)ᵀ.  ΔV1, ΔV2 and P, p freeze at
// a lane's first failure; J0 is a Kahan sum.  A pure function of its inputs
// and ρ, so the regularization retry loop can relaunch it.
//
// The model is a device functor of csrc/models.cuh, a template parameter;
// the kernel is instantiated for the unicycle, the cartpole and the
// quadrotor in f32 and f64 (entry points at the end of this file).
//
// What bounds it on the H100: per-lane arithmetic and registers, and the
// latency of each lane's dependent chain.  Per knot a lane reads x, u, λ, ρ
// (10 values for the unicycle) and writes K, d (8), about 30 MB per launch
// in f32 at B=4096, N=100 (9 µs at 3.35 TB/s), against ~1,000-1,500 flops
// per knot, ~6e8 per launch (9 µs at the 67 TFLOP/s f32 peak).  The carry
// (P, p, ΔV, J) and the expansion live in registers for the unicycle, so
// nothing spills to device memory between knots, and loads and stores are
// coalesced because the batch is the fastest axis.  At n=13 the per-lane
// arrays (P, A, the RK4 chain rule's four n×n products) exceed the
// registers and live in local memory.  At B=4096 the grid is 32 blocks of
// 128 threads on 132 SMs: most of the card idles, and each SM's four warps
// cannot hide the dependent-instruction latency.  Filling the card (smaller
// blocks, or one lane's work split across threads) is left to a later
// change.
#include <cuda_runtime.h>

#include "altro_abi.h"
#include "fused_common.cuh"
#include "models.cuh"
#include "riccati_step.cuh"

namespace altro {

constexpr int kBlock = 128;

template <typename T, class Model>
__global__ void __launch_bounds__(kBlock)
backward_fused_kernel(AltroBackwardArgs a, const AltroProblem* __restrict__ pr) {
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
  const T* __restrict__ lam = static_cast<const T*>(a.lam);
  const T* __restrict__ lam_rho = static_cast<const T*>(a.lam_rho);
  const T* __restrict__ lamT = static_cast<const T*>(a.lamT);
  const T* __restrict__ lamT_rho = static_cast<const T*>(a.lamT_rho);
  const T glim = T(pr->gain_limit);
  const DynParams<T, Model> dp(pr);

  T x[n], u[m];
  T J = T(0), comp = T(0);
  T P[n * n], p[n];
#pragma unroll
  for (int i = 0; i < n * n; ++i) P[i] = T(0);
#pragma unroll
  for (int i = 0; i < n; ++i) p[i] = T(0);

  // ---- terminal expansion -> P_N, p_N (+ terminal cost into J)
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = X[(long(N) * n + i) * Bl + b];
  for (int fi = 0; fi < pr->n_cost; ++fi) {
    const AltroCostFam& f = pr->cost[fi];
    if (f.k1 != N) continue;
    const T* cr = cost_row<T, n, m>(ctab, f, N);
    kahan_add(J, comp, quad_value<T, n, m>(cr, x, nullptr));
    quad_expand_add<T, n, m>(cr, x, nullptr, p, nullptr, P, nullptr, nullptr);
  }
  for (int fi = 0; fi < pr->n_con; ++fi) {
    const AltroConFam& f = pr->con[fi];
    if (f.term_row < 0) continue;
    const T rho_c = lamT_rho[long(f.term_fam) * Bl + b];
    const T Jc = al_family<T, n, m, true>(f, x, nullptr, lamT + long(f.term_row) * Bl + b, Bl,
                                          rho_c, p, nullptr, P, nullptr);
    kahan_add(J, comp, Jc);
  }

  // ---- Riccati sweep
  const T rho = static_cast<const T*>(a.rho)[b];
  T dv1 = T(0), dv2 = T(0);
  bool failed = false;
  for (int k = N - 1; k >= 0; --k) {
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] = X[(long(k) * n + i) * Bl + b];
#pragma unroll
    for (int i = 0; i < m; ++i) u[i] = U[(long(k) * m + i) * Bl + b];
    const T t_k = tt[k];
    const T h_k = hh[k];
    T lx[n], lu[m], lxx[n * n], lxu[n * m], luu[m * m];
#pragma unroll
    for (int i = 0; i < n; ++i) lx[i] = T(0);
#pragma unroll
    for (int i = 0; i < m; ++i) lu[i] = T(0);
#pragma unroll
    for (int i = 0; i < n * n; ++i) lxx[i] = T(0);
#pragma unroll
    for (int i = 0; i < n * m; ++i) lxu[i] = T(0);
#pragma unroll
    for (int i = 0; i < m * m; ++i) luu[i] = T(0);

    for (int fi = 0; fi < pr->n_cost; ++fi) {
      const AltroCostFam& f = pr->cost[fi];
      if (f.k0 > N - 1) continue;  // terminal-only family
      const int hi = f.k1 < N - 1 ? f.k1 : N - 1;
      if (k < f.k0 || k > hi) {  // the TPU kernel adds a gated zero here
        kahan_add(J, comp, T(0));
        continue;
      }
      const T* cr = cost_row<T, n, m>(ctab, f, k);
      kahan_add(J, comp, quad_value<T, n, m>(cr, x, u));
      quad_expand_add<T, n, m>(cr, x, u, lx, lu, lxx, lxu, luu);
    }
    for (int fi = 0; fi < pr->n_con; ++fi) {
      const AltroConFam& f = pr->con[fi];
      if (f.stage_row < 0) continue;
      const int hi = f.k1 < N - 1 ? f.k1 : N - 1;
      if (k < f.k0 || k > hi) {
        kahan_add(J, comp, T(0));
        continue;
      }
      const T rho_c = lam_rho[(long(k) * a.Fs + f.stage_fam) * Bl + b];
      const T* lam_k = lam + (long(k) * a.Ps + f.stage_row) * Bl + b;
      kahan_add(J, comp, al_family<T, n, m, true>(f, x, u, lam_k, Bl, rho_c, lx, lu, lxx, luu));
    }

    T A[n * n], Bd[n * m];
    dyn_jacobian<T, Model>(pr->method, dp.p, x, u, t_k, h_k, A, Bd);

    // ---- Riccati step (riccati_pallas._kernel, csrc/riccati_step.cuh)
    T K[m * n], d[m];
    riccati_step<T, n, m>(A, Bd, lxx, lxu, luu, lx, lu, rho, glim, P, p, dv1, dv2, failed, K, d);

    T* Ko = static_cast<T*>(a.K);
    T* dout = static_cast<T*>(a.d);
#pragma unroll
    for (int i = 0; i < m * n; ++i) Ko[(long(k) * m * n + i) * Bl + b] = K[i];
#pragma unroll
    for (int i = 0; i < m; ++i) dout[(long(k) * m + i) * Bl + b] = d[i];
  }

  static_cast<T*>(a.dV1)[b] = dv1;
  static_cast<T*>(a.dV2)[b] = dv2;
  static_cast<int*>(a.failed)[b] = failed ? 1 : 0;
  static_cast<T*>(a.J0)[b] = sub_rn(J, comp);
}

template <typename T, class Model>
int launch_backward(const AltroBackwardArgs* args, const AltroProblem* prob, void* stream) {
  const int grid = (args->B + kBlock - 1) / kBlock;
  if (grid > 0) {
    backward_fused_kernel<T, Model>
        <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(*args, prob);
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

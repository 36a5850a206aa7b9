// Plain C interface shared by the kernels and their Python wrappers.
//
// The wrappers (altro_tpu_torch/ops/_build.py) mirror these structs field
// for field with ctypes; altro_abi_sizes() lets them check the layout before
// the first launch.  Problem data travel in one AltroProblem that the
// wrapper copies to device memory once per parameter set; every thread reads
// the same entries, so the loads are broadcast and stay in L1.
#pragma once

#define ALTRO_MAX_FAMS 4  // cost families, and constraint families, per problem
#define ALTRO_NMAX 16     // largest state dimension a descriptor holds
#define ALTRO_NDYN 8      // dynamics parameters per problem (csrc/models.cuh)

// A quadratic cost family ½xᵀQx + xᵀHu + ½uᵀRu + qᵀx + rᵀu + c over the
// knots k0..k1, its params shared by every lane.  They sit in the cost
// table (`cost_tab` of the launch, in its scalar type) from element
// `offset` on, one row per knot k0..k1 when `stacked` and one row for all
// knots otherwise.  A row is Q [n*n], R [m*m], H [n*m], q [n], r [m], c,
// matrices row-major with the model's n and m as strides.
struct AltroCostFam {
  int k0, k1, stacked, offset;
};

enum { ALTRO_GOAL = 0, ALTRO_CONTROL_BOUND = 1, ALTRO_CIRCLE = 2 };
enum { ALTRO_CONE_ZERO = 0, ALTRO_CONE_NEGATIVE_ORTHANT = 1 };

// A structured constraint family over the knots k0..k1 with p rows.
//   goal:          c = x - a                      (p = n)
//   control_bound: c = [a[j] - u[j] for j in lo, u[j] - b[j] for j in hi]
//                  where lo and hi are the bits of lo_mask and hi_mask,
//                  ascending
//   circle:        row o is r[o]² - dx² - dy² with dx = x[xi] - a[o] and
//                  dy = x[yi] - b[o] (centre a[o], b[o], radius r[o]), in
//                  compensated arithmetic (lane_algebra.cuh:comp_circle)
// Its multipliers sit in the packed AL buffers: stage rows
// stage_row..stage_row+p-1 of lam [N, Ps, B] and row stage_fam of
// lam_rho [N, Fs, B]; the terminal knot's in lamT [Pt, B] / lamT_rho
// [Ft, B] at term_row / term_fam.  -1 marks a family without stage (or
// terminal) knots.  The circle families of one problem share one (xi, yi)
// pair: the fused backward kernel keeps one off-diagonal Gauss-Newton word
// per knot for it.
struct AltroConFam {
  int kind, cone;
  int k0, k1, p;
  int stage_row, stage_fam, term_row, term_fam;
  int lo_mask, hi_mask;
  int xi, yi;
  double a[ALTRO_NMAX];
  double b[ALTRO_NMAX];
  double r[ALTRO_NMAX];
};

struct AltroProblem {
  int N;
  int method;  // 0: RK4, 1: explicit Euler
  int n_cost, n_con;
  double gain_limit;    // SolverOptions.bp_gain_limit
  double state_max2;    // SolverOptions.state_max squared
  double control_max2;  // SolverOptions.control_max squared
  double dyn[ALTRO_NDYN];  // the model's parameters, in its functor's order
  AltroCostFam cost[ALTRO_MAX_FAMS];
  AltroConFam con[ALTRO_MAX_FAMS];
};

// Per-instance params (a trailing batch axis on a param leaf,
// altro_tpu_torch/solver/batched.py:batch_axes) reach the lane-params
// instantiations of the fused kernels (the `_lanes` entry points) in a lane
// table [rows, B] of the launch's scalar type, batch last like X and U: per
// knot k = 0..N, `knot_rows` rows of the per-knot leaves (stacked cost
// params of a family over every knot) from row k * knot_rows on, then
// `static_rows` rows of the other per-lane leaves.  A leaf's source gives
// the row of its entry 0 among its knot's rows (kstride != 0) or among the
// static rows (kstride == 0); off = -1 marks a leaf the batch shares, which
// the kernel reads from AltroProblem or the cost table as it does without
// lanes (where the descriptor then holds a zero).  The shared-param entry
// points and their structs are left as they were, so that their code stays
// what it was.
struct AltroLaneSrc {
  int off, kstride;
};

struct AltroLanes {
  int knot_rows, static_rows;
  AltroLaneSrc dyn[ALTRO_NDYN];          // AltroProblem.dyn[i]
  AltroLaneSrc cost[ALTRO_MAX_FAMS][6];  // AltroProblem.cost[f]'s Q, R, H, q, r, c
  AltroLaneSrc con[ALTRO_MAX_FAMS][3];   // AltroProblem.con[f]'s a, b, r (goal: xf; control bound: lb, ub; circle: cx, cy, r)
};

// Launch geometry of a kernel, chosen by its wrapper
// (ops/backward_fused.py:FusedKernel.geometry, ops/riccati.py:
// RiccatiKernel.geometry); the grid is ceil(B / lanes) blocks.  The kernel
// lays out its shared memory from these numbers and its launcher refuses a
// geometry whose `smem` is not that layout's size.
struct AltroGeometry {
  int lanes;     // batch lanes per block
  int knots;     // knots per chunk of the block's pipeline
  int group;     // threads per lane in the backward sweep (4, 8 or 16: above n, a power of two)
  int threads;   // threads per block
  int smem;      // dynamic shared memory per block, bytes
  int tab_smem;  // cost-table entries staged in shared memory (0: read in device memory; the Riccati sweep has none)
};

// Device pointers to tensors of the launch's scalar type, batch last.
struct AltroBackwardArgs {
  const void *cost_tab;          // cost rows, see AltroCostFam
  const void *t, *h;             // [N+1], [N]
  const void *X, *U;             // [N+1, n, B], [N, m, B]
  const void *rho;               // [B] regularization
  const void *lam, *lam_rho;     // [N, Ps, B], [N, Fs, B]
  const void *lamT, *lamT_rho;   // [Pt, B], [Ft, B]
  void *K, *d;                   // out: [N, m, n, B], [N, m, B]
  void *dV1, *dV2, *J0;          // out: [B]
  void *failed;                  // out: [B] int32
  int B, Ps, Fs, Pt, Ft;
  AltroGeometry geo;
};

struct AltroForwardArgs {
  const void *cost_tab;          // cost rows, see AltroCostFam
  const void *t, *h;             // [N+1], [N]
  const void *x0, *alpha;        // [n, B], [B]
  const void *X, *U, *K, *d;     // [N+1, n, B], [N, m, B], [N, m, n, B], [N, m, B]
  const void *lam, *lam_rho;     // [N, Ps, B], [N, Fs, B]
  const void *lamT, *lamT_rho;   // [Pt, B], [Ft, B]
  void *Xn, *Ubar;               // out: [N, n, B], [N, m, B]
  void *J;                       // out: [B]
  void *valid, *status;          // out: [B] int32
  int B, Ps, Fs, Pt, Ft, check_bounds;
  // 1 stages only the first chunk of inputs and replays it for every chunk:
  // the time of the rollout's dependent chain alone (wrong outputs; the
  // kernel_scaling phase of chip_smoke.py measures with it)
  int chain_only;
  // The line search (search = 1, forward_kernel<T, Model, true>): from
  // α = alpha[b], each lane tries α, α/f, α/f², ... until a try is accepted
  // or it has run budget[b] tries, as the lockstep search of
  // solver/batched.py:_line_search_sequential does (ilqr.hpp:512-558).
  // Xn, Ubar, valid and status are then those of the lane's last try and J
  // its last valid cost (J0 before any).
  const void *J0, *dV1, *dV2;    // [B]: the cost before the search, the expected decrease's terms
  const int *budget;             // [B]: the lane's tries (0: it runs none)
  void *alpha_out, *z;           // out: [B] the last α (divided once more after a last rejection), the last ratio
  void *success, *tries;         // out: [B] int32
  void *counts;                  // [3] int64, added to: the tries, the lanes with a budget and the
                                 // lane tries the blocks ran (a block's slowest lane's, each lane)
  double lower, upper, factor;   // the ratio's bounds, the decrease factor f
  int search;
  AltroGeometry geo;
};

// The stand-alone Riccati sweep over materialized expansions (riccati.cu).
// Knot N of lxx and lx is the terminal cost-to-go P_N, p_N.
struct AltroRiccatiArgs {
  const void *A, *Bd;            // [N, n, n, B], [N, n, m, B]
  const void *lxx, *lxu, *luu;   // [N+1, n, n, B], [N+1, n, m, B], [N+1, m, m, B]
  const void *lx, *lu;           // [N+1, n, B], [N+1, m, B]
  const void *rho;               // [B] regularization
  void *K, *d;                   // out: [N, m, n, B], [N, m, B]
  void *dV1, *dV2;               // out: [B]
  void *failed;                  // out: [B] int32
  double gain_limit;             // SolverOptions.bp_gain_limit
  int N, B;
  AltroGeometry geo;
};

#ifdef __cplusplus
extern "C" {
#endif
// sizeof of AltroProblem, AltroBackwardArgs, AltroForwardArgs, AltroRiccatiArgs, AltroLanes
void altro_abi_sizes(int* out);
// (kFOps, kTangentOps) of the unicycle, cartpole, quadrotor and dof-2 triple
// integrator functors (csrc/models.cuh), eight ints
void altro_model_ops(int* out);
// Each entry point launches on `stream` and returns cudaGetLastError().
// altro_{backward_fused,forward}_{model}_{f32,f64} for the models of
// csrc/models.cuh: unicycle, cartpole, quadrotor, triple_integrator2
// and their lane-params instantiations altro_{backward_fused,forward}_lanes_*,
// which take the lanes descriptor twice (on the host, where the launcher
// checks the geometry against it, and on the device) and the lane table
#define ALTRO_FUSED_DECL(MODEL, S)                                                        \
  int altro_backward_fused_##MODEL##_##S(const AltroBackwardArgs* args, const AltroProblem* prob, \
                                         void* stream);                                   \
  int altro_forward_##MODEL##_##S(const AltroForwardArgs* args, const AltroProblem* prob, void* stream); \
  int altro_backward_fused_lanes_##MODEL##_##S(const AltroBackwardArgs* args, const AltroProblem* prob, \
                                               const AltroLanes* lanes, const AltroLanes* lanes_dev, \
                                               const void* lane_tab, void* stream);                \
  int altro_forward_lanes_##MODEL##_##S(const AltroForwardArgs* args, const AltroProblem* prob,      \
                                        const AltroLanes* lanes, const AltroLanes* lanes_dev,       \
                                        const void* lane_tab, void* stream);
ALTRO_FUSED_DECL(unicycle, f32) ALTRO_FUSED_DECL(unicycle, f64)
ALTRO_FUSED_DECL(cartpole, f32) ALTRO_FUSED_DECL(cartpole, f64)
ALTRO_FUSED_DECL(quadrotor, f32) ALTRO_FUSED_DECL(quadrotor, f64)
ALTRO_FUSED_DECL(triple_integrator2, f32) ALTRO_FUSED_DECL(triple_integrator2, f64)
#undef ALTRO_FUSED_DECL
// out[i] = the compensated circle row (lane_algebra.cuh:comp_circle) of
// dx[i], dy[i], r[i], i < count: the arithmetic the fused kernels run on
// each circle row, exposed so that its rows can be held bit for bit
// against the plain version's on the card
int altro_circle_rows_f32(const float* dx, const float* dy, const float* r, float* out, int count,
                          void* stream);
int altro_circle_rows_f64(const double* dx, const double* dy, const double* r, double* out,
                          int count, void* stream);
// altro_riccati_n{n}m{m}_{f32,f64} for (n, m) in (3,2), (4,1), (6,2), (13,4)
#define ALTRO_RICCATI_DECL(NN, MM, S) \
  int altro_riccati_n##NN##m##MM##_##S(const AltroRiccatiArgs* args, void* stream);
ALTRO_RICCATI_DECL(3, 2, f32) ALTRO_RICCATI_DECL(3, 2, f64)
ALTRO_RICCATI_DECL(4, 1, f32) ALTRO_RICCATI_DECL(4, 1, f64)
ALTRO_RICCATI_DECL(6, 2, f32) ALTRO_RICCATI_DECL(6, 2, f64)
ALTRO_RICCATI_DECL(13, 4, f32) ALTRO_RICCATI_DECL(13, 4, f64)
#undef ALTRO_RICCATI_DECL
#ifdef __cplusplus
}
#endif

"""The three-obstacle slice of the port against the JAX package, float64 on
the CPU (where the kernel wrappers run their plain versions): the circle
constraint, the three-obstacle scenario, the compensated circle rows, the
fused kernels' plain versions on the obstacle problem against the JAX
kernels in interpret mode (tolerances of tests/test_backward_fused.py:
105-117), per-lane options (`lane_opts`) and the restart portfolio of
`CompactedALSolver`.  The CUDA kernels themselves are held against their
plain versions on the card by tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu import circle_constraint as jcircle
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.ops.backward_fused_pallas import build_backward_fused_kernel
from altro_tpu.ops.forward_pallas import ForwardKernel as JForward
from altro_tpu.ops.forward_pallas import build_forward_kernel
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.solver.compaction import CompactedALSolver as JCompacted
from altro_tpu_torch import SolverOptions, SolverStatus, circle_constraint, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel, Ineligible, comp_circle
from altro_tpu_torch.ops.forward import ForwardKernel
from altro_tpu_torch.solver.batched import ALSolverBatched
from altro_tpu_torch.solver.compaction import CompactedALSolver

from _torch_fleet import F64, numpy_tree

OBST = "three_obstacles"
SCAN = dict(backward_pass="scan", forward_pass="scan")


def _jax_defn(N, dtype=jnp.float64):
    defn = JUnicycle(scenario=OBST, dtype=dtype)
    defn.N = N
    defn.__post_init__()
    return defn


def _jax_fleet_Z(defn, B):
    Z0 = defn.initial_trajectory()
    return to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0))


@pytest.mark.parametrize("xi,yi", [(0, 1), (2, 0)])
def test_circle_constraint_matches_jax(xi, yi):
    """Values and Jacobians of the keep-out rows, float64, at random states."""
    rng = np.random.default_rng(7)
    cx, cy, r = rng.uniform(-1, 1, 4), rng.uniform(-1, 1, 4), rng.uniform(0.1, 0.5, 4)
    cj = jcircle(jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(r), x_index=xi, y_index=yi)
    ct = circle_constraint(torch.as_tensor(cx), torch.as_tensor(cy), torch.as_tensor(r), x_index=xi, y_index=yi)
    assert (ct.structure, ct.cone.value, ct.dim) == (cj.structure, cj.cone.value, cj.dim)
    for _ in range(5):
        x, u = rng.uniform(-1.5, 1.5, 3), rng.uniform(-1, 1, 2)
        np.testing.assert_allclose(ct(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                                   np.asarray(cj(jnp.asarray(x), jnp.asarray(u))), rtol=1e-14, atol=1e-15)
        (Cx, Cu), (Cxj, Cuj) = ct.jacobian(torch.as_tensor(x), torch.as_tensor(u)), cj.jacobian(
            jnp.asarray(x), jnp.asarray(u))
        np.testing.assert_allclose(Cx.numpy(), np.asarray(Cxj), rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(Cu.numpy(), np.asarray(Cuj), rtol=0, atol=0)


def test_three_obstacle_problem_matches_jax():
    """Families, knot ranges, structures and params of the scenario."""
    pj = _jax_defn(30).make_problem().compile()
    defn = UnicycleProblem(scenario=OBST, N=30, device="cpu")
    pt = defn.make_problem().compile()
    assert (defn.tf, defn.h) == (5.0, float(np.float32(5.0) / np.float32(30)))
    assert len(pt.constraint_families) == len(pj.constraint_families) == 3
    for ft, fj, pt_, pj_ in zip(pt.constraint_families, pj.constraint_families, pt.params.constraints,
                                pj.params.constraints):
        assert ft.constraint.structure == fj.constraint.structure
        assert (ft.cone.value, ft.dim, ft.shared) == (fj.cone.value, fj.dim, fj.shared)
        np.testing.assert_array_equal(ft.knots, fj.knots)
        assert sorted(pt_) == sorted(pj_)
        for key in pt_:
            np.testing.assert_array_equal(pt_[key].numpy(), np.asarray(pj_[key]))
    circle = pt.constraint_families[1]
    assert circle.constraint.structure == ("circle", 0, 1)
    np.testing.assert_array_equal(circle.knots, np.arange(1, 30))
    for ft, fj, pt_, pj_ in zip(pt.cost_families, pj.cost_families, pt.params.costs, pj.params.costs):
        np.testing.assert_array_equal(ft.knots, fj.knots)
        for key in pt_:
            np.testing.assert_array_equal(pt_[key].numpy(), np.asarray(pj_[key]))
    np.testing.assert_array_equal(defn.initial_trajectory().U.numpy(), np.asarray(_jax_defn(30).initial_trajectory().U))


def _near_boundary(rng, n, dtype):
    """dx, dy, r with dx² + dy² within 1e-3 relative of r²: rows whose
    squares cancel, where the plain expression loses its digits."""
    r = rng.uniform(0.2, 1.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    rad = r * (1.0 + rng.uniform(-1e-3, 1e-3, n))
    return [np.asarray(a, dtype) for a in (rad * np.cos(phi), rad * np.sin(phi), r)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_comp_circle_bitwise_matches_jax(dtype):
    """comp_circle equals the TPU kernels' _comp_circle bit for bit, on rows
    near the boundary and far from it."""
    rng = np.random.default_rng(11)
    near = _near_boundary(rng, 4096, dtype)
    far = [np.asarray(rng.uniform(-3, 3, 4096), dtype), np.asarray(rng.uniform(-3, 3, 4096), dtype),
           np.asarray(rng.uniform(0.1, 1, 4096), dtype)]
    for dx, dy, r in (near, far):
        got = comp_circle(torch.as_tensor(dx), torch.as_tensor(dy), torch.as_tensor(r)).numpy()
        want = np.asarray(JForward._comp_circle(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(r)))
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_comp_circle_f32_error_is_relative():
    """In float32 the compensated row stays within 4 ulps of |c| of the
    exact value (float64 of the float32 inputs: their squares are exact
    there), where the plain float32 expression does not."""
    rng = np.random.default_rng(12)
    dx, dy, r = _near_boundary(rng, 4096, np.float32)
    exact = r.astype(np.float64) ** 2 - dx.astype(np.float64) ** 2 - dy.astype(np.float64) ** 2
    got = comp_circle(torch.as_tensor(dx), torch.as_tensor(dy), torch.as_tensor(r)).numpy()
    plain = r * r - dx * dx - dy * dy
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    err_c = np.abs(got.astype(np.float64) - exact) / ulp
    err_p = np.abs(plain.astype(np.float64) - exact) / ulp
    assert err_c.max() <= 4.0, err_c.max()
    assert np.median(err_p) > 4.0, np.median(err_p)


def test_plain_solver_switches_circle_rows_to_comp_circle():
    """The kernels' plain versions (compensated_circles) evaluate circle
    rows with comp_circle; the eager solver keeps the constraint's fn."""
    prob = UnicycleProblem(scenario=OBST, N=10, device="cpu", dtype=torch.float32).make_problem().compile()
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.uniform(0.3, 2.7, (11, 3, 64)), dtype=torch.float32)
    fam, fp = prob.constraint_families[1], prob.params.constraints[1]
    ks = torch.as_tensor(fam.knots, dtype=torch.long)
    Xk, Uk = X[ks], torch.zeros((len(ks), 2, 64), dtype=torch.float32)
    plain = ALSolverBatched(prob)._con_values(fam, fp, Xk, Uk)
    comp = ALSolverBatched(prob, compensated_circles=True)._con_values(fam, fp, Xk, Uk)
    want = comp_circle(Xk[:, 0, None] - fp["cx"][:, None], Xk[:, 1, None] - fp["cy"][:, None], fp["r"][:, None])
    assert torch.equal(comp, want)
    assert not torch.equal(plain, comp)
    torch.testing.assert_close(plain, comp, rtol=0, atol=1e-5)
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=torch.float32, device="cpu")
    assert kern._eager_solver().compensated_circles


def _kernel_case(N, B, seed):
    """The obstacle problem's expansion point with the circle rows active:
    states spread over the obstacle field (positions in [0.3, 2.7]²),
    controls uniform, a warm random AL state (λ in [-0.5, 0], ρ in
    [1, 10]); the JAX and port versions of the same data."""
    defn = _jax_defn(N)
    prob_j = defn.make_problem().compile()
    prob_t = UnicycleProblem(scenario=OBST, N=N, device="cpu").make_problem().compile()
    rng = np.random.default_rng(seed)
    Z_j = _jax_fleet_Z(defn, B)
    X = np.concatenate([rng.uniform(0.3, 2.7, (N + 1, 2, B)), rng.uniform(-np.pi, np.pi, (N + 1, 1, B))], axis=1)
    U = np.stack([rng.uniform(0.0, 1.5, (N, B)), rng.uniform(-1.0, 1.0, (N, B))], axis=1)
    Z_j = Z_j.replace(X=jnp.asarray(X), U=jnp.asarray(U))
    x0 = np.concatenate([rng.uniform(0.3, 1.2, (2, B)), rng.uniform(-np.pi, np.pi, (1, B))])
    params_j = prob_j.params.replace(x0=jnp.asarray(x0))
    al_j = tuple(
        dict(lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape)),
             rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)))
        for st in JSolver(prob_j, JOptions()).al_state_init(B, jnp.float64)
    )
    # share of the circle rows the AL penalizes (s = λ − ρc <= 0)
    ks = np.arange(1, N)
    cxy = np.stack([np.asarray(prob_j.params.constraints[1][k]) for k in ("cx", "cy", "r")])
    c = cxy[2][:, None] ** 2 - (X[ks, 0, None] - cxy[0][:, None]) ** 2 - (X[ks, 1, None] - cxy[1][:, None]) ** 2
    s = np.asarray(al_j[1]["lam"]) - np.asarray(al_j[1]["rho"])[:, None] * c
    return dict(
        prob_j=prob_j, prob_t=prob_t, params_j=params_j, Z_j=Z_j, al_j=al_j,
        params_t=convert.problem_params(numpy_tree(params_j), "cpu", F64),
        Z_t=convert.trajectory(numpy_tree(Z_j), "cpu", F64), al_t=convert.al_state(numpy_tree(al_j), "cpu", F64),
        active_share=float((s <= 0).mean()),
    )


@pytest.fixture(scope="module")
def kernel_case():
    case = _kernel_case(10, 1024, seed=3)
    kb = build_backward_fused_kernel(case["prob_j"], JOptions(), interpret=True, dtype=jnp.float64)
    kf = build_forward_kernel(case["prob_j"], JOptions(), interpret=True, dtype=jnp.float64)
    assert kb is not None and kf is not None
    case.update(kb=kb, kb_call=jax.jit(kb), kf=kf, kf_call=jax.jit(kf, static_argnames=("check_bounds",)))
    return case


def test_kernel_case_penalizes_circle_rows(kernel_case):
    """The comparisons below run the circle branch: more than a tenth of the
    rows are penalized, and both kernels take the problem."""
    assert 0.1 < kernel_case["active_share"] < 0.9
    for cls in (BackwardFusedKernel, ForwardKernel):
        kern = cls(kernel_case["prob_t"], SolverOptions(), dtype=F64, device="cpu")
        assert (kern.Ps, kern.Fs, kern.Pt, kern.Ft) == (7, 2, 3, 1)


@pytest.mark.parametrize("rho", [0.0, 0.37, 10.0])
def test_backward_plain_matches_jax_fused_kernel_obstacles(kernel_case, rho):
    c = kernel_case
    B = c["Z_t"].X.shape[-1]
    K0, d0, dV10, dV20, f0, J00 = (np.asarray(a) for a in c["kb_call"](
        c["params_j"], c["kb"].pad_al(c["al_j"]), c["Z_j"], jnp.full((B,), rho)))
    kern = BackwardFusedKernel(c["prob_t"], SolverOptions(), dtype=F64, device="cpu")
    K, d, dV1, dV2, failed, J0 = (o.numpy() for o in kern(
        c["params_t"], kern.pad_al(c["al_t"]), c["Z_t"], torch.full((B,), rho, dtype=F64)))
    assert kern.launches == 0
    np.testing.assert_array_equal(failed, f0)
    np.testing.assert_allclose(K, K0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(d, d0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(dV1, dV10, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(dV2, dV20, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(J0, J00, rtol=1e-10)


@pytest.mark.parametrize("alpha,guarded", [(1.0, True), (0.5, True), (0.0, False)])
def test_forward_plain_matches_jax_forward_kernel_obstacles(kernel_case, alpha, guarded):
    c = kernel_case
    B = c["Z_t"].X.shape[-1]
    K, d, *_ = c["kb_call"](c["params_j"], c["kb"].pad_al(c["al_j"]), c["Z_j"], jnp.full((B,), 0.37))
    if not guarded:
        K, d = jnp.zeros_like(K), jnp.zeros_like(d)
    ref = c["kf_call"](c["params_j"], c["kf"].pad_al(c["al_j"]), c["Z_j"], K, d, jnp.full((B,), alpha),
                       check_bounds=guarded)
    kern = ForwardKernel(c["prob_t"], SolverOptions(), dtype=F64, device="cpu")
    out = kern(c["params_t"], kern.pad_al(c["al_t"]), c["Z_t"], convert.tensor(K, "cpu", F64),
               convert.tensor(d, "cpu", F64), torch.full((B,), alpha, dtype=F64), check_bounds=guarded)
    Xn, Ubar, J, valid, status = (o.numpy() for o in out)
    Xn0, U0, J0, valid0, status0 = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(Xn, Xn0, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Ubar, U0, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(J, J0, rtol=1e-10)
    np.testing.assert_array_equal(valid, valid0)
    np.testing.assert_array_equal(status, status0)


def test_circle_families_on_two_pairs_are_ineligible():
    """The backward kernel keeps one off-diagonal word per knot: circle
    families on different (xi, yi) pairs raise Ineligible; the eager passes
    run them."""
    builder = UnicycleProblem(scenario=OBST, N=10, device="cpu").make_problem()
    builder.set_constraint(circle_constraint([1.0], [1.0], [0.2], x_index=1, y_index=2), range(2, 5))
    prob = builder.compile()
    for cls in (BackwardFusedKernel, ForwardKernel):
        with pytest.raises(Ineligible, match="coordinate pairs"):
            cls(prob, SolverOptions(), dtype=F64, device="cpu")
    solver = ALSolverBatched(prob, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    assert solver._bwd is None and solver._fwd is None


def _obstacle_fleet(N, B, seed, spread=0.1):
    """The fleet of perf/benchmark_obstacles.py at horizon N: x0 uniform in
    ±spread, lane 0 canonical; JAX and port copies."""
    defn = _jax_defn(N)
    prob_j = defn.make_problem().compile()
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-spread, spread, (3, B))
    x0[:, 0] = 0.0
    params_j = prob_j.params.replace(x0=jnp.asarray(x0))
    Z_j = _jax_fleet_Z(defn, B)
    prob_t = UnicycleProblem(scenario=OBST, N=N, device="cpu").make_problem().compile()
    return (prob_j, params_j, Z_j, prob_t, convert.problem_params(numpy_tree(params_j), "cpu", F64),
            convert.trajectory(numpy_tree(Z_j), "cpu", F64))


# per lane: penalty ladder, outer cap and total cap
LANE_OPTS = dict(
    penalty_scaling=[10.0, 4.0, 1.5, 10.0, 4.0, 10.0],
    max_iterations_outer=[30, 30, 30, 2, 3, 30],
    max_iterations_total=[300, 300, 300, 300, 300, 12],
)


def test_solve_lane_opts_matches_jax():
    """`solve(lane_opts=...)` on the scan path, float64: each lane follows its
    own penalty ladder and caps, as in the JAX package (statuses,
    iterations, U to 1e-8); the caps end lanes 3-5 early."""
    B = len(LANE_OPTS["penalty_scaling"])
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = _obstacle_fleet(20, B, seed=5)
    opts = dict(initial_penalty=1.0, constraint_tolerance=1e-4, **SCAN)
    lo_j = {k: jnp.asarray(v, jnp.float64 if k == "penalty_scaling" else jnp.int32) for k, v in LANE_OPTS.items()}
    ref = numpy_tree(jax.jit(JSolver(prob_j, JOptions(**opts)).solve)(params_j, Z_j, lane_opts=lo_j))
    lo_t = {k: torch.as_tensor(v, dtype=F64 if k == "penalty_scaling" else torch.int32) for k, v in LANE_OPTS.items()}
    res = ALSolverBatched(prob_t, SolverOptions(**opts)).solve(params_t, Z_t, lane_opts=lo_t)
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_array_equal(res["stats"].iterations_outer.numpy(), ref["stats"].iterations_outer)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=0, atol=1e-8)
    status = res["status"].numpy()
    assert status[3] == status[4] == int(SolverStatus.MAX_OUTER_ITERATIONS)
    assert status[5] == int(SolverStatus.MAX_ITERATIONS)
    assert len(set(res["stats"].iterations_total.numpy()[:3].tolist())) > 1  # the ladders differ


# the cascade of perf/benchmark_obstacles.py with caps small enough that the
# tail rounds leave a residue (max_iterations_total=20) and the variants
# solve some of it
PORTFOLIO = (
    dict(),
    dict(penalty_scaling=4.0, max_iterations_outer=60, max_iterations_total=90),
    dict(penalty_scaling=1.5, max_iterations_outer=120, max_iterations_total=110),
)


def test_restart_portfolio_matches_jax():
    """CompactedALSolver(restart_portfolio=...) on the scan path, float64,
    against the JAX one on the same fleet (statuses, U to 1e-8); the
    cascade runs on a non-empty residue and solves part of it."""
    B, W = 16, 8
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = _obstacle_fleet(20, B, seed=1, spread=0.3)
    opts = dict(initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10,
                max_iterations_total=20, **SCAN)
    kw = dict(phase1_iters=8, tail_batch=W, restart_portfolio=PORTFOLIO, restart_width=W, restart_rounds=1)
    ref = numpy_tree(JCompacted(prob_j, JOptions(**opts), device_tail=True, **kw).solve(params_j, Z_j))
    base = CompactedALSolver(prob_t, SolverOptions(**opts), phase1_iters=8, tail_batch=W, device_tail=True)
    before = base.solve(params_t, Z_t)["status"].numpy()
    comp = CompactedALSolver(prob_t, SolverOptions(**opts), device_tail=True, **kw)
    res = comp.solve(params_t, Z_t)
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=0, atol=1e-8)
    solved = int(SolverStatus.SOLVED)
    lanes = comp.telemetry["restart_lanes"]
    assert lanes and lanes[0] == min(int((before != solved).sum()), W) > 0
    assert (res["status"].numpy() == solved).sum() > (before == solved).sum()
    assert comp.telemetry["restart_host_syncs"] > len(lanes)

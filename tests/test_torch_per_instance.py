"""Per-instance problem params in the port against the JAX package, float64
on the CPU (where the kernel wrappers run their plain versions).

The randomized three-obstacle fleet (perf/benchmark_randomized.py:48-93,
at N=10): per-lane x0, obstacle layouts (cx, cy, r [3, B]), goals (xf
[3, B]) and the tracking cost's q [N+1, 3, B] and c [N+1, B], per knot and
per lane.  Held here: the kernels' per-instance signature (`param_sig`)
against the JAX kernels', the plain backward and forward passes against
the JAX package's eager ones (tolerances of
tests/test_kernel_per_instance.py:105-163), whole solves and the compacted
solver's tail and restart gathers against the JAX solvers, and per-lane
dynamics params (a scalar of a model without a device functor, the
cartpole's pole mass).  The CUDA kernels themselves are held against their
plain versions on the card by tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import Problem as JProblem
from altro_tpu import SolverOptions as JOptions
from altro_tpu import lqr_cost as jlqr
from altro_tpu.models.cartpole import cartpole_rk4 as jcartpole_rk4
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.ops.forward_pallas import Ineligible as JIneligible
from altro_tpu.ops.forward_pallas import build_forward_kernel
from altro_tpu.problem.dynamics import ContinuousModel as JContinuous
from altro_tpu.problem.dynamics import discretize as jdiscretize
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.solver.compaction import CompactedALSolver as JCompacted
from altro_tpu.types import initial_trajectory as jinitial_trajectory
from altro_tpu_torch import Problem, SolverOptions, SolverStatus, convert, lqr_cost
from altro_tpu_torch.models.cartpole import cartpole_rk4
from altro_tpu_torch.models.problems import UnicycleProblem, randomized_fleet
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel, Ineligible
from altro_tpu_torch.ops.forward import ForwardKernel
from altro_tpu_torch.problem.dynamics import ContinuousModel, discretize
from altro_tpu_torch.solver.batched import (
    ALSolverBatched, any_batched, batch_axes, gather_params,
)
from altro_tpu_torch.solver.compaction import CompactedALSolver

from _torch_fleet import F64, numpy_tree

OBST = "three_obstacles"
KERNEL_OPTS = dict(backward_pass="fused", forward_pass="cuda")


def _broadcast(Z0, B):
    return to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0))


def jax_randomized_fleet(N, B, seed=0):
    """perf/benchmark_randomized.py:make_randomized_fleet at N knots, in its
    draw order, float64, in both packages.  Returns (JAX problem, JAX
    params, JAX Z, port problem, port params, port Z)."""
    defn = JUnicycle(scenario=OBST, dtype=jnp.float64)
    defn.N = N
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(seed)
    params = prob_j.params
    cx0, cy0, r0 = defn.obstacles
    cx = jnp.asarray(cx0[:, None] + rng.uniform(-0.2, 0.2, (3, B)))
    cy = jnp.asarray(cy0[:, None] + rng.uniform(-0.2, 0.2, (3, B)))
    rr = jnp.asarray(r0[:, None] * rng.uniform(0.8, 1.1, (3, B)))
    kinds = [f.constraint.structure[0] for f in prob_j.constraint_families]
    cons = list(params.constraints)
    cons[kinds.index("circle")] = dict(cons[kinds.index("circle")], cx=cx, cy=cy, r=rr)
    xf = np.broadcast_to(defn.xf[:, None], (3, B)).copy()
    xf[0] += rng.uniform(0.0, 0.3, B)
    xf[1] += rng.uniform(0.0, 0.3, B)
    xf[2] += rng.uniform(-0.3, 0.3, B)
    xf = jnp.asarray(xf)
    cons[kinds.index("goal")] = dict(cons[kinds.index("goal")], xf=xf)
    cp0 = params.costs[0]
    Qstack = jnp.asarray(cp0["Q"])
    q = -jnp.einsum("kij,jb->kib", Qstack, xf)
    c = 0.5 * jnp.einsum("ib,kij,jb->kb", xf, Qstack, xf)
    params_j = params.replace(x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, B))),
                              constraints=tuple(cons), costs=(dict(cp0, q=q, c=c),))
    Z_j = _broadcast(defn.initial_trajectory(), B)
    defn_t = UnicycleProblem(scenario=OBST, N=N, dtype=F64, device="cpu")
    prob_t = defn_t.make_problem().compile()
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    return prob_j, params_j, Z_j, prob_t, params_t, convert.trajectory(numpy_tree(Z_j), "cpu", F64)


def test_the_port_draws_the_randomized_fleet_as_the_reference(fleet):
    """`models.problems.randomized_fleet` (what chip_smoke.py drives) draws
    the perf script's leaves in its order, from the same seed."""
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = fleet
    B = Z_t.X.shape[-1]
    defn = UnicycleProblem(scenario=OBST, N=10, dtype=F64, device="cpu")
    params, obstacles, xf = randomized_fleet(defn, prob_t, B, seed=0)
    for a, b in zip(_leaves_of(params), _leaves_of(params_t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-15, atol=1e-15)
    kinds = [f.constraint.structure[0] for f in prob_t.constraint_families]
    circle = params.constraints[kinds.index("circle")]
    np.testing.assert_array_equal(np.stack(obstacles), torch.stack([circle[k] for k in ("cx", "cy", "r")]).numpy())
    np.testing.assert_array_equal(xf, params.constraints[kinds.index("goal")]["xf"].numpy())


def _leaves_of(params):
    out = [params.x0]
    for tree in (*params.dynamics, *params.costs, *params.constraints):
        if isinstance(tree, dict):
            out.extend(tree[k] for k in sorted(tree))
    return out


@pytest.fixture(scope="module")
def fleet():
    return jax_randomized_fleet(10, 64)


def _warm_al(solver_j, B, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        dict(lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape)),
             rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)))
        for st in solver_j.al_state_init(B, jnp.float64)
    )


def test_batch_axes_and_gather_follow_the_trailing_batch_axis(fleet):
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = fleet
    canon = prob_t.params
    axes = batch_axes(canon.constraints, params_t.constraints)
    kinds = [f.constraint.structure[0] for f in prob_t.constraint_families]
    assert axes[kinds.index("circle")] == dict(cx=-1, cy=-1, r=-1)
    assert axes[kinds.index("goal")] == dict(xf=-1)
    assert axes[kinds.index("control_bound")] == dict(lb=None, ub=None)
    assert batch_axes(canon.costs, params_t.costs)[0] == dict(Q=None, R=None, H=None, q=-1, r=None, c=-1)
    assert any_batched(canon.costs, params_t.costs) and not any_batched(canon.costs, canon.costs)
    idx = torch.tensor([5, 0, 63, 5])
    g = gather_params(canon, params_t, idx)
    assert torch.equal(g.x0, params_t.x0[:, idx])
    assert torch.equal(g.costs[0]["q"], params_t.costs[0]["q"][..., idx])
    assert g.costs[0]["Q"] is params_t.costs[0]["Q"]
    assert torch.equal(g.constraints[kinds.index("circle")]["r"],
                       params_t.constraints[kinds.index("circle")]["r"][:, idx])


def _sig_pair(prob_j, prob_t, params_j, params_t):
    """(JAX ForwardKernel.param_sig, the port's forward and backward
    param_sig) of the same params; an Ineligible layout gives "Ineligible"
    (the JAX kernel is built in interpret mode and never called)."""
    kern = build_forward_kernel(prob_j, JOptions(), interpret=True, dtype=jnp.float64)

    def sig(fn, exc):
        try:
            return fn()
        except exc:
            return "Ineligible"

    out = [sig(lambda: kern.param_sig(params_j), JIneligible)]
    for cls in (ForwardKernel, BackwardFusedKernel):
        k = cls(prob_t, SolverOptions(), dtype=F64, device="cpu")
        out.append(sig(lambda: k.param_sig(params_t), Ineligible))
    return out


def test_param_sig_matches_jax_on_the_fleet(fleet):
    """The six per-lane leaves of the fleet, under the TPU kernels' names;
    none on the problem's own params; a per-knot and per-instance Q over
    the full knot range is taken, a leaf with two extra axes is not
    (tests/test_kernel_per_instance.py:261-288)."""
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = fleet
    j, f, b = _sig_pair(prob_j, prob_t, params_j, params_t)
    assert j == f == b and len(j) == 6
    assert {"cost0_q", "cost0_c"} <= j and sum(s.endswith(("_cx", "_cy", "_r", "_xf")) for s in j) == 4
    assert _sig_pair(prob_j, prob_t, prob_j.params, prob_t.params) == [frozenset()] * 3
    B = params_t.x0.shape[-1]
    nk, n = len(prob_t.cost_families[0].knots), prob_t.n
    Qj = jnp.broadcast_to(jnp.asarray(params_j.costs[0]["Q"])[..., None], (nk, n, n, B))
    ok_j = params_j.replace(costs=(dict(params_j.costs[0], Q=Qj),))
    ok_t = convert.problem_params(numpy_tree(ok_j), "cpu", F64)
    j, f, b = _sig_pair(prob_j, prob_t, ok_j, ok_t)
    assert j == f == b and "cost0_Q" in j
    bad_j = params_j.replace(costs=(dict(params_j.costs[0], q=jnp.zeros((nk, n, B, 1))),))
    bad_t = convert.problem_params(numpy_tree(bad_j), "cpu", F64)
    assert _sig_pair(prob_j, prob_t, bad_j, bad_t) == ["Ineligible"] * 3
    k = ForwardKernel(prob_t, SolverOptions(), dtype=F64, device="cpu")
    assert k.takes(ok_t) and not k.takes(bad_t)


@pytest.mark.parametrize("key", ["gravity", "mass_pole"])
def test_param_sig_names_per_lane_dynamics_as_jax(key):
    """A per-instance dynamics scalar is `dyn{i}` with i its place among the
    model's param keys in JAX's (sorted) order: the cartpole's gravity is
    dyn0, its pole mass dyn3."""
    N, B = 8, 5

    def make(pkg_problem, lqr, dyn, eye, zeros):
        prob = pkg_problem(N)
        prob.set_dynamics(dyn, range(N))
        prob.set_cost(lqr(eye(4) * 0.1, eye(1) * 0.01, zeros(4)), range(N))
        prob.set_cost(lqr(eye(4) * 10.0, zeros((1, 1)), zeros(4), terminal=True), N)
        prob.set_initial_state(zeros(4))
        return prob.compile()

    pj = make(JProblem, jlqr, jcartpole_rk4(), jnp.eye, jnp.zeros)
    pt = make(Problem, lqr_cost, cartpole_rk4(dtype=F64, device="cpu"),
              lambda k: torch.eye(k, dtype=F64), lambda s: torch.zeros(s, dtype=F64))
    vals = jnp.asarray(np.linspace(0.9, 1.1, B)) * jnp.asarray(pj.params.dynamics[0][key])
    params_j = pj.params.replace(dynamics=(dict(pj.params.dynamics[0], **{key: vals}),))
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    j, f, b = _sig_pair(pj, pt, params_j, params_t)
    assert j == f == b == {"dyn0" if key == "gravity" else "dyn3"}


def test_backward_plain_matches_jax_per_instance(fleet):
    """The fused backward kernel's plain version (K, d, ΔV1, ΔV2, failed,
    J0) on the randomized fleet with a random AL state equals JAX `expand` +
    `riccati_scan` + `total_cost` (tests/test_kernel_per_instance.py:
    138-163)."""
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = fleet
    B = Z_t.X.shape[-1]
    sj = JSolver(prob_j, JOptions())
    Z_j = sj.rollout(params_j, Z_j)
    Z_t = convert.trajectory(numpy_tree(Z_j), "cpu", F64)
    al_j = _warm_al(sj, B, 9)
    al_t = convert.al_state(numpy_tree(al_j), "cpu", F64)
    rho = jnp.full((B,), 0.1)
    exp = jax.jit(sj.expand)(params_j, al_j, Z_j)
    K0, d0, dV10, dV20, f0 = (np.asarray(a) for a in jax.jit(sj.riccati_scan)(exp, rho))
    J0r = np.asarray(jax.jit(sj.total_cost)(params_j, al_j, Z_j))
    kern = BackwardFusedKernel(prob_t, SolverOptions(), dtype=F64, device="cpu")
    assert kern.takes(params_t)
    K1, d1, dV11, dV21, f1, J01 = (a.numpy() for a in kern(
        params_t, kern.pad_al(al_t), Z_t, torch.full((B,), 0.1, dtype=F64)))
    assert kern.launches == 0
    np.testing.assert_allclose(K1, K0, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(d1, d0, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(dV11, dV10, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(dV21, dV20, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(J01, J0r, rtol=1e-10)
    np.testing.assert_array_equal(f1, f0)


def test_forward_plain_matches_jax_per_instance(fleet):
    """The forward kernel's plain version (X̄, Ū, J, valid, status) on the
    randomized fleet equals JAX `closed_loop_rollout` + `total_cost`
    (tests/test_kernel_per_instance.py:105-135)."""
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = fleet
    B = Z_t.X.shape[-1]
    sj = JSolver(prob_j, JOptions())
    Z_j = sj.rollout(params_j, Z_j)
    al_j = _warm_al(sj, B, 7)
    K, d, *_ = jax.jit(sj.riccati_scan)(jax.jit(sj.expand)(params_j, al_j, Z_j), jnp.zeros((B,)))
    alpha = jnp.full((B,), 0.5)
    Z_ref, valid_ref, status_ref = sj.closed_loop_rollout(params_j, Z_j, K, d, alpha)
    J_ref = sj.total_cost(params_j, al_j, Z_ref)
    t = lambda a: convert.tensor(np.asarray(a), "cpu", F64)  # noqa: E731
    kern = ForwardKernel(prob_t, SolverOptions(), dtype=F64, device="cpu")
    Xn, Ubar, J, valid, status = kern(
        params_t, kern.pad_al(convert.al_state(numpy_tree(al_j), "cpu", F64)),
        convert.trajectory(numpy_tree(Z_j), "cpu", F64), t(K), t(d), t(alpha), check_bounds=True)
    np.testing.assert_allclose(Xn.numpy(), np.asarray(Z_ref.X[1:]), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(Ubar.numpy(), np.asarray(Z_ref.U), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=1e-9, atol=1e-11)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    np.testing.assert_array_equal(status.numpy(), np.asarray(status_ref))


def test_whole_solve_matches_jax_per_instance():
    """`ALSolverBatched` on the kernels' path (their plain versions here)
    solves the randomized fleet (N=10, B=32) lane for lane as the JAX
    package's scan path does: statuses and total iterations equal, U to
    rtol 1e-7 (tests/test_kernel_per_instance.py:166-200)."""
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = jax_randomized_fleet(10, 32, seed=3)
    ref = numpy_tree(jax.jit(JSolver(prob_j, JOptions(initial_penalty=10.0)).solve)(params_j, Z_j))
    solver = ALSolverBatched(prob_t, SolverOptions(initial_penalty=10.0, **KERNEL_OPTS))
    assert solver._bwd is not None and solver._fwd is not None
    assert solver._bwd.takes(params_t) and solver._fwd.takes(params_t)
    res = solver.solve(params_t, Z_t)
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=1e-7, atol=1e-9)
    assert (res["status"].numpy() == int(SolverStatus.SOLVED)).mean() > 0.9


def _scaled_uni(pkg):
    """A unicycle whose wheel speed is scaled by the param `scale`, in the
    JAX package ("jax") or the port."""
    if pkg == "jax":
        def fn(params, x, u, t):
            s = params["scale"]
            return jnp.stack([s * u[0] * jnp.cos(x[2]), s * u[0] * jnp.sin(x[2]), u[1]])

        return jdiscretize(JContinuous(params={"scale": jnp.asarray(1.0)}, fn=fn, n=3, m=2,
                                       name="scaled_uni"), "rk4")

    def fn(params, x, u, t):
        s = params["scale"]
        return torch.stack([s * u[0] * torch.cos(x[2]), s * u[0] * torch.sin(x[2]), u[1]])

    return discretize(ContinuousModel(params={"scale": torch.tensor(1.0, dtype=F64)}, fn=fn, n=3, m=2,
                                      name="scaled_uni"), "rk4")


def test_per_instance_dynamics_scalar_rollout_and_cost():
    """A per-lane scalar of a model without a device functor (the scaled
    unicycle of tests/test_kernel_per_instance.py:203-258): the plain
    rollout, cost and RK4 Jacobians equal the JAX package's."""
    N, B = 8, 16

    def make(pkg_problem, lqr, dyn, eye, zeros, ones):
        prob = pkg_problem(N)
        prob.set_cost(lqr(eye(3) * 0.1, eye(2) * 0.1, ones(3)), range(N))
        prob.set_cost(lqr(eye(3) * 10.0, zeros((2, 2)), ones(3), terminal=True), N)
        prob.set_dynamics(dyn, range(N))
        prob.set_initial_state(zeros(3))
        return prob.compile()

    pj = make(JProblem, jlqr, _scaled_uni("jax"), jnp.eye, jnp.zeros, jnp.ones)
    pt = make(Problem, lqr_cost, _scaled_uni("torch"), lambda k: torch.eye(k, dtype=F64),
              lambda s: torch.zeros(s, dtype=F64), lambda s: torch.ones(s, dtype=F64))
    rng = np.random.default_rng(3)
    params_j = pj.params.replace(dynamics=({"scale": jnp.asarray(rng.uniform(0.5, 1.5, B))},),
                                 x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, B))))
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    Z0 = jinitial_trajectory(3, 2, N, 0.1, u0=np.full(2, 0.1), dtype=jnp.float64)
    Z_j = _broadcast(Z0, B)
    sj, st = JSolver(pj, JOptions()), ALSolverBatched(pt, SolverOptions())
    Zr_j = sj.rollout(params_j, Z_j)
    Zr_t = st.rollout(params_t, convert.trajectory(numpy_tree(Z_j), "cpu", F64))
    np.testing.assert_allclose(Zr_t.X.numpy(), np.asarray(Zr_j.X), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(st.total_cost(params_t, (), Zr_t).numpy(),
                               np.asarray(sj.total_cost(params_j, (), Zr_j)), rtol=1e-12, atol=1e-14)
    A_j, B_j = sj.dyn_jacobian_all(params_j, Zr_j)
    A_t, B_t = st.dyn_jacobian_all(params_t, Zr_t)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=1e-12, atol=1e-14)
    # the per-lane scale bites: a lane with another scale rolls out elsewhere
    assert np.abs(np.asarray(Zr_j.X)[-1, 0, 0] - np.asarray(Zr_j.X)[-1, 0, 1]) > 1e-4


def test_per_instance_cartpole_mass_solves_as_jax():
    """Per-lane pole masses (tests/test_batched_general.py:142): the
    cartpole swing-up solved on the kernels' path (plain versions here)
    lane for lane as the JAX package's scan path solves it: statuses and
    iterations equal, U within that test's bounds (rtol 1e-4, atol 1e-5,
    for the swing-up's rounding-sensitive dynamics)."""
    N, h, B = 30, 0.05, 3
    xf = np.array([0.0, np.pi, 0.0, 0.0])
    x0 = np.array([0.0, np.pi - 0.25, 0.0, 0.0])

    def make(pkg_problem, lqr, dyn, t):
        prob = pkg_problem(N)
        prob.set_dynamics(dyn, range(N))
        prob.set_cost(lqr(t(np.eye(4) * 0.1 * h), t(np.eye(1) * 0.01 * h), t(xf)), range(N))
        prob.set_cost(lqr(t(np.eye(4) * 100.0), t(np.zeros((1, 1))), t(xf), terminal=True), N)
        prob.set_initial_state(t(x0))
        return prob.compile()

    pj = make(JProblem, jlqr, jcartpole_rk4(mass_pole=0.3), jnp.asarray)
    pt = make(Problem, lqr_cost, cartpole_rk4(mass_pole=0.3, dtype=F64, device="cpu"),
              lambda a: torch.as_tensor(a, dtype=F64))
    params_j = pj.params.replace(
        dynamics=(dict(pj.params.dynamics[0], mass_pole=jnp.asarray([0.25, 0.3, 0.4])),))
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    Z_j = _broadcast(jinitial_trajectory(4, 1, N, h), B)
    opts = dict(gradient_tolerance=0.05)
    ref = numpy_tree(jax.jit(JSolver(pj, JOptions(**opts)).solve)(params_j, Z_j))
    solver = ALSolverBatched(pt, SolverOptions(**opts, **KERNEL_OPTS))
    assert solver._bwd.param_sig(params_t) == {"dyn3"} and solver._fwd.takes(params_t)
    res = solver.solve(params_t, convert.trajectory(numpy_tree(Z_j), "cpu", F64))
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=1e-4, atol=1e-5)
    assert np.all(res["status"].numpy() == int(SolverStatus.SOLVED))
    U = res["Z"].U.numpy()
    assert np.abs(U[..., 0] - U[..., 2]).max() > 1e-4  # the masses bite


# a restart cascade whose caps leave a residue after the tail rounds
PORTFOLIO = (
    dict(),
    dict(penalty_scaling=4.0, max_iterations_outer=60, max_iterations_total=90),
    dict(penalty_scaling=1.5, max_iterations_outer=120, max_iterations_total=110),
)


def test_compacted_solver_gathers_per_instance_params_as_jax():
    """`CompactedALSolver` on the randomized fleet (B=16, tail and restart
    width 8) against the JAX compacted solver (device tail): the tail
    rounds and the restart cascade gather every per-lane leaf with their
    lanes (tests/test_batched_general.py:176); statuses, iterations and U
    to 1e-8 agree, and the cascade runs on a non-empty residue."""
    B, W = 16, 8
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = jax_randomized_fleet(10, B, seed=1)
    opts = dict(initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10,
                max_iterations_total=20, backward_pass="scan", forward_pass="scan")
    kw = dict(phase1_iters=8, tail_batch=W, restart_portfolio=PORTFOLIO, restart_width=W, restart_rounds=1)
    ref = numpy_tree(JCompacted(prob_j, JOptions(**opts), device_tail=True, **kw).solve(params_j, Z_j))
    comp = CompactedALSolver(prob_t, SolverOptions(**opts), device_tail=True, **kw)
    res = comp.solve(params_t, Z_t)
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=0, atol=1e-8)
    assert comp.telemetry["tail_rounds"] >= 1 and comp.telemetry["restart_lanes"]

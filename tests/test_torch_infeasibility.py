"""Structural infeasibility certificates in the port against the JAX package,
float64 on the CPU: `goal_obstacle_certificates` on the problem of
tests/test_infeasibility.py (a circle family through knot N) and on draws
of the randomized three-obstacle fleet (circles at knots 1..N-1, so only
the reachability certificate applies), with goals moved inside, onto and
just outside a circle, with and without a step bound, shared and per-lane
leaves; and `CompactedALSolver(detect_infeasible=True)` against the JAX
compacted solver's device tail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import Problem as JProblem
from altro_tpu import SolverOptions as JOptions
from altro_tpu import circle_constraint as jcircle
from altro_tpu import control_bound as jcontrol_bound
from altro_tpu import goal_constraint as jgoal
from altro_tpu import lqr_cost as jlqr
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.models.unicycle import unicycle_rk4 as junicycle_rk4
from altro_tpu.problem.infeasibility import goal_obstacle_certificates as jcertificates
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.solver.compaction import CompactedALSolver as JCompacted
from altro_tpu.types import initial_trajectory as jinitial_trajectory
from altro_tpu_torch import (
    Problem, SolverOptions, SolverStatus, circle_constraint, control_bound, convert, goal_constraint, lqr_cost,
)
from altro_tpu_torch.models.problems import UnicycleProblem, randomized_fleet
from altro_tpu_torch.models.unicycle import unicycle_rk4
from altro_tpu_torch.problem.infeasibility import goal_obstacle_certificates
from altro_tpu_torch.solver.compaction import CompactedALSolver

from _torch_fleet import F64, numpy_tree

B = 8
BAD_LANE = 3  # its goal sits inside the obstacle


def _problems(N=30, tf=1.5):
    """tests/test_infeasibility.py:_prob in both packages: a circle through
    the terminal knot and a goal constraint at N."""
    n, m, h = 3, 2, tf / N
    xf = np.array([1.0, 1.0, 0.0])
    out = []
    for P, lqr, dyn, cb, circ, goal, t in (
        (JProblem, jlqr, junicycle_rk4, jcontrol_bound, jcircle, jgoal, jnp.asarray),
        (Problem, lqr_cost, unicycle_rk4, control_bound, circle_constraint, goal_constraint,
         lambda a: torch.as_tensor(np.asarray(a, np.float64))),
    ):
        prob = P(N)
        prob.set_initial_state(t(np.zeros(n)))
        prob.set_dynamics(dyn(), range(N))
        prob.set_cost(lqr(t(np.eye(n) * 1e-2 * h), t(np.eye(m) * 1e-2 * h), t(xf), t(np.zeros(m))), range(N))
        prob.set_cost(lqr(t(np.eye(n) * 100.0), t(np.zeros((m, m))), t(xf), t(np.zeros(m)), terminal=True), N)
        prob.set_constraint(cb(t([-1.5, -1.5]), t([1.5, 1.5])), range(N))
        prob.set_constraint(circ(t([0.5]), t([0.5]), t([0.2])), range(1, N + 1))
        prob.set_constraint(goal(t(xf)), N)
        out.append(prob.compile())
    return out[0], out[1], xf, h


def _with(prob, params, kind, **leaves):
    """`params` with the leaves of the `kind` constraint family replaced."""
    i = [f.constraint.structure[0] for f in prob.constraint_families].index(kind)
    cons = list(params.constraints)
    cons[i] = dict(cons[i], **leaves)
    return params.replace(constraints=tuple(cons))


def _both(prob_j, prob_t, params_np):
    """The same numpy params in each package."""
    pj = jax.tree_util.tree_map(jnp.asarray, params_np)
    return pj, convert.problem_params(params_np, "cpu", F64)


@pytest.mark.parametrize("layout", ["goal_per_lane", "all_per_lane", "all_shared_inside"])
@pytest.mark.parametrize("step_bound", [0.0, 0.05])
def test_certificates_match_jax_on_the_terminal_circle(layout, step_bound):
    """Masks equal the JAX function's on tests/test_infeasibility.py's
    problem; lane 3's goal inside the obstacle is flagged."""
    prob_j, prob_t, xf, _ = _problems()
    params_np = numpy_tree(prob_j.params)
    xfs = np.tile(xf[:, None], (1, B))
    xfs[:2, BAD_LANE] = [0.55, 0.5]
    want = np.arange(B) == BAD_LANE
    if layout == "all_shared_inside":
        params_np = _with(prob_j, params_np, "goal", xf=np.array([0.55, 0.5, 0.0]))
        want = np.ones(B, bool)
    else:
        params_np = _with(prob_j, params_np, "goal", xf=xfs)
    if layout == "all_per_lane":
        circ = params_np.constraints[[f.constraint.structure[0] for f in prob_j.constraint_families].index("circle")]
        params_np = _with(prob_j, params_np, "circle", **{k: np.tile(v[:, None], (1, B)) for k, v in circ.items()})
    pj, pt = _both(prob_j, prob_t, params_np)
    got = goal_obstacle_certificates(prob_t, pt, B, step_bound=step_bound)
    ref = np.asarray(jcertificates(prob_j, pj, B, step_bound=step_bound))
    assert got.dtype == torch.bool and tuple(got.shape) == (B,)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), want)


def test_certificates_match_jax_on_randomized_draws():
    """64 draws of the randomized fleet (N=100; circles at knots 1..N-1, so
    only the reachability certificate applies), goals moved into their own
    obstacle 0: deep inside, exactly on its edge, just outside, and inside
    by less and by more than the step bound.  Masks equal the JAX
    function's with and without the step bound."""
    Bd = 64
    defn = UnicycleProblem(scenario="three_obstacles", N=100, dtype=F64, device="cpu")
    prob_t = defn.make_problem().compile()
    params_t, (cx, cy, r), xf = randomized_fleet(defn, prob_t, Bd, seed=3)
    sb = float(defn.v_bnd * defn.tf / defn.N)
    depth = {  # lanes -> distance of the goal from obstacle 0's centre
        range(0, 4): lambda rr: 0.25 * rr,
        range(4, 8): lambda rr: rr,
        range(8, 12): lambda rr: rr * (1 + 1e-9),
        range(12, 16): lambda rr: rr - 0.5 * sb,
        range(16, 20): lambda rr: rr - 2.0 * sb,
    }
    xf = xf.copy()
    for lanes, dist in depth.items():
        for b in lanes:
            xf[0, b] = cx[0, b] + dist(r[0, b])
            xf[1, b] = cy[0, b]
    params_t = _with(prob_t, params_t, "goal", xf=torch.as_tensor(xf))
    jdefn = JUnicycle(scenario="three_obstacles", dtype=jnp.float64)
    prob_j = jdefn.make_problem(add_constraints=True).compile()
    pj = _with(prob_j, prob_j.params, "goal", xf=jnp.asarray(xf))
    pj = _with(prob_j, pj, "circle", cx=jnp.asarray(cx), cy=jnp.asarray(cy), r=jnp.asarray(r))
    assert [f.constraint.structure for f in prob_j.constraint_families] == [
        f.constraint.structure for f in prob_t.constraint_families]
    for step_bound in (0.0, sb):
        got = goal_obstacle_certificates(prob_t, params_t, Bd, step_bound=step_bound).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcertificates(prob_j, pj, Bd, step_bound=step_bound)))
        if step_bound == 0.0:
            assert not got.any()  # no circle family at knot N
        else:
            assert got[:4].all() and not got[4:16].any() and got[16:20].all()


def test_compacted_solver_reports_infeasible_as_jax():
    """`CompactedALSolver(detect_infeasible=True)` on the 8-lane problem,
    float64, scan passes, against the JAX solver's device tail: equal
    statuses (lane 3 INFEASIBLE, the rest SOLVED), zero iterations on the
    certified lane, U within 1e-8."""
    prob_j, prob_t, xf, h = _problems()
    xfs = np.tile(xf[:, None], (1, B))
    xfs[:2, BAD_LANE] = [0.55, 0.5]
    params_np = _with(prob_j, numpy_tree(prob_j.params), "goal", xf=xfs)
    pj, pt = _both(prob_j, prob_t, params_np)
    Z0 = jinitial_trajectory(3, 2, prob_j.N, h, u0=jnp.array([0.1, 0.0]))
    Z_j = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0))
    opts = dict(backward_pass="scan", forward_pass="scan", initial_penalty=1.0,
                line_search_max_iterations=20, max_stall_iterations=10)
    kw = dict(phase1_iters=10, tail_batch=B, detect_infeasible=True)
    ref = numpy_tree(JCompacted(prob_j, JOptions(**opts), device_tail=True, **kw).solve(pj, Z_j))
    comp = CompactedALSolver(prob_t, SolverOptions(**opts), device_tail=True, **kw)
    res = comp.solve(pt, convert.trajectory(numpy_tree(Z_j), "cpu", F64))
    status = res["status"].numpy()
    np.testing.assert_array_equal(status, ref["status"])
    assert status[BAD_LANE] == int(SolverStatus.INFEASIBLE)
    assert (np.delete(status, BAD_LANE) == int(SolverStatus.SOLVED)).all()
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    assert int(res["stats"].iterations_total[BAD_LANE]) == 0
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=0, atol=1e-8)

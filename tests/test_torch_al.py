"""The port's per-instance AL-iLQR (`altro_tpu_torch/solver/{al,functions}.py`)
against the reference's goldens, as `tests/test_al.py`
and `tests/test_penalty_api.py` hold the JAX package (the same numbers at
the same tolerances), and against the JAX package's `ALSolver` on the same
inputs (handed over by `altro_tpu_torch.convert`): float64, on the CPU.

Golden sources:
  AL cost values:   `test/augmented_lagrangian/auglag_test.cpp:49-93`
  AL full solve:    `auglag_test.cpp:325-351` (14 total / 5 outer iterations)
  AL-cost inner solve: `test/ilqr/unicycle_ilqr_test.cpp:115-144`
  penalty / dual goldens: `test/examples/example_unicycle_test.cpp:30-67`
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import ALSolver as JALSolver
from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.utils.derivative_check import finite_diff_gradient
from altro_tpu_torch import ALSolver, LogLevel, SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import TripleIntegratorProblem, UnicycleProblem
from altro_tpu_torch.problem.constraints import Cone
from altro_tpu_torch.problem.costs import lqr_cost

from _torch_fleet import numpy_tree, one_torch_thread, torch_threads  # noqa: F401

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

F64 = torch.float64
GOLDEN_J = 0.03893465058924039


@pytest.fixture(scope="module")
def uni():
    defn = UnicycleProblem(device="cpu")
    return defn, defn.make_problem(add_constraints=True).compile()


@pytest.fixture(scope="module")
def obstacles():
    defn = UnicycleProblem(scenario="three_obstacles", device="cpu")
    return defn, defn.make_problem(add_constraints=True).compile()


@pytest.fixture(scope="module")
def golden(uni):
    """The full solve at constraint tolerance 1e-6 (`auglag_test.cpp:325-351`)."""
    defn, prob = uni
    solver = ALSolver(prob, SolverOptions(constraint_tolerance=1e-6))
    with torch_threads(1):
        return solver, solver.solve(prob.params, defn.initial_trajectory())


def _knot0(defn, x, u):
    Z = defn.initial_trajectory()
    X, U = Z.X.clone(), Z.U.clone()
    X[0], U[0] = torch.as_tensor(x, dtype=F64), torch.as_tensor(u, dtype=F64)
    return Z.replace(X=X, U=U)


def test_al_cost_value(uni):
    """A violated inequality with zero duals adds ½ρ·violation²
    (`auglag_test.cpp:49-64`)."""
    defn, prob = uni
    solver = ALSolver(prob, SolverOptions())
    rho, v = 1.1, 0.5
    x, u = [0.1, 0.2, np.pi / 3], [defn.v_bnd + v, defn.w_bnd / 2]
    al = solver.fns.set_penalty(solver.init_al_state(), rho)
    costs = solver.fns.cost_terms(prob.params, al, _knot0(defn, x, u))
    stage = lqr_cost(torch.as_tensor(defn.Q), torch.as_tensor(defn.R), torch.as_tensor(defn.xf),
                     torch.as_tensor(defn.uref))
    J = stage(torch.as_tensor(x, dtype=F64), torch.as_tensor(u, dtype=F64))
    np.testing.assert_allclose(float(costs[0]), float(J) + 0.5 * rho * v**2, rtol=1e-12)


def test_al_gradient_matches_fd(uni):
    """The AL expansion's gradient against finite differences, with an
    active inequality and nonzero duals (`auglag_test.cpp:66-93`)."""
    defn, prob = uni
    solver = ALSolver(prob, SolverOptions())
    al = solver.fns.set_penalty(solver.init_al_state(), 1.1)
    al = tuple(s.replace(lam=s.lam - 0.37 * (i + 1)) for i, s in enumerate(al))
    x, u = np.array([0.1, 0.2, np.pi / 3]), np.array([defn.v_bnd + 0.5, defn.w_bnd / 2])
    exp = solver.fns.expand(prob.params, al, _knot0(defn, x, u))
    g_ad = torch.cat([exp.lx[0], exp.lu[0]]).numpy()
    g_fd = finite_diff_gradient(
        lambda z: float(solver.fns.cost_terms(prob.params, al, _knot0(defn, z[:3], z[3:]))[0]),
        np.concatenate([x, u]),
    )
    np.testing.assert_allclose(g_ad, g_fd, atol=1e-5)


def test_three_obstacle_goldens(obstacles):
    """Initial-rollout costs of the three-obstacle scenario: base J =
    133.1151550141444, AL cost at penalty 1 = 141.9639680271223, at
    penalty 10 = 221.6032851439234 (`example_unicycle_test.cpp:18-50`)."""
    defn, prob = obstacles
    solver = ALSolver(prob, SolverOptions())
    Z = solver.ilqr.rollout(prob.params, defn.initial_trajectory())
    bare = UnicycleProblem(scenario="three_obstacles", device="cpu")
    bare.obstacles = None
    prob2 = bare.make_problem(add_constraints=False).compile()
    np.testing.assert_allclose(float(ALSolver(prob2).fns.total_cost(prob2.params, (), Z)), 133.1151550141444,
                               atol=1e-6)
    al1 = solver.init_al_state()
    np.testing.assert_allclose(float(solver.fns.total_cost(prob.params, al1, Z)), 141.9639680271223, atol=1e-6)
    al10 = solver.fns.set_penalty(al1, 10.0)
    np.testing.assert_allclose(float(solver.fns.total_cost(prob.params, al10, Z)), 221.6032851439234, atol=1e-6)


def test_solve_one_step_duals_golden(obstacles):
    """An inner solve at penalty 10, then the dual update: the goal's duals
    are Altro.jl's, negated (`example_unicycle_test.cpp:52-67`)."""
    defn, prob = obstacles
    solver = ALSolver(prob, SolverOptions())
    al = solver.fns.set_penalty(solver.init_al_state(), 10.0)
    res = solver.ilqr.solve(prob.params, al, defn.initial_trajectory())
    al2 = solver.update_duals(prob.params, res.Z, al)
    goal = next(i for i, f in enumerate(prob.constraint_families) if f.cone == Cone.ZERO)
    lamN = np.array([0.43555910438329626, -0.5998598475208317, 0.0044282251970790935])
    np.testing.assert_allclose(al2[goal].lam[0].numpy(), -lamN, atol=1e-6)


def test_alcost_inner_solve_goldens(uni):
    """iLQR on the AL cost at the default penalties: 10 iterations,
    J = 0.03893427133384412 and the bound's violation golden
    (`unicycle_ilqr_test.cpp:115-144`)."""
    defn, prob = uni
    solver = ALSolver(prob, SolverOptions())
    al = solver.init_al_state()
    res = solver.ilqr.solve(prob.params, al, defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    assert res.stats.iterations_inner == 10
    J = float(solver.fns.total_cost(prob.params, al, res.Z))
    U = res.Z.U.numpy()
    viol = max(np.abs(U[:, 0]).max() - defn.v_bnd, np.abs(U[:, 1]).max() - defn.w_bnd)
    assert abs(J - 0.03893427133384412) / 0.03893427133384412 < 1e-6
    assert abs(viol - 0.00017691645708972636) / 0.00017691645708972636 < 1e-6


def test_al_full_solve_goldens(golden):
    """14 total / 5 outer iterations, J = 0.03893465058924039, at
    constraint tolerance 1e-6 (`auglag_test.cpp:325-351`)."""
    solver, res = golden
    assert int(res.status) == SolverStatus.SOLVED
    assert res.stats.iterations_total == 14
    assert res.stats.iterations_outer == 5
    J = float(solver.fns.total_cost(solver.prob.params, res.al, res.Z))
    np.testing.assert_allclose(J, GOLDEN_J, rtol=1e-9, atol=1e-12)
    assert float(res.stats.violations) < solver.opts.constraint_tolerance


def test_al_solve_matches_the_jax_package(golden):
    """The JAX package's solve of the same inputs (its problem's params and
    initial guess through `convert`): the same status and iterations, U
    within 1e-10."""
    defn_j = JUnicycle(dtype=jnp.float64)
    prob_j = defn_j.make_problem(add_constraints=True).compile()
    res_j = JALSolver(prob_j, JOptions(constraint_tolerance=1e-6)).solve(prob_j.params, defn_j.initial_trajectory())
    solver, _ = golden
    params = convert.problem_params(numpy_tree(prob_j.params), "cpu", F64)
    Z0 = convert.instance_trajectory(numpy_tree(defn_j.initial_trajectory()), "cpu", F64)
    res = solver.solve(params, Z0)
    assert int(res.status) == int(res_j.status)
    assert res.stats.iterations_total == int(res_j.stats.iterations_total)
    assert res.stats.iterations_outer == int(res_j.stats.iterations_outer)
    np.testing.assert_allclose(res.Z.U.numpy(), np.asarray(res_j.Z.U), rtol=0, atol=1e-10)
    for st, st_j in zip(res.al, convert.instance_al_state(numpy_tree(res_j.al), "cpu", F64)):
        np.testing.assert_allclose(st.lam.numpy(), st_j.lam.numpy(), rtol=0, atol=1e-8)
        assert torch.equal(st.rho, st_j.rho)


def test_al_solve_twice_is_identical(uni, golden):
    """Solving again from the reset initial trajectory reproduces the stats
    and U (`auglag_test.cpp:353-380`)."""
    defn, prob = uni
    solver, res1 = golden
    res2 = solver.solve(prob.params, defn.initial_trajectory())
    assert (res2.stats.iterations_total, res2.stats.iterations_outer) == (
        res1.stats.iterations_total, res1.stats.iterations_outer)
    assert torch.equal(res1.Z.U, res2.Z.U)


def test_instrumented_solve_equals_the_plain_solve(uni, golden, capsys):
    """`verbose=INNER` with the profiler on: a live row per inner and per
    outer iteration, the status line, the phase profile, and the silent
    solve's result bit for bit."""
    defn, prob = uni
    _, ref = golden
    solver = ALSolver(prob, SolverOptions(constraint_tolerance=1e-6, verbose=LogLevel.INNER,
                                          profiler_enable=True))
    capsys.readouterr()
    res = solver.solve(prob.params, defn.initial_trajectory())
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.strip() and ln.strip()[0].isdigit()]
    assert len(rows) == ref.stats.iterations_total + ref.stats.iterations_outer
    assert "status: SOLVED" in out and "backward_pass" in out
    assert solver.timer.get_us("al/ilqr/backward_pass") > 0
    assert int(res.status) == int(ref.status)
    assert (res.stats.iterations_total, res.stats.iterations_outer) == (
        ref.stats.iterations_total, ref.stats.iterations_outer)
    assert torch.equal(res.Z.U, ref.Z.U) and torch.equal(res.stats.rows, ref.stats.rows)
    # one read more per printed row and for the status line
    assert solver.host_syncs == golden[0].host_syncs + len(rows) + 1


def test_profiled_solve_marks_its_phases_in_a_trace():
    """With `profiler_enable` each phase scope is also a range in a
    torch.profiler trace (`Timer.trace_context`); without it, none."""
    defn = UnicycleProblem(device="cpu", N=10)
    prob = defn.make_problem(add_constraints=True).compile()
    seen = {}
    for on in (True, False):
        solver = ALSolver(prob, SolverOptions(max_iterations_total=1, profiler_enable=on))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            solver.solve(prob.params, defn.initial_trajectory())
        seen[on] = {e.key for e in prof.key_averages()}
    for name in ("al", "ilqr", "expansions", "backward_pass", "forward_pass", "dual_update"):
        assert name in seen[True] and name not in seen[False], name


def test_history_summary_and_violation_report(uni, golden, capsys):
    """The finished solve's history as the reference's table
    (`SolverLogger.print_solve_summary`), and the per-constraint report
    (`al_solver.hpp:68-104, 252-269`)."""
    from altro_tpu_torch.utils.logging import SolverLogger

    defn, prob = uni
    solver, res = golden
    logger = SolverLogger(LogLevel.INNER, color=False)
    logger.set_tolerances(1e-4, 1e-6, 1e-2)
    logger.print_solve_summary(res.stats, res.status)
    out = capsys.readouterr().out.splitlines()
    assert len([ln for ln in out if ln.strip()[:1].isdigit()]) == res.stats.length
    assert out[-1] == "status: SOLVED"
    assert solver.num_constraints() == 4 * prob.N + 3 and solver.num_constraints(prob.N) == 3
    info = solver.constraint_info(prob.params, res.Z, sort=True)
    assert len(info) == prob.N + 1
    assert float(info[0]["violation"].max()) == pytest.approx(float(solver.max_violation(prob.params, res.Z)))
    solver.print_violations(prob.params, res.Z)
    assert capsys.readouterr().out.startswith(f"Got {prob.N + 1} constraints")


def test_triple_integrator_constrained():
    """The goal is reached and the controls saturate at the bound
    (`example_triple_integrator_test.cpp:39-69`)."""
    defn = TripleIntegratorProblem(dof=2, device="cpu")
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions())
    res = solver.solve(prob.params, defn.initial_trajectory())
    assert int(res.status) == SolverStatus.SOLVED
    assert float(res.stats.violations) < solver.opts.constraint_tolerance
    assert np.abs(res.Z.X[-1].numpy() - defn.xf).max() < solver.opts.constraint_tolerance
    np.testing.assert_allclose(res.Z.U[0].numpy(), defn.ubnd, rtol=1e-6)
    np.testing.assert_allclose(res.Z.U[-1].numpy(), defn.ubnd, rtol=1e-6)


# ------------------------------------------------ penalty API (test_penalty_api.py)
def test_get_set_penalty_by_label_and_index(uni):
    _, prob = uni
    fns = ALSolver(prob).fns
    al = fns.al_state_init()
    labels = [f.label for f in prob.constraint_families]
    assert "Control Bound" in labels and "Goal Constraint" in labels
    al2 = fns.set_penalty(al, 25.0, family="Control Bound")
    assert bool((fns.get_penalty(al2, "Control Bound") == 25.0).all())
    assert bool((fns.get_penalty(al2, "Goal Constraint") == 1.0).all())
    assert bool((fns.get_penalty(al2, labels.index("Control Bound")) == 25.0).all())


def test_set_penalty_single_knot(uni):
    _, prob = uni
    fns = ALSolver(prob).fns
    al2 = fns.set_penalty(fns.al_state_init(), 7.0, family="Control Bound", knot=3)
    rho = fns.get_penalty(al2, "Control Bound").numpy()
    assert float(fns.get_penalty(al2, "Control Bound", knot=3)) == 7.0
    assert (rho == 1.0).sum() == rho.size - 1


def test_get_duals_shape_and_knot(uni):
    defn, prob = uni
    fns = ALSolver(prob).fns
    al = fns.al_state_init()
    assert tuple(fns.get_duals(al, "Goal Constraint").shape) == (1, 3)
    assert tuple(fns.get_duals(al, "Goal Constraint", knot=defn.N).shape) == (3,)


def test_penalty_api_errors(uni):
    _, prob = uni
    fns = ALSolver(prob).fns
    al = fns.al_state_init()
    with pytest.raises(KeyError):
        fns.get_penalty(al, "No Such Constraint")
    with pytest.raises(IndexError):
        fns.get_penalty(al, 99)
    with pytest.raises(IndexError):
        fns.get_penalty(al, "Goal Constraint", knot=0)
    with pytest.raises(ValueError):
        fns.set_penalty(al, 1.0, knot=3)


def test_warm_start_with_custom_penalties_solves(uni):
    """A warm AL state with per-family penalties drives the solve
    (`initial_penalty=0` keeps them, `al_solver.hpp:295-297`)."""
    defn, prob = uni
    fns = ALSolver(prob).fns
    al = fns.set_penalty(fns.al_state_init(), 50.0, family="Goal Constraint")
    solver = ALSolver(prob, SolverOptions(initial_penalty=0.0, reset_duals=False))
    res = solver.solve(prob.params, defn.initial_trajectory(), al)
    assert int(res.status) == SolverStatus.SOLVED
    np.testing.assert_allclose(float(res.stats.cost), GOLDEN_J, rtol=1e-3)

"""The port's per-instance iLQR and Riccati backward pass
(`altro_tpu_torch/solver/{ilqr,riccati}.py`) against the reference's goldens,
as `tests/test_ilqr.py` and `tests/test_riccati.py` hold the JAX package:
the same numbers at the same tolerances, float64 on the CPU.

Golden sources:
  triple integrator: `test/ilqr/ilqr_test.cpp:150-334`
  unicycle turn-90:  `test/ilqr/unicycle_ilqr_test.cpp:27-100`
"""
import numpy as np
import pytest
import torch

from altro_tpu_torch import ILQRSolver, SolverOptions, SolverStatus
from altro_tpu_torch.models.problems import TripleIntegratorProblem, UnicycleProblem
from altro_tpu_torch.solver import riccati

from _torch_fleet import one_torch_thread, torch_threads  # noqa: F401

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _setup(name, opts=None):
    if name == "tri":
        defn = TripleIntegratorProblem(dof=2, device="cpu")
        prob = defn.make_problem().compile()
    else:
        defn = UnicycleProblem(device="cpu")
        prob = defn.make_problem(add_constraints=False).compile()
    return defn, prob, ILQRSolver(prob, opts or SolverOptions()), defn.initial_trajectory()


@pytest.fixture(scope="module")
def problems():
    return {name: _setup(name) for name in ("tri", "uni")}


@pytest.fixture(scope="module")
def solves(problems):
    """Each problem's full inner solve with the default options."""
    with torch_threads(1):
        return {name: solver.solve(prob.params, (), Z0) for name, (_, prob, solver, Z0) in problems.items()}


def _first_backward(problems, name):
    defn, prob, solver, Z0 = problems[name]
    Z = solver.rollout(prob.params, Z0)
    exp = solver.expansions(prob.params, (), Z)
    return solver, prob, Z, exp, solver.backward_pass(exp)


# `ilqr_test.cpp:212-216` (zero controls from x0: J = 100 + 1e6) and
# `unicycle_ilqr_test.cpp:36-38`
@pytest.mark.parametrize("name,J,tol", [("tri", 100.0 + 1e6, dict(rtol=1e-12)),
                                        ("uni", 259.27636137767087, dict(atol=1e-5))])
def test_initial_cost(problems, name, J, tol):
    defn, prob, solver, Z0 = problems[name]
    Z = solver.rollout(prob.params, Z0)
    np.testing.assert_allclose(float(solver.fns.total_cost(prob.params, (), Z)), J, **tol)


# `ilqr_test.cpp:196-204` and `unicycle_ilqr_test.cpp:45-53` (Altro.jl values)
BACKWARD_GOLDENS = dict(
    tri=(np.array([-389.04658272629644, -778.0931654525915, -181.40881931288234, -362.81763862576514,
                   -9.704677110465038, -19.409354220930084]), dict(atol=1e-4 * 390),
         np.array([127.9313782698078, 255.862756539616]), dict(rtol=1e-4)),
    uni=(np.array([0.024904637422419617, -0.46496022574032614, -0.0573096310550007]), dict(atol=1e-5),
         np.array([-2.565783457444465, 5.514158930898376]), dict(atol=1e-5 * 5.5)),
)


@pytest.mark.parametrize("name", ["tri", "uni"])
def test_backward_pass_goldens(problems, name):
    *_, bp = _first_backward(problems, name)
    p0, p_tol, d0, d_tol = BACKWARD_GOLDENS[name]
    np.testing.assert_allclose(bp.p[0].numpy(), p0, **p_tol)
    np.testing.assert_allclose(bp.d[0].numpy(), d0, **d_tol)
    assert not bp.failed


def test_forward_pass_goldens(problems):
    """The triple integrator's first step J = 1945.2329136
    (`ilqr_test.cpp:268-269`); the unicycle's line search settles at
    α = 0.0625 (`unicycle_ilqr_test.cpp:56-64`)."""
    for name in ("tri", "uni"):
        solver, prob, Z, exp, bp = _first_backward(problems, name)
        J0 = exp.costs.sum()
        fp = solver.forward_pass(prob.params, (), Z, bp, J0)
        assert bool(fp.success)
        if name == "tri":
            np.testing.assert_allclose(float(fp.J), 1945.2329136, atol=1e-3)
        else:
            assert float(fp.J) < float(J0)
            np.testing.assert_allclose(float(fp.alpha), 0.0625)


def test_unicycle_two_steps_goldens(problems):
    """`unicycle_ilqr_test.cpp:67-88`."""
    defn, prob, solver, Z0 = problems["uni"]
    Z = solver.rollout(prob.params, Z0)
    rho = drho = torch.zeros((), dtype=torch.float64)
    exp = solver.expansions(prob.params, (), Z)
    bp = solver.backward_pass(exp, rho, drho)
    rho, drho = riccati.decrease_regularization(bp.rho, bp.drho, solver.opts)
    Z = solver.forward_pass(prob.params, (), Z, bp, exp.costs.sum()).Z
    exp = solver.expansions(prob.params, (), Z)
    bp = solver.backward_pass(exp, rho, drho)
    np.testing.assert_allclose(
        bp.p[0].numpy(), [-0.0015143873973949232, -0.07854630832127288, -0.017945283678268698], atol=1e-5)
    np.testing.assert_allclose(bp.d[0].numpy(), [0.21887571453613042, 1.3097976615154625], atol=1e-5 * 1.3)
    fp = solver.forward_pass(prob.params, (), Z, bp, exp.costs.sum())
    np.testing.assert_allclose(float(fp.J), 62.773696055304384, atol=1e-5)


def test_triple_integrator_full_solve(solves):
    """Two inner iterations, the feedback gain golden, d ≈ 0
    (`ilqr_test.cpp:291-311`); the normal solve is not a stall exit."""
    res = solves["tri"]
    assert int(res.status) == SolverStatus.SOLVED
    assert res.stats.iterations_inner == 2
    K0 = np.array([[-63.9657, 0.0, -42.7673, 0.0, -11.5189, 0.0],
                   [0.0, -63.9657, 0.0, -42.7673, 0.0, -11.5189]])
    np.testing.assert_allclose(res.K[0].numpy(), K0, rtol=2e-5, atol=1e-3)
    assert float(res.d.abs().max()) < 1e-8


def test_unicycle_full_solve(problems, solves):
    """Nine iterations, J = 0.0387016567 (`unicycle_ilqr_test.cpp:90-100`)."""
    defn, prob, solver, Z0 = problems["uni"]
    res = solves["uni"]
    assert int(res.status) == SolverStatus.SOLVED
    assert res.stats.iterations_inner == 9
    np.testing.assert_allclose(float(solver.fns.total_cost(prob.params, (), res.Z)), 0.0387016567, atol=1e-5)
    assert float(res.stats.gradient) < solver.opts.gradient_tolerance


@pytest.mark.parametrize("max_stall,want", [
    (3, (SolverStatus.SOLVED_STALLED,)),
    (0, (SolverStatus.MAX_INNER_ITERATIONS, SolverStatus.MAX_ITERATIONS)),
])
def test_stall_status(max_stall, want):
    """An unreachable gradient tolerance ends in the stall exit, never
    SOLVED; with the stall exit off, at an iteration cap."""
    opts = SolverOptions(gradient_tolerance=0.0, max_stall_iterations=max_stall,
                         max_iterations_inner=12, max_iterations_total=12)
    defn, prob, solver, Z0 = _setup("tri", opts)
    res = solver.solve(prob.params, (), Z0)
    assert int(res.status) in want


def test_regularization_retry_recovers(problems):
    """A non-PD Quu at one knot increases ρ until the pass succeeds
    (`ilqr.hpp:409-427`)."""
    solver, prob, Z, exp, _ = _first_backward(problems, "uni")
    luu = exp.luu.clone()
    luu[3] = -torch.eye(2, dtype=torch.float64)
    bp = riccati.backward_pass(exp.replace(luu=luu), 0.0, 0.0, solver.opts)
    assert not bp.failed
    assert float(bp.rho) >= 1.0
    assert bool(torch.isfinite(bp.K).all())


def test_regularization_gives_up():
    """With a tiny ceiling and threshold the pass reports
    BACKWARD_PASS_REGULARIZATION_FAILED (`ilqr.hpp:418-426`)."""
    opts = SolverOptions(bp_reg_max=1e-6, bp_reg_fail_threshold=2)
    defn, prob, solver, Z0 = _setup("uni", opts)
    Z = solver.rollout(prob.params, Z0)
    exp = solver.expansions(prob.params, (), Z)
    bad = exp.replace(luu=-torch.eye(2, dtype=torch.float64).expand_as(exp.luu).clone())
    bp = riccati.backward_pass(bad, 0.0, 0.0, opts)
    assert bp.failed
    assert int(bp.status) == SolverStatus.BACKWARD_PASS_REGULARIZATION_FAILED


def test_gain_limit_guard_triggers_retry(problems):
    """A finite but numerically singular Quu passes the Cholesky and gives
    huge gains; the gain-magnitude guard counts it as a failure and the
    retry regularizes (tests/test_riccati.py)."""
    solver, prob, Z, exp, _ = _first_backward(problems, "uni")
    sick = exp.replace(luu=(torch.eye(2, dtype=torch.float64) * 1e-30).expand_as(exp.luu).clone(),
                       B=exp.B * 1e-15)
    z = torch.zeros((), dtype=torch.float64)
    K, d, *_, failed = riccati._riccati_scan(sick, z, gain_limit=float("inf"))
    assert not bool(failed)
    assert max(float(K.abs().max()), float(d.abs().max())) > 1e8
    *_, failed_g = riccati._riccati_scan(sick, z, gain_limit=1e8)
    assert bool(failed_g)
    bp = riccati.backward_pass(sick, z, z, solver.opts)
    assert not bp.failed
    assert float(bp.K.abs().max()) <= solver.opts.bp_gain_limit
    assert float(bp.d.abs().max()) <= solver.opts.bp_gain_limit
    assert float(bp.rho) > 0.0

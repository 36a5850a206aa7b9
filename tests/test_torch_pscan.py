"""The port's associative-scan Riccati sweeps (`altro_tpu_torch/solver/
pscan.py`, `pscan_batched.py`) against the JAX package's, float64 on the
CPU: twins of tests/test_pscan_batched.py and tests/test_pscan_regularized.py
on their seeds and sizes (B=4, N=100).

The sweeps run on expansions that the JAX package builds, carried across
by `convert`, and are held to the JAX functions within 1e-9 at ρ=0 and at
ρ=0.37, the failure masks equal (a poisoned lane included); the port's
sequential sweep is the oracle at ρ=0, the per-instance pscan at ρ>0 (the
module docstrings say why).  The full solves force ρ=1 into the first
backward pass (`bp_reg_initial=1.0`) and must still reach the reference
optima, with at most 2x + 2 the iterations of the port's own sequential
solve under the same regularization.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.solver.functions import Expansions as JExpansions
from altro_tpu.solver.pscan import backward_pass_pscan as jbackward_pass_pscan
from altro_tpu.solver.pscan_batched import inv_unrolled as jinv_unrolled
from altro_tpu.solver.pscan_batched import riccati_pscan_batched as jriccati_pscan_batched
from altro_tpu_torch import ALSolver, ILQRSolver, SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.solver.functions import Expansions
from altro_tpu_torch.solver.pscan import associative_scan, backward_pass_pscan
from altro_tpu_torch.solver.pscan_batched import inv_unrolled, riccati_pscan_batched

from _torch_fleet import F64, numpy_tree, one_torch_thread, torch_threads  # noqa: F401

# the JAX sweeps, compiled once each (eager, their scans dispatch op by op)
jriccati = jax.jit(jriccati_pscan_batched)
jbackward = jax.jit(lambda exp, rho: jbackward_pass_pscan(exp, rho, jnp.zeros(()), JOptions()))

B, N = 4, 100
TOL = 1e-9
J_GOLDEN = 0.0387016567  # unicycle_ilqr_test.cpp:94-96 (unconstrained)
J_GOLDEN_AL = 0.03893465058924039  # auglag_test.cpp:346-349


def _patch_pscan(solver):
    """Route a solver's backward sweep through the pscan entry points, as
    tests/test_pscan_regularized.py:_patch_pscan does in the JAX package."""
    if isinstance(solver, ALSolverBatched):
        solver.riccati_scan = lambda exp, rho: riccati_pscan_batched(exp, rho, gain_limit=solver.opts.bp_gain_limit)
    else:
        def bp(exp, rho=0.0, drho=0.0):
            out = backward_pass_pscan(exp, rho, drho, solver.opts)
            solver.host_syncs += out.attempts
            return out

        solver.backward_pass = bp
    return solver


@pytest.fixture(scope="module")
def fleet():
    """tests/test_pscan_batched.py:_setup (B=4, N=100, x0 uniform in ±0.2
    from seed 0, the constrained turn-90): the JAX package's expansions
    after a rollout under the initial AL state, and the same in the port."""
    defn = JUnicycle()
    defn.N = N
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    x0 = np.random.default_rng(0).uniform(-0.2, 0.2, size=(3, B))
    Zb = to_batch_last(jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape),
                                              defn.initial_trajectory()))
    params = prob_j.params.replace(x0=jnp.asarray(x0))
    sj = JSolver(prob_j, JOptions())
    exp_j = jax.jit(lambda p, Z: sj.expand(p, sj.al_state_init(B, jnp.float64), sj.rollout(p, Z)))(params, Zb)
    tdef = UnicycleProblem(dtype=F64, N=N, device="cpu")
    prob_t = tdef.make_problem().compile()
    Z0 = tdef.initial_trajectory()
    Zt = BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
                           U=Z0.U[..., None].expand(-1, -1, B).contiguous(), t=Z0.t, h=Z0.h)
    return dict(exp_j=exp_j, exp=convert.expansions(numpy_tree(exp_j), "cpu", F64), prob=prob_t,
                params=prob_t.params.replace(x0=torch.as_tensor(x0)), Z=Zt)


def _lane(exp, b, lib):
    """Lane b of batch-last expansions as the per-instance `Expansions` of
    `lib` (torch or jax.numpy)."""
    cls = Expansions if lib is torch else JExpansions
    return cls(costs=exp["costs"][:, b], **{k: exp[k][..., b] for k in ("lx", "lu", "lxx", "lxu", "luu", "A", "B")})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_associative_scan_is_the_sequential_fold(one_torch_thread):
    """`associative_scan` with the combine of 2x2 matrix products (not
    commutative) equals the sequential prefix products M0…Mk and, with
    `reverse`, the suffix products Mk…M(n-1) at every length up to 9, so
    the odd/even recursion and its argument order hold."""
    rng = np.random.default_rng(3)
    for n in range(1, 10):
        M = torch.as_tensor(rng.standard_normal((n, 2, 2)))
        pre = associative_scan(lambda a, b: (a[0] @ b[0],), (M,))[0]
        suf = associative_scan(lambda a, b: (b[0] @ a[0],), (M,), reverse=True)[0]
        acc, want_pre = torch.eye(2, dtype=F64), []
        for k in range(n):
            acc = acc @ M[k]
            want_pre.append(acc)
        acc, want_suf = torch.eye(2, dtype=F64), []
        for k in reversed(range(n)):
            acc = M[k] @ acc
            want_suf.insert(0, acc)
        _close(pre, torch.stack(want_pre), 1e-12)
        _close(suf, torch.stack(want_suf), 1e-12)


def test_inv_unrolled_matches_linalg(one_torch_thread):
    """tests/test_pscan_batched.py:test_inv_unrolled_matches_linalg's
    matrices (I + A Aᵀ, n = 2, 3, 7): the port's inverse against the JAX
    function's within 1e-9, and M·M⁻¹ = I within 1e-10."""
    rng = np.random.default_rng(1)
    for n in (2, 3, 7):
        A = rng.standard_normal((5, n, n, 8))
        M = np.einsum("kijb,kjlb->kilb", A, np.swapaxes(A, 1, 2)) + np.eye(n)[None, :, :, None]
        Minv = inv_unrolled(torch.as_tensor(M)).numpy()
        _close(Minv, jinv_unrolled(jnp.asarray(M)))
        prod = np.einsum("kijb,kjlb->kilb", M, Minv)
        np.testing.assert_allclose(prod, np.broadcast_to(np.eye(n)[None, :, :, None], prod.shape), atol=1e-10)


def test_pscan_sweep_matches_sequential_at_zero_reg(fleet, one_torch_thread):
    """At ρ=0 the port's batched pscan equals the port's sequential sweep
    and the JAX package's batched pscan on the same expansions."""
    exp = fleet["exp"]
    rho = torch.zeros(B, dtype=F64)
    got = riccati_pscan_batched(exp, rho)
    seq = ALSolverBatched(fleet["prob"], SolverOptions()).riccati_scan(exp, rho)
    ref = jriccati(fleet["exp_j"], jnp.zeros((B,)))
    for g, s, r in zip(got[:4], seq[:4], ref[:4]):
        _close(g, s)
        _close(g, r)
    assert not got[4].any()
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(seq[4]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("rho", [0.0, 0.37])
def test_pscan_sweep_matches_per_instance_pscan(fleet, rho, one_torch_thread):
    """tests/test_pscan_batched.py:test_pscan_sweep_matches_per_instance_pscan_regularized
    and its ρ=0 case: the batched pscan against the JAX batched pscan and
    against the port's per-instance `backward_pass_pscan` lane by lane
    (dV1 within 1e-8, as there), and that against the JAX per-instance
    function: K, d, P, p, ΔV, ρ and the status."""
    exp, exp_j = fleet["exp"], fleet["exp_j"]
    got = riccati_pscan_batched(exp, torch.full((B,), rho, dtype=F64))
    ref = jriccati(exp_j, jnp.full((B,), rho))
    for g, r in zip(got[:4], ref[:4]):
        _close(g, r)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    opts = SolverOptions()
    for b in range(B):
        bp = backward_pass_pscan(_lane(exp, b, torch), rho, 0.0, opts)
        bj = jbackward(_lane(exp_j, b, jnp), jnp.asarray(rho))
        assert not bp.failed and bp.attempts == 1 and int(bp.status) == int(bj.status)
        _close(got[0][..., b], bp.K)
        _close(got[1][..., b], bp.d)
        _close(got[2][b], bp.dV1, 1e-8)
        _close(got[3][b], bp.dV2)
        for key in ("K", "d", "P", "p", "dV1", "dV2", "rho", "drho"):
            _close(getattr(bp, key), getattr(bj, key))


def test_pscan_option_retired():
    """`backward_pass="pscan"` stays refused, and the message names the two
    entry points, as the JAX package's does."""
    with pytest.raises(ValueError, match="retired") as err:
        SolverOptions(backward_pass="pscan")
    assert "pscan.backward_pass_pscan" in str(err.value)
    assert "pscan_batched.riccati_pscan_batched" in str(err.value)


def test_pscan_full_solve_matches_scan(fleet):
    """The batched solver routed through the pscan sweep follows the
    sequential sweep's iteration path: statuses (all SOLVED) and total
    iterations equal, U within 1e-6."""
    prob, params, Z = fleet["prob"], fleet["params"], fleet["Z"]
    with torch_threads(1):
        r1 = ALSolverBatched(prob, SolverOptions(backward_pass="scan")).solve(params, Z)
        r2 = _patch_pscan(ALSolverBatched(prob, SolverOptions(backward_pass="scan"))).solve(params, Z)
    assert torch.equal(r1["status"], r2["status"])
    assert (r1["status"] == int(SolverStatus.SOLVED)).all()
    assert torch.equal(r1["stats"].iterations_total, r2["stats"].iterations_total)
    _close(r1["Z"].U, r2["Z"].U, 1e-6)


def test_pscan_cholesky_failure_mask(fleet, one_torch_thread):
    """luu of lane 1 negative definite at knot 3: at ρ=0 exactly that lane
    fails, as in the JAX function, and the retry loop around the pscan
    sweep recovers it with a larger ρ; the per-instance pass on that lane
    retries to the JAX pass's ρ and gains."""
    exp, exp_j = fleet["exp"], fleet["exp_j"]
    bad = dict(exp, luu=exp["luu"].clone())
    bad["luu"][3, :, :, 1] = -torch.eye(2, dtype=F64)
    bad_j = dict(exp_j, luu=exp_j["luu"].at[3, :, :, 1].set(-jnp.eye(2)))
    rho = torch.zeros(B, dtype=F64)
    failed = riccati_pscan_batched(bad, rho)[4].numpy()
    np.testing.assert_array_equal(failed, [False, True, False, False])
    np.testing.assert_array_equal(failed, np.asarray(jriccati(bad_j, jnp.zeros((B,)))[4]))
    out = _patch_pscan(ALSolverBatched(fleet["prob"], SolverOptions(backward_pass="scan"))).backward_pass(
        bad, rho, torch.zeros(B, dtype=F64))
    assert not out["failed"].any()
    assert float(out["rho"][1]) > 0.0
    # the per-instance pass on that lane retries as the JAX one does
    bp = backward_pass_pscan(_lane(bad, 1, torch), 0.0, 0.0, SolverOptions())
    bj = jbackward(_lane(bad_j, 1, jnp), jnp.asarray(0.0))
    assert bp.attempts > 1 and not bp.failed and not bool(bj.failed)
    for key in ("K", "d", "P", "p", "dV1", "dV2", "rho", "drho"):
        _close(getattr(bp, key), getattr(bj, key))


# -------------------------------------------------- forced regularization


def _opts(**kw):
    # ρ=1 in the first backward pass; the schedule then decays it
    # (`ilqr.hpp:770-786`), so the early iterations are damped
    return SolverOptions(backward_pass="scan", bp_reg_initial=1.0, **kw)


@pytest.fixture(scope="module")
def parking():
    defn = UnicycleProblem(dtype=F64, N=N, device="cpu")
    return defn, defn.make_problem(add_constraints=False).compile()


@pytest.fixture(scope="module")
def scan_reg_solve(parking):
    defn, prob = parking
    with torch_threads(1):
        return ILQRSolver(prob, _opts()).solve(prob.params, (), defn.initial_trajectory())


def test_scan_solves_golden_under_forced_reg(scan_reg_solve):
    """The sequential sweep under ρ=1 at the start reaches J = 0.0387016567
    (rtol 1e-6)."""
    assert int(scan_reg_solve.status) == int(SolverStatus.SOLVED)
    np.testing.assert_allclose(float(scan_reg_solve.stats.cost), J_GOLDEN, rtol=1e-6)


def test_pscan_per_instance_solves_golden_under_forced_reg(parking, scan_reg_solve, one_torch_thread):
    """The per-instance pscan at ρ>0 takes another damped step than the
    sequential sweep by construction, and reaches the same optimum with at
    most 2x + 2 its iterations."""
    defn, prob = parking
    res = _patch_pscan(ILQRSolver(prob, _opts())).solve(prob.params, (), defn.initial_trajectory())
    assert int(res.status) == int(SolverStatus.SOLVED)
    np.testing.assert_allclose(float(res.stats.cost), J_GOLDEN, rtol=1e-6)
    it_scan, it = int(scan_reg_solve.stats.iterations_total), int(res.stats.iterations_total)
    assert it <= 2 * it_scan + 2, (it, it_scan)


def test_pscan_batched_solves_golden_under_forced_reg(parking, scan_reg_solve, one_torch_thread):
    """The batch-last pscan, B=4, the same golden and bound."""
    defn, prob = parking
    Z0 = defn.initial_trajectory()
    Zb = BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
                           U=Z0.U[..., None].expand(-1, -1, B).contiguous(), t=Z0.t, h=Z0.h)
    res = _patch_pscan(ALSolverBatched(prob, _opts())).solve(prob.params, Zb)
    assert (res["status"] == int(SolverStatus.SOLVED)).all()
    np.testing.assert_allclose(res["stats"].cost.numpy(), J_GOLDEN, rtol=1e-6)
    it_scan, it = int(scan_reg_solve.stats.iterations_total), int(res["stats"].iterations_total.max())
    assert it <= 2 * it_scan + 2, (it, it_scan)


def test_pscan_constrained_al_solve_under_forced_reg(one_torch_thread):
    """The constrained AL solve (goal and control bounds) with the
    per-instance pscan under forced ρ: the trajectory's raw cost at the
    reference AL golden J = 0.03893465058924039 (rtol 1e-6), violation
    below 1e-6."""
    defn = UnicycleProblem(dtype=F64, N=N, device="cpu")
    prob = defn.make_problem(add_constraints=True).compile()
    solver = ALSolver(prob, SolverOptions(bp_reg_initial=1.0, constraint_tolerance=1e-6))
    _patch_pscan(solver.ilqr)
    res = solver.solve(prob.params, defn.initial_trajectory())
    assert int(res.status) == int(SolverStatus.SOLVED)
    # the damped path takes more outer iterations, so the logged AL cost
    # carries larger dual terms: compare the trajectory's own cost
    J_raw = float(solver.fns.total_cost(prob.params, solver.fns.al_state_init(F64, "cpu"), res.Z))
    np.testing.assert_allclose(J_raw, J_GOLDEN_AL, rtol=1e-6)
    assert float(res.stats.violations) < 1e-6

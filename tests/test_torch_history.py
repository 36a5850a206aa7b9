"""The batched solver's iteration history (`BatchedStats.rows`) in the port
against the JAX package's, float64 on the CPU, on the fleet of
tests/test_stats_history.py (parking, N=30): `ALSolverBatched` with a
capacity above and below the longest lane, the compaction splice of the
tail rounds with rows dropped past the capacity, and history on or off
changing no decision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import _HISTORY_COLUMNS as J_COLUMNS
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.solver.compaction import CompactedALSolver as JCompacted
from altro_tpu_torch import SolverOptions, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.solver.batched import _HISTORY_COLUMNS, ALSolverBatched, batched_stats_column
from altro_tpu_torch.solver.compaction import CompactedALSolver

from _torch_fleet import F64, numpy_tree


def _fleet(B, N=30, seed=0, spread=0.3):
    """tests/test_stats_history.py:_fleet in both packages."""
    defn = JUnicycle()
    defn.N = N
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    x0 = jnp.asarray(np.random.default_rng(seed).uniform(-spread, spread, (3, B)))
    params_j = prob_j.params.replace(x0=x0)
    Z_j = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape),
                                               defn.initial_trajectory()))
    prob_t = UnicycleProblem(N=N, dtype=F64, device="cpu").make_problem().compile()
    return (prob_j, params_j, Z_j, prob_t, convert.problem_params(numpy_tree(params_j), "cpu", F64),
            convert.trajectory(numpy_tree(Z_j), "cpu", F64))


def _assert_rows_match(rows, ref_rows, totals):
    """Rows within 1e-10 relative up to each lane's iteration count, and
    zero past it.  Each column is held to 1e-10 of its largest magnitude
    over the lane's rows, except the improvement ratio z: it is the actual
    over the expected cost decrease, both cancellations of costs up to 1e7
    times larger, so its bound is 1e-10 relative to the costs it was
    computed from, 2e-10·max|cost|·max(|z|, 1)/|cost decrease| (the two
    packages' rounding moves it by up to 1.8e-6 on this fleet)."""
    cap = rows.shape[0]
    assert rows.shape == ref_rows.shape
    col = {name: i for i, name in enumerate(_HISTORY_COLUMNS)}
    for b, T in enumerate(totals):
        T = min(int(T), cap)
        got, want = rows[:T, :, b], ref_rows[:T, :, b]
        bound = np.broadcast_to(1e-10 * np.abs(want).max(axis=0), want.shape).copy()
        z, dj = want[:, col["improvement_ratio"]], np.abs(want[:, col["cost_decrease"]])
        bound[:, col["improvement_ratio"]] = np.where(
            dj > 0, 2e-10 * np.abs(want[:, col["cost"]]).max() * np.maximum(np.abs(z), 1.0) / np.maximum(dj, 1e-300),
            np.inf)
        assert (np.abs(got - want) <= bound).all(), (b, np.abs(got - want).max(axis=0))
        assert (rows[T:, :, b] == 0).all() and (ref_rows[T:, :, b] == 0).all()


@pytest.mark.parametrize("capacity", [304, 10])
def test_history_rows_match_jax(capacity):
    """`ALSolverBatched(iteration_history_capacity=K)`: rows equal the JAX
    package's; at K=10, below the longest lane, the last row holds each
    longer lane's last iteration as in the JAX package."""
    B = 4
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = _fleet(B)
    assert _HISTORY_COLUMNS == J_COLUMNS
    ref = numpy_tree(jax.jit(JSolver(prob_j, JOptions(iteration_history_capacity=capacity)).solve)(params_j, Z_j))
    res = ALSolverBatched(prob_t, SolverOptions(iteration_history_capacity=capacity)).solve(params_t, Z_t)
    totals = res["stats"].iterations_total.numpy()
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(totals, ref["stats"].iterations_total)
    if capacity < 304:
        assert totals.max() > capacity
    _assert_rows_match(res["stats"].rows.numpy(), ref["stats"].rows, totals)
    cost = batched_stats_column(res["stats"], "cost").numpy()
    assert cost.shape == (capacity, B)
    for b, T in enumerate(totals):
        if T <= capacity:
            np.testing.assert_allclose(cost[T - 1, b], res["stats"].cost[b].item(), rtol=1e-12)


def test_history_through_the_compaction_splice_matches_jax():
    """tests/test_stats_history.py's splice case (B=16, phase 1 capped at
    6, tail width 5) with capacity 9, below the longest lanes, against the
    JAX compacted solver's device tail: the tail rounds' rows land after
    each straggler's phase-1 rows and rows past the capacity drop."""
    B, K = 16, 9
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = _fleet(B, spread=0.4)
    kw = dict(phase1_iters=6, tail_batch=5)
    ref = numpy_tree(JCompacted(prob_j, JOptions(iteration_history_capacity=K), device_tail=True, **kw)
                     .solve(params_j, Z_j))
    comp = CompactedALSolver(prob_t, SolverOptions(iteration_history_capacity=K), device_tail=True, **kw)
    res = comp.solve(params_t, Z_t)
    totals = res["stats"].iterations_total.numpy()
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(totals, ref["stats"].iterations_total)
    assert totals.max() > K and comp.telemetry["tail_rounds"] >= 2
    _assert_rows_match(res["stats"].rows.numpy(), ref["stats"].rows, totals)


def test_history_changes_no_decision():
    """History on or off: statuses, iterations and U bit for bit, in the
    batched solver and through the compaction splice; capacity 0 gives
    rows of shape [0, 8, B] and adds no host synchronisation."""
    B = 16
    _, _, _, prob_t, params_t, Z_t = _fleet(B, spread=0.4)
    for make in (lambda o: ALSolverBatched(prob_t, o),
                 lambda o: CompactedALSolver(prob_t, o, phase1_iters=6, tail_batch=5, device_tail=True)):
        off, on = make(SolverOptions()), make(SolverOptions(iteration_history_capacity=8))
        r0, r1 = off.solve(params_t, Z_t), on.solve(params_t, Z_t)
        assert tuple(r0["stats"].rows.shape) == (0, 8, B)
        assert tuple(r1["stats"].rows.shape) == (8, 8, B)
        assert torch.equal(r0["status"], r1["status"])
        assert torch.equal(r0["stats"].iterations_total, r1["stats"].iterations_total)
        assert torch.equal(r0["Z"].U, r1["Z"].U) and torch.equal(r0["Z"].X, r1["Z"].X)
        assert off.host_syncs == on.host_syncs

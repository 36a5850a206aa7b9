"""`CompactedALSolver`'s tail options against the JAX package's, float64
on the CPU: the host-driven tail rounds (`device_tail=False`, the default)
uncapped and capped (`tail_iters`, `max_tail_rounds`), the device program
with its rounds capped (`device_tail_rounds`), and the three option
combinations both packages refuse.

The fleet is tests/test_torch_slice.py's (B=16, N=30, x0 in ±0.4, lane 0
canonical, phase 1 capped at 5 iterations, tail chunks of 8), on the scan
passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.solver.compaction import CompactedALSolver as JCompacted
from altro_tpu_torch import SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.solver.compaction import _RESUMABLE, CompactedALSolver

from _torch_fleet import alongside, numpy_tree, torch_threads

F64 = torch.float64
B, N = 16, 30
KW = dict(phase1_iters=5, tail_batch=8)
CONFIGS = dict(
    host=dict(device_tail=False, tail_iters=0),
    host_capped=dict(tail_iters=3, max_tail_rounds=2),
    device_capped=dict(device_tail=True, device_tail_rounds=1),
)


@pytest.fixture(scope="module")
def fleet():
    defn = JUnicycle()
    defn.N = N
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    x0 = np.random.default_rng(0).uniform(-0.4, 0.4, size=(3, B))
    x0[:, 0] = 0.0
    params_j = prob_j.params.replace(x0=jnp.asarray(x0))
    Z_j = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape),
                                               defn.initial_trajectory()))
    prob_t = UnicycleProblem(dtype=F64, N=N, device="cpu").make_problem().compile()
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    Z_t = convert.trajectory(numpy_tree(Z_j), "cpu", F64)
    return prob_j, params_j, Z_j, prob_t, params_t, Z_t


def _solve_port(fleet, **kw):
    _, _, _, prob_t, params_t, Z_t = fleet
    comp = CompactedALSolver(prob_t, SolverOptions(), **KW, **kw)
    with torch_threads(1):
        res = comp.solve(params_t, Z_t)
    return comp, res


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_tail_options_match_jax(fleet, config):
    """Lane by lane the JAX package's status, total and outer iterations,
    U within 1e-9, and the same tail rounds: on the host path the same
    stragglers in each round; `tail_iters=3` re-enters capped lanes for a
    second round; one device round leaves stragglers in both packages."""
    prob_j, params_j, Z_j = fleet[:3]
    jcomp = JCompacted(prob_j, JOptions(), **KW, **CONFIGS[config])
    ref, (comp, res) = alongside(lambda: _solve_port(fleet, **CONFIGS[config]),
                                 lambda: numpy_tree(jcomp.solve(params_j, Z_j)))
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_array_equal(res["stats"].iterations_outer.numpy(), ref["stats"].iterations_outer)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=0, atol=1e-9)
    tel, jtel = comp.telemetry, jcomp.telemetry
    if config == "device_capped":
        assert tel["tail_rounds"] == 1 and jtel["tail_rounds"] == "device"
        left = np.isin(ref["status"], [int(s) for s in _RESUMABLE] + [int(SolverStatus.SOLVED_STALLED)])
        assert left.any(), "one round left no straggler: the cap is not exercised"
    else:
        assert [r["stragglers"] for r in tel["tail_rounds"]] == [r["stragglers"] for r in jtel["tail_rounds"]]
        assert tel["phase1_s"] > 0 and all(r["wall_s"] > 0 for r in tel["tail_rounds"])
        assert len(tel["tail_rounds"]) == (2 if config == "host_capped" else 1)
    assert comp.host_syncs > 0


def test_host_tail_is_the_device_program_lane_for_lane(fleet):
    """With tail_iters=0 every unconverged lane gets one uncapped tail solve
    from its phase-1 state on both paths: statuses, iterations and U bit
    for bit, though the host path solves chunks of only the unconverged
    lanes and the device program masks full-width rounds."""
    _, host = _solve_port(fleet)
    comp, dev = _solve_port(fleet, device_tail=True)
    assert comp.telemetry["tail_rounds"] == 2
    assert torch.equal(host["status"], dev["status"])
    assert torch.equal(host["stats"].iterations_total, dev["stats"].iterations_total)
    assert torch.equal(host["stats"].iterations_outer, dev["stats"].iterations_outer)
    assert torch.equal(host["Z"].U, dev["Z"].U)


@pytest.mark.parametrize("kw, message", [
    (dict(restart_portfolio=({"penalty_scaling": 4.0},)), "restart_portfolio requires device_tail=True"),
    (dict(detect_infeasible=True), "detect_infeasible requires device_tail=True"),
])
def test_device_only_options_refused_without_device_tail(fleet, kw, message):
    """The JAX package's two constructor errors, under the same conditions."""
    prob_j, prob_t = fleet[0], fleet[3]
    for cls, opts in ((JCompacted, JOptions()), (CompactedALSolver, SolverOptions())):
        with pytest.raises(ValueError, match=message):
            cls(prob_j if cls is JCompacted else prob_t, opts, **kw)
        cls(prob_j if cls is JCompacted else prob_t, opts, device_tail=True, **kw)


def test_capped_device_tail_refused(fleet):
    """The device program takes uncapped tail rounds only: `solve` raises
    for tail_iters > 0, in both packages."""
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = fleet
    for solver, args in ((JCompacted(prob_j, JOptions(), device_tail=True, tail_iters=3), (params_j, Z_j)),
                         (CompactedALSolver(prob_t, SolverOptions(), device_tail=True, tail_iters=3),
                          (params_t, Z_t))):
        with pytest.raises(ValueError, match="device_tail supports uncapped tail rounds only"):
            solver.solve(*args)

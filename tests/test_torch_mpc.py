"""The port's receding-horizon controllers (`altro_tpu_torch/solver/mpc.py`):
`MPC` on the per-instance solver and `BatchedMPC` on the batched one,
against the JAX package's controllers on the same inputs, float64 on the
CPU (as `tests/test_batched_mpc.py` holds the JAX package's fleet to its
per-instance controller), and `rollout_ticks` against a loop of `step`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import MPC as JMPC
from altro_tpu import BatchedMPC as JBatchedMPC
from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import to_batch_last as j_to_batch_last
from altro_tpu_torch import MPC, BatchedMPC, SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.models.unicycle import unicycle_rk4
from altro_tpu_torch.solver.batched import BatchedTrajectory

from _torch_fleet import numpy_tree, one_torch_thread  # noqa: F401

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 4
F64 = torch.float64


def _fleet_Z(defn, Bsz):
    Z0 = defn.initial_trajectory()
    return BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, Bsz).contiguous(),
                             U=Z0.U[..., None].expand(-1, -1, Bsz).contiguous(), t=Z0.t, h=Z0.h)


def _port():
    defn = UnicycleProblem(device="cpu")
    return defn, defn.make_problem().compile()


def test_controllers_match_the_jax_package():
    """Three ticks from x0 = 0 (`tests/test_batched_mpc.py:65-78`): each
    tick's u0 of the fleet (B=4) and of the single controller within 1e-10
    of the JAX package's, the same statuses and iterations, and the final
    warm states equal.  The problem's params, both initial guesses and the
    final states are the JAX package's, handed over by `convert`."""
    defn_j = JUnicycle(dtype=jnp.float64)
    prob_j = defn_j.make_problem(add_constraints=True).compile()
    Z0_j = defn_j.initial_trajectory()
    Zb_j = j_to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0_j))
    fleet_j, single_j = JBatchedMPC(prob_j, JOptions()), JMPC(prob_j, JOptions())
    sf_j, ss_j = fleet_j.init(Zb_j), single_j.init(Z0_j)

    _, prob = _port()
    params = convert.problem_params(numpy_tree(prob_j.params), "cpu", F64)
    fleet, single = BatchedMPC(prob, SolverOptions()), MPC(prob, SolverOptions())
    assert not fleet.opts.reset_duals and not single.opts.reset_duals
    sf = fleet.init(convert.trajectory(numpy_tree(Zb_j), "cpu", F64))
    ss = single.init(convert.instance_trajectory(numpy_tree(Z0_j), "cpu", F64))
    for _ in range(3):
        uB_j, sf_j = fleet_j.step(sf_j, jnp.zeros((3, B), jnp.float64))
        u1_j, ss_j = single_j.step(ss_j, jnp.zeros(3, jnp.float64))
        uB, sf = fleet.step(sf, torch.zeros((3, B), dtype=F64), params)
        u1, ss = single.step(ss, torch.zeros(3, dtype=F64), params)
        np.testing.assert_allclose(uB.numpy(), np.asarray(uB_j), rtol=0, atol=1e-10)
        np.testing.assert_allclose(u1.numpy(), np.asarray(u1_j), rtol=0, atol=1e-10)
        np.testing.assert_array_equal(sf.status.numpy(), np.asarray(sf_j.status))
        np.testing.assert_array_equal(sf.iterations.numpy(), np.asarray(sf_j.iterations))
        assert (int(ss.status), ss.iterations) == (int(ss_j.status), int(ss_j.iterations))
        assert fleet.host_syncs > 0 and single.host_syncs > 0
    for got, want in ((sf, convert.mpc_state(numpy_tree(sf_j), "cpu", F64)),
                      (ss, convert.mpc_state(numpy_tree(ss_j), "cpu", F64))):
        np.testing.assert_allclose(got.Z.U.numpy(), want.Z.U.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.Z.X.numpy(), want.Z.X.numpy(), rtol=0, atol=1e-10)
        assert torch.equal(torch.as_tensor(got.iterations), torch.as_tensor(want.iterations))
        assert torch.equal(got.status, want.status)
        for st, st_j in zip(got.al, want.al):
            lam, lam_j = (st["lam"], st_j["lam"]) if isinstance(st, dict) else (st.lam, st_j.lam)
            np.testing.assert_allclose(lam.numpy(), lam_j.numpy(), rtol=0, atol=1e-8)


def test_warm_start_cuts_iterations():
    """A warm re-solve of the same horizon takes fewer iterations than the
    cold one, and stays SOLVED (`tests/test_batched_mpc.py:50-62`)."""
    defn, prob = _port()
    mpc = BatchedMPC(prob, SolverOptions(), shift=False)
    x0 = torch.zeros((3, B), dtype=F64)
    _, s1 = mpc.step(mpc.init(_fleet_Z(defn, B)), x0)
    _, s2 = mpc.step(s1, x0)
    assert bool((s2.iterations < s1.iterations).all())
    assert bool((s2.status == int(SolverStatus.SOLVED)).all())


def test_rollout_ticks_equals_a_loop_of_steps():
    """`rollout_ticks` from a warm state equals `step` plus the plant, tick
    for tick, bit for bit (the perf/mpc_device_latency.py configuration:
    at most 3 iterations a tick), and counts the ticks' host syncs."""
    defn, prob = _port()
    opts = SolverOptions(max_iterations_total=3, max_iterations_inner=3)
    mpc = BatchedMPC(prob, opts)
    model = unicycle_rk4()
    plant = lambda x, u: model(x, u, 0.0, defn.h)  # noqa: E731
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.1, 0.1, (3, B)))
    _, warm = mpc.step(mpc.init(_fleet_Z(defn, B)), x0)
    st, x, X, U = mpc.rollout_ticks(warm, x0, plant, 3)
    assert tuple(X.shape) == (3, 3, B) and tuple(U.shape) == (3, 2, B)
    syncs = mpc.host_syncs
    s, xs, total = warm, x0, 0
    for k in range(3):
        u, s = mpc.step(s, xs)
        total += mpc.host_syncs
        xs = plant(xs, u)
        assert torch.equal(u, U[k]) and torch.equal(xs, X[k])
    assert torch.equal(x, xs) and torch.equal(st.status, s.status) and torch.equal(st.Z.U, s.Z.U)
    assert all(torch.equal(a["lam"], b["lam"]) and torch.equal(a["rho"], b["rho"]) for a, b in zip(st.al, s.al))
    assert syncs == total > 0

"""tests/test_f64_polish.py on the port: the compacted solver's float64
polish finishing the float32 residue of the 48-lane three-obstacle fleet
(N=100, scan passes, on the CPU).  tests/test_torch_polish.py holds the
polish against the JAX package's.
"""
import numpy as np
import torch

from altro_tpu_torch import SolverOptions, SolverStatus
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.solver.batched import BatchedTrajectory
from altro_tpu_torch.solver.compaction import CompactedALSolver


def test_polish_finishes_the_f32_residue():
    """The 48-lane three-obstacle
    fleet in float32 (N=100, scan passes), polished in chunks of 16.  Every
    hard failure is gone; only SOLVED or SOLVED_STALLED remains, the
    stalled lanes feasible to 1e-4; every lane clears every obstacle by
    1 mm; lanes SOLVED before the polish keep their status and U bit for
    bit.  The state before the polish is read where the solver hands it to
    the polish."""
    B = 48
    defn = UnicycleProblem(scenario="three_obstacles", dtype=torch.float32, device="cpu")
    prob = defn.make_problem().compile()
    x0 = np.random.default_rng(0).uniform(-0.1, 0.1, (3, 256))[:, :B]
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=torch.as_tensor(x0, dtype=torch.float32))
    Z0 = defn.initial_trajectory()
    Zb = BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
                           U=Z0.U[..., None].expand(-1, -1, B).contiguous(), t=Z0.t, h=Z0.h)
    opts = SolverOptions(initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10)
    pol = CompactedALSolver(prob, opts, phase1_iters=14, tail_batch=B, f64_polish=True, polish_batch=16,
                           device_tail=True)
    before = []
    run_polish = pol._run_polish

    def spy(solver, params_, Z0_, res_, lanes):
        before.append(res_)
        return run_polish(solver, params_, Z0_, res_, lanes)

    pol._run_polish = spy
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small eager ops: one thread is faster, and the test workers share the cores
    try:
        res = pol.solve(params, Zb)
    finally:
        torch.set_num_threads(threads)
    assert before, "fixture no longer produces f32 failures"
    st0 = before[0]["status"].numpy()
    st = res["status"].numpy()
    solved, stalled = int(SolverStatus.SOLVED), int(SolverStatus.SOLVED_STALLED)
    assert pol.telemetry["polish"]["instances"] == int((st0 != solved).sum()) > 0
    assert np.isin(st, [solved, stalled]).all(), st
    assert (st == solved).sum() > (st0 == solved).sum()
    if (st == stalled).any():
        assert res["stats"].violations.numpy()[st == stalled].max() < 1e-4
    X = res["Z"].X.double().numpy()
    cx, cy, r = defn.obstacles
    d = np.sqrt((X[:, 0, None, :] - cx[None, :, None]) ** 2 + (X[:, 1, None, :] - cy[None, :, None]) ** 2) \
        - r[None, :, None]
    assert d.min() >= -1e-3
    ok0 = torch.as_tensor(st0 == solved)
    np.testing.assert_array_equal(st[ok0.numpy()], st0[ok0.numpy()])
    assert torch.equal(res["Z"].U[..., ok0], before[0]["Z"].U[..., ok0])

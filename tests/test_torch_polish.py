"""The compacted solver's float64 polish in the port against the JAX
package's, on the CPU (scan passes): a float64 obstacle fleet whose caps
leave a residue, with and without the restart cascade before the polish
(polish lanes and stages, statuses, iterations, U).
tests/test_torch_polish_f32.py holds its behaviour on the float32 fleet of
tests/test_f64_polish.py; tests/test_torch_gpu.py holds the polish on the
fused kernels' float64 instantiations against this one on the card.
"""
import numpy as np
import pytest

from altro_tpu import SolverOptions as JOptions
from altro_tpu.solver.compaction import CompactedALSolver as JCompacted
from altro_tpu_torch import SolverOptions
from altro_tpu_torch.solver.compaction import CompactedALSolver

from _torch_fleet import numpy_tree
from test_torch_obstacles import _obstacle_fleet

SCAN = dict(backward_pass="scan", forward_pass="scan")
# a cascade whose caps leave lanes for the polish
SHORT_CASCADE = dict(restart_portfolio=(dict(), dict(penalty_scaling=4.0, max_iterations_total=40)),
                     restart_width=8)


@pytest.mark.parametrize("cascade", [False, True])
def test_polish_matches_jax(cascade):
    """A float64 obstacle fleet (N=20, B=16) whose total cap of 20 leaves
    a residue for both polish stages, polished in chunks of 3 lanes (the
    last one short): the same polish lanes per stage as the JAX package's
    (device tail), equal statuses and iterations, U within 1e-8."""
    B = 16
    prob_j, params_j, Z_j, prob_t, params_t, Z_t = _obstacle_fleet(20, B, seed=1, spread=0.3)
    opts = dict(initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10,
                max_iterations_total=20, **SCAN)
    kw = dict(phase1_iters=8, tail_batch=8, f64_polish=True, polish_batch=3, **(SHORT_CASCADE if cascade else {}))
    jsolver = JCompacted(prob_j, JOptions(**opts), device_tail=True, **kw)
    ref = numpy_tree(jsolver.solve(params_j, Z_j))
    comp = CompactedALSolver(prob_t, SolverOptions(**opts), device_tail=True, **kw)
    res = comp.solve(params_t, Z_t)
    want, got = jsolver.telemetry["polish"], comp.telemetry["polish"]
    assert got["instances"] == want["instances"] > 3
    assert [(s["stage"], s["instances"]) for s in got["stages"]] == [
        (s["stage"], s["instances"]) for s in want["stages"]]
    assert got["solved_after"] == want["solved_after"]
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_array_equal(res["stats"].iterations_outer.numpy(), ref["stats"].iterations_outer)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=0, atol=1e-8)
    if cascade:
        assert comp.telemetry["restart_lanes"]

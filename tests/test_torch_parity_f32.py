"""The float32 parity solve in both packages on the CPU.

`bench.parity_solve`'s configuration: the turn-90 parking problem in
float32, canonical x0 = 0 replicated to B=4, constraint tolerance 1e-6,
line search 20, no stall exit.  The JAX package runs its scan passes, the
port its plain passes, and its `backward_pass="pallas"` path (the Riccati
wrapper, whose plain version runs on the CPU).  All must reach control
parity <= 1e-3 against tests/goldens/unicycle_turn90_refsolve_f64_tol6.npz.

The spread of the JAX package's own float32 solve, over 64 lanes whose x0
moved by at most PARITY_SPREAD, is the witness behind the Riccati path's
lane-0 limit on the card (RICCATI_PARITY_LIMIT, ops/tolerances.py): its
median stays within 1e-3 and its largest parity within that limit.

Lane 0's status is where the packages part (ROADMAP, "Faults found": the
f32 parity solve ends MAX_INNER_ITERATIONS): the JAX package ends
MAX_INNER_ITERATIONS after 112 iterations, as the port does on the H100,
while the port's plain passes on the CPU round their way to SOLVED.  That
assertion is a strict xfail, so that it fails once the difference is gone.
`tests/_torch_parity_trace.py` prints both packages' per-iteration traces.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu import SolverStatus as JStatus
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import SolverOptions, SolverStatus
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.ops.tolerances import PARITY_SPREAD, RICCATI_PARITY_LIMIT
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory

B = 4
GOLDENS = Path(__file__).parent / "goldens"
PARITY_KW = dict(constraint_tolerance=1e-6, line_search_max_iterations=20, max_stall_iterations=0)


def _jax_fleet_solve(x0):
    """The JAX package's scan passes from x0 [3, lanes]; returns the
    statuses and U [N, m, lanes]."""
    lanes = x0.shape[1]
    defn = JUnicycle(dtype=jnp.float32)
    prob = defn.make_problem().compile()
    solver = JSolver(prob, JOptions(backward_pass="scan", forward_pass="scan", **PARITY_KW))
    Zb = to_batch_last(
        jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (lanes,) + l.shape), defn.initial_trajectory())
    )
    res = jax.jit(solver.solve)(prob.params.replace(x0=jnp.asarray(x0, jnp.float32)), Zb)
    return np.asarray(res["status"]), np.asarray(res["Z"].U, np.float64)


def _jax_solve():
    status, U = _jax_fleet_solve(np.zeros((3, B)))
    return JStatus(int(status[0])).name, U[..., 0]


def _port_solve(**kw):
    defn = UnicycleProblem(dtype=torch.float32, device="cpu")
    prob = defn.make_problem().compile()
    solver = ALSolverBatched(prob, SolverOptions(**PARITY_KW, **kw))
    Z0 = defn.initial_trajectory()
    Z = BatchedTrajectory(Z0.X[..., None].expand(-1, -1, B).contiguous(),
                          Z0.U[..., None].expand(-1, -1, B).contiguous(), Z0.t, Z0.h)
    res = solver.solve(prob.params.replace(x0=torch.zeros((3, B))), Z)
    return SolverStatus(int(res["status"][0])).name, res["Z"].U[..., 0].double().numpy()


@pytest.fixture(scope="module")
def solves():
    return {"jax": _jax_solve(), "port": _port_solve(), "port-riccati": _port_solve(backward_pass="pallas")}


@pytest.mark.parametrize("package", ["jax", "port", "port-riccati"])
def test_f32_control_parity_within_1e3(solves, package):
    U_ref = np.load(GOLDENS / "unicycle_turn90_refsolve_f64_tol6.npz")["U"]
    _, U = solves[package]
    assert np.abs(U - U_ref).max() <= 1e-3


@pytest.mark.xfail(
    strict=True,
    reason="ROADMAP 'Faults found': the f32 parity solve ends MAX_INNER_ITERATIONS "
    "(JAX on the CPU and the port on the H100), the port's CPU plain passes SOLVE",
)
def test_f32_lane0_status_agrees(solves):
    assert solves["jax"][0] == solves["port"][0]


def test_jax_f32_parity_spread_under_a_1e6_move_of_x0():
    """64 lanes, lane 0 at the canonical x0, the others moved by at most
    PARITY_SPREAD: the JAX package's float32 solve keeps its median control
    parity within 1e-3 and its largest within RICCATI_PARITY_LIMIT, while
    single lanes spread well beyond 1e-3 (which is why the Riccati path on
    the card is not held to 1e-3 at lane 0) and part between SOLVED and
    MAX_INNER_ITERATIONS."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-PARITY_SPREAD, PARITY_SPREAD, (3, 64))
    x0[:, 0] = 0.0
    status, U = _jax_fleet_solve(x0)
    U_ref = np.load(GOLDENS / "unicycle_turn90_refsolve_f64_tol6.npz")["U"]
    parity = np.abs(U - U_ref[..., None]).max(axis=(0, 1))
    assert np.median(parity) <= 1e-3
    assert parity.max() <= RICCATI_PARITY_LIMIT
    assert parity.max() > 1e-3
    assert 0 < (status == int(JStatus.SOLVED)).sum() < 64

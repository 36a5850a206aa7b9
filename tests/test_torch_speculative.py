"""The speculative line search (`line_search_parallel` S > 1) in the port,
float64 on the CPU, where the forward kernel's wrapper runs its plain
version at S·B lanes.

The search must accept what the sequential search accepts: on the parking
problem (tests/test_forward_pallas.py:249-312's configuration, N=12, at
B=256 rather than its kernel tile of 1024) S = 2 and 8 against the lockstep search at S = 1 give the same
statuses, iterations, α, U and cost bit for bit, with fewer host syncs; per-instance params
(x0, obstacle layouts) widen with the lanes, once per solve; and at the JAX
test's own three-obstacle configuration (tests/test_forward_pallas.py:
314-371: N=12, B=1024, per-lane circles, initial penalty 10) the port's
S=4 solve gives the JAX package's S=4 solve (its forward kernel in
interpret mode) statuses, iterations and α, and U within 1e-10.  The eager
forward pass ignores S, as the JAX package's scan path does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.ops.forward_pallas import build_forward_kernel
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import SolverOptions, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory

from _torch_fleet import F64, numpy_tree, one_torch_thread  # noqa: F401

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TILE = 1024  # the JAX forward kernel's lane tile
PARKING_B = 256
N = 12


def _fleet_Z(defn, Bz):
    Z0 = defn.initial_trajectory()
    return BatchedTrajectory(Z0.X[..., None].expand(-1, -1, Bz).contiguous(),
                             Z0.U[..., None].expand(-1, -1, Bz).contiguous(), Z0.t, Z0.h)


def _parking(S, seed, forward_pass="cuda", lockstep=False):
    """tests/test_forward_pallas.py:_solve_with_spec_width in the port: the
    parking problem at N=12, x0 uniform in ±0.2 over PARKING_B lanes.
    `lockstep`: at S = 1, the lockstep search over the kernel, one try and
    one host sync a round, in the place of the kernel's own search."""
    defn = UnicycleProblem(dtype=F64, N=N, device="cpu")
    prob = defn.make_problem().compile()
    x0 = torch.as_tensor(np.random.default_rng(seed).uniform(-0.2, 0.2, (3, PARKING_B)))
    solver = ALSolverBatched(prob, SolverOptions(forward_pass=forward_pass, line_search_parallel=S))
    if lockstep:
        def search(self, fwd, params, al_pad, Z, bp, J0, active):
            return ALSolverBatched._line_search_sequential(self, fwd, params, None, al_pad, Z, bp, J0)

        solver._line_search_device = search.__get__(solver)
    res = solver.solve(prob.params.replace(x0=x0), _fleet_Z(defn, PARKING_B))
    return res, solver.host_syncs


def _bitwise(a, b):
    assert torch.equal(a["status"], b["status"])
    for key in ("iterations_total", "iterations_outer", "alpha", "cost", "improvement_ratio"):
        assert torch.equal(getattr(a["stats"], key), getattr(b["stats"], key)), key
    assert torch.equal(a["Z"].U.view(torch.int64), b["Z"].U.view(torch.int64))
    assert torch.equal(a["Z"].X.view(torch.int64), b["Z"].X.view(torch.int64))


@pytest.mark.parametrize("seed", [11, 3])
def test_speculative_equals_sequential_bitwise(seed):
    """S = 2 (several rounds where a lane backtracks more than twice) and
    S = 8 against the lockstep search at S = 1: every decision and value
    bit for bit; fewer host syncs (one per round of S tries instead of one
    per try).  The kernel's own search at S = 1 makes fewer than both."""
    base, syncs1 = _parking(1, seed, lockstep=True)
    own, syncs_own = _parking(1, seed)
    _bitwise(own, base)
    for S in (2, 8):
        res, syncs = _parking(S, seed)
        _bitwise(res, base)
        assert syncs_own < syncs < syncs1, (S, syncs_own, syncs, syncs1)


def test_eager_forward_ignores_S():
    """Without the forward kernel the search is sequential whatever S is."""
    base, syncs1 = _parking(1, 11, forward_pass="scan")
    res, syncs = _parking(8, 11, forward_pass="scan")
    _bitwise(res, base)
    assert syncs == syncs1


def _obstacles_jax():
    """tests/test_forward_pallas.py:314-343: the three-obstacle problem at
    N=12 with per-lane circle centres and x0 over 1024 lanes."""
    defn = JUnicycle(scenario="three_obstacles", dtype=jnp.float64)
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(3)
    cx0, cy0, _ = defn.obstacles
    ci = _circle_family(prob)
    cons = list(prob.params.constraints)
    cons[ci] = dict(
        cons[ci],
        cx=jnp.asarray(cx0[:, None] + rng.uniform(-0.1, 0.1, (3, TILE))),
        cy=jnp.asarray(cy0[:, None] + rng.uniform(-0.1, 0.1, (3, TILE))),
    )
    params = prob.params.replace(x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, TILE))), constraints=tuple(cons))
    Zb = to_batch_last(jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (TILE,) + leaf.shape),
                                              defn.initial_trajectory()))
    return prob, params, Zb


def _circle_family(prob) -> int:
    return next(i for i, f in enumerate(prob.constraint_families) if f.constraint.structure[0] == "circle")


def test_per_lane_obstacles_widen_once_and_equal_sequential():
    """Per-instance x0 and obstacle centres (64 lanes of the three-obstacle
    problem): S=4 tiles every per-instance leaf to 4·B lanes once per
    solve, shares the shared leaves, and equals S=1 bit for bit."""
    Bz = 64
    defn = UnicycleProblem(scenario="three_obstacles", dtype=F64, N=N, device="cpu")
    prob = defn.make_problem().compile()
    rng = np.random.default_rng(3)
    ci = _circle_family(prob)
    cons = list(prob.params.constraints)
    cons[ci] = dict(cons[ci], cx=cons[ci]["cx"][:, None] + torch.as_tensor(rng.uniform(-0.1, 0.1, (3, Bz))),
                    cy=cons[ci]["cy"][:, None] + torch.as_tensor(rng.uniform(-0.1, 0.1, (3, Bz))))
    params = prob.params.replace(x0=torch.as_tensor(rng.uniform(-0.1, 0.1, (3, Bz))), constraints=tuple(cons))
    out = {}
    for S in (1, 4):
        st = ALSolverBatched(prob, SolverOptions(forward_pass="cuda", line_search_parallel=S, initial_penalty=10.0))
        assert st._fwd is not None and st._fwd.takes(params)
        out[S] = st.solve(params, _fleet_Z(defn, Bz))
    params_s = st._spec_params[2]
    assert st._spec_params[0] is params
    assert tuple(params_s.x0.shape) == (3, 4 * Bz)
    assert tuple(params_s.constraints[ci]["cx"].shape) == (3, 4 * Bz)
    torch.testing.assert_close(params_s.constraints[ci]["cy"][:, 2 * Bz: 3 * Bz], params.constraints[ci]["cy"],
                               rtol=0, atol=0)
    assert params_s.constraints[ci]["r"] is params.constraints[ci]["r"]
    _bitwise(out[4], out[1])


def test_per_lane_obstacles_match_jax_at_S4():
    """The port's S=4 against the JAX package's S=4 (its forward kernel in
    interpret mode) at the JAX test's configuration."""
    prob_j, params_j, Zj = _obstacles_jax()
    opts_j = JOptions(forward_pass="pallas", line_search_parallel=4, initial_penalty=10.0)
    sj = JSolver(prob_j, opts_j)
    sj._fwd = build_forward_kernel(prob_j, opts_j, interpret=True, dtype=jnp.float64)
    assert sj._use_fwd(params_j, Zj)
    rj = numpy_tree(sj.solve(params_j, Zj))

    defn = UnicycleProblem(scenario="three_obstacles", dtype=F64, N=N, device="cpu")
    prob_t = defn.make_problem().compile()
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    st = ALSolverBatched(prob_t, SolverOptions(forward_pass="cuda", line_search_parallel=4, initial_penalty=10.0))
    ci = _circle_family(prob_t)
    assert st._fwd is not None and st._fwd.param_sig(params_t) == {f"con{ci}_cx", f"con{ci}_cy"}
    rt = st.solve(params_t, convert.trajectory(numpy_tree(Zj), "cpu", F64))
    np.testing.assert_array_equal(rt["status"].numpy(), rj["status"])
    np.testing.assert_array_equal(rt["stats"].iterations_total.numpy(), rj["stats"].iterations_total)
    np.testing.assert_array_equal(rt["stats"].alpha.numpy(), rj["stats"].alpha)
    np.testing.assert_allclose(rt["Z"].U.numpy(), rj["Z"].U, rtol=0, atol=1e-10)

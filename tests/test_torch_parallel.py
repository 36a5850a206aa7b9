"""The port's multi-device layer (`altro_tpu_torch/parallel/`) against the
JAX package's, float64 on the CPU.

Two gloo ranks of `tests/_torch_dist_worker.py`, started once for the
module, solve their halves of the fleets of tests/test_sharded_batched.py
and tests/multihost_worker.py; the JAX package solves the same fleets
sharded over two of the 8 virtual CPU devices.  Each rank's lanes are held
to the JAX shard's (statuses and iterations equal, U within 1e-9), the
folds to the JAX folds, and each solve's collectives to three one-element
`all_reduce`s.  `BatchedALSolver` is held to the JAX `BatchedALSolver` on
tests/test_batched.py:37-66's terms, and a world of one to the unsharded
solve bit for bit.
"""
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import TripleIntegratorProblem as JTriple
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.parallel.batch import BatchedALSolver as JBatched
from altro_tpu.parallel.mesh import ShardedALSolver as JSharded
from altro_tpu.parallel.mesh import ShardedBatchedALSolver as JShardedBatched
from altro_tpu.parallel.mesh import make_mesh as jmake_mesh
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.parallel.batch import BatchedALSolver, params_axes
from altro_tpu_torch.parallel.mesh import ShardedBatchedALSolver, init_distributed
from altro_tpu_torch.solver.batched import ALSolverBatched
from altro_tpu_torch.solver.functions import ConState

from _torch_dist_worker import lane_major_case
from _torch_fleet import numpy_tree, one_torch_thread, torch_threads  # noqa: F401

F64 = torch.float64
B = 64
WORKER = Path(__file__).parent / "_torch_dist_worker.py"
WORLD = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two gloo ranks, started when the first test asks for them; the
    returned function waits for one case's results (each rank writes a
    case's file as the case ends, so the tests go on while the ranks solve
    the next case) and gives {rank: saved arrays}."""
    out = tmp_path_factory.mktemp("ranks")
    port = free_port()
    logs = [open(out / f"rank{r}.log", "wb") for r in range(WORLD)]
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(port), str(out)],
                         stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)
    ]

    def wait(case: str, timeout: float = 300.0) -> dict:
        paths = [out / f"rank{r}_{case}.npz" for r in range(WORLD)]
        deadline = time.monotonic() + timeout
        while not all(p.exists() for p in paths):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    pytest.fail(f"rank {r} exited with {p.returncode}:\n"
                                + (out / f"rank{r}.log").read_text(errors="replace"))
            assert time.monotonic() < deadline, f"no result of {case} within {timeout} s"
            time.sleep(0.05)
        results = {}
        for r, path in enumerate(paths):
            with np.load(path) as d:
                results[r] = {k: d[k] for k in d.files}
        return results

    yield wait
    for p in procs:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for f in logs:
        f.close()


def _broadcast(Z0, Bsz):
    return jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (Bsz,) + leaf.shape), Z0)


def jax_lane_major():
    """tests/test_sharded_batched.py's B=64, N=20 float64 fleet on two devices."""
    defn = JUnicycle(dtype=jnp.float64)
    defn.N = 20
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    x0 = jnp.asarray(np.random.default_rng(0).uniform(-0.1, 0.1, (3, B)))
    return prob, JOptions(), prob.params.replace(x0=x0), to_batch_last(_broadcast(defn.initial_trajectory(), B))


def jax_obstacles():
    """tests/test_sharded_batched.py:86-128's per-instance obstacle fleet."""
    defn = JUnicycle(scenario="three_obstacles", dtype=jnp.float64)
    defn.N = 12
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(1)
    cx0, cy0, _ = defn.obstacles
    ci = next(i for i, f in enumerate(prob.constraint_families) if f.constraint.structure[0] == "circle")
    cons = list(prob.params.constraints)
    cons[ci] = dict(cons[ci], cx=jnp.asarray(cx0[:, None] + rng.uniform(-0.1, 0.1, (3, B))),
                    cy=jnp.asarray(cy0[:, None] + rng.uniform(-0.1, 0.1, (3, B))))
    params = prob.params.replace(x0=jnp.asarray(rng.uniform(-0.1, 0.1, (3, B))), constraints=tuple(cons))
    return prob, JOptions(initial_penalty=10.0), params, to_batch_last(_broadcast(defn.initial_trajectory(), B))


@pytest.mark.parametrize("case", ["lane_major", "obstacles"])
def test_sharded_batched_matches_jax(ranks, case):
    """Each rank's 32 lanes against the JAX package's ShardedBatchedALSolver
    on two devices: statuses and iterations equal, U within 1e-9; the folds
    equal to the JAX folds, the violation to 1e-9, and to the largest of
    the ranks' own maxima exactly."""
    prob, opts, params, Zb = (jax_lane_major if case == "lane_major" else jax_obstacles)()
    s = JShardedBatched(prob, jmake_mesh(jax.devices()[:WORLD]), opts)
    res, viol, solved, stalled = s.solve(s.shard_params(params), s.shard_batch(Zb))
    status, it, U = (np.asarray(a) for a in (res["status"], res["stats"].iterations_total, res["Z"].U))
    got = ranks(case)
    W = B // WORLD
    for r, out in got.items():
        lanes = slice(r * W, (r + 1) * W)
        np.testing.assert_array_equal(out[f"{case}_status"], status[lanes])
        np.testing.assert_array_equal(out[f"{case}_iterations"], it[lanes])
        np.testing.assert_allclose(out[f"{case}_U"], U[..., lanes], rtol=0, atol=1e-9)
        v, n_solved, n_stalled = out[f"{case}_folds"]
        assert (int(n_solved), int(n_stalled)) == (int(solved), int(stalled))
        np.testing.assert_allclose(v, float(viol), rtol=1e-9)
        assert v == max(o[f"{case}_local_viol_max"] for o in got.values())
    assert int(solved) + int(stalled) > 0


def test_sharded_al_solver_matches_jax(ranks):
    """ShardedALSolver (batch-leading) on tests/multihost_worker.py's
    triple-integrator fleet (B=16): each rank's 8 lanes against the JAX
    package's ShardedALSolver on two devices; every lane SOLVED."""
    defn = JTriple(dof=2)
    prob = defn.make_problem(add_constraints=True).compile()
    Bi = 16
    x0s = np.asarray(defn.x0)[None, :] + np.random.default_rng(0).uniform(-0.4, 0.4, (Bi, defn.n))
    s = JSharded(prob, jmake_mesh(jax.devices()[:WORLD]), JOptions())
    res, viol, solved, stalled = s.solve(prob.params.replace(x0=s.shard_batch(jnp.asarray(x0s))),
                                         s.shard_batch(_broadcast(defn.initial_trajectory(), Bi)))
    status, it, U = (np.asarray(a) for a in (res.status, res.stats.iterations_total, res.Z.U))
    assert int(solved) == Bi
    for r, out in ranks("instance").items():
        lanes = slice(r * Bi // WORLD, (r + 1) * Bi // WORLD)
        np.testing.assert_array_equal(out["instance_status"], status[lanes])
        np.testing.assert_array_equal(out["instance_iterations"], it[lanes])
        np.testing.assert_allclose(out["instance_U"], U[lanes], rtol=1e-8, atol=1e-10)
        v, n_solved, n_stalled = out["instance_folds"]
        assert (int(n_solved), int(n_stalled)) == (int(solved), int(stalled))
        np.testing.assert_allclose(v, float(viol), rtol=1e-9)


@pytest.mark.parametrize("case", ["lane_major", "obstacles", "instance"])
def test_collectives_are_three_scalar_folds(ranks, case):
    """A solve's only collectives are the three folds: one MAX and two SUM
    `all_reduce`s of one element (8 + 4 + 4 bytes in float64), as the
    solver records them and as `torch.distributed` saw them called; the
    mesh is one dimension named "batch" over both ranks."""
    for out in ranks(case).values():
        assert list(out[f"{case}_collectives"]) == ["all_reduce_max:1:8", "all_reduce_sum:1:4", "all_reduce_sum:1:4"]
        assert list(out[f"{case}_calls"]) == ["all_reduce:3"]
        assert int(out["mesh_size"]) == WORLD and list(out["mesh_dims"]) == ["batch"]


def test_indivisible_batch_raises(ranks):
    """A batch the world does not divide raises ValueError, as the JAX mesh
    refuses it."""
    for out in ranks("instance").values():
        assert str(out["indivisible"]).startswith("ValueError: a batch of 3 does not split evenly over 2 ranks")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_world_of_one_is_the_unsharded_solve(one_torch_thread, dtype):
    """A gloo world of one rank: ShardedBatchedALSolver's result and folds
    are the unsharded ALSolverBatched solve's, bit for bit."""
    prob, opts, params, Zb = lane_major_case("cpu", dtype, Bsz=4, N=10)
    ref = ALSolverBatched(prob, opts).solve(params, Zb)
    mesh = init_distributed(backend="gloo", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        s = ShardedBatchedALSolver(prob, mesh, opts)
        res, viol, solved, stalled = s.solve(s.shard_params(params), s.shard_batch(Zb))
    finally:
        dist.destroy_process_group()
    assert torch.equal(res["status"], ref["status"])
    assert torch.equal(res["stats"].iterations_total, ref["stats"].iterations_total)
    assert torch.equal(res["Z"].U, ref["Z"].U) and torch.equal(res["Z"].X, ref["Z"].X)
    assert res["Z"].t.shape == (11,) and res["Z"].h.shape == (10,)
    assert float(viol) == float(ref["stats"].violations.max())
    assert int(solved) == int((ref["status"] == int(SolverStatus.SOLVED)).sum())
    assert int(stalled) == int((ref["status"] == int(SolverStatus.SOLVED_STALLED)).sum())
    assert viol.dtype == dtype and solved.dtype == torch.int32


@pytest.fixture(scope="module")
def batched_pair():
    """tests/test_batched.py:37-66's fleet (turn-90, ctol 1e-6, x0 moved by
    ±0.1) at B=4, N=20 through the JAX BatchedALSolver and the port's."""
    Bb = 4
    defn = JUnicycle()
    defn.N = 20
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    x0s = np.asarray(defn.x0)[None, :] + np.random.default_rng(0).uniform(-0.1, 0.1, (Bb, 3))
    Zj = _broadcast(defn.initial_trajectory(), Bb)
    tdef = UnicycleProblem(dtype=F64, N=20, device="cpu")
    prob_t = tdef.make_problem().compile()
    Z0 = tdef.initial_trajectory()
    Zt = Z0.replace(X=Z0.X.expand(Bb, -1, -1), U=Z0.U.expand(Bb, -1, -1),
                    t=Z0.t.expand(Bb, -1), h=Z0.h.expand(Bb, -1))
    solver = BatchedALSolver(prob_t, SolverOptions(constraint_tolerance=1e-6))

    ref = numpy_tree(JBatched(prob_j, JOptions(constraint_tolerance=1e-6)).solve(
        prob_j.params.replace(x0=jnp.asarray(x0s)), Zj))
    with torch_threads(1):
        res = solver.solve(prob_t.params.replace(x0=torch.as_tensor(x0s)), Zt)
    return ref, res, x0s, solver


def test_batched_al_solver_matches_jax(batched_pair):
    """Statuses, total and outer iterations equal, U within rtol 1e-8 /
    atol 1e-10, violations within 1e-6 (tests/test_batched.py:50-66); the
    result is batch-leading, as the per-instance ALResult vmapped."""
    ref, res, _, _ = batched_pair
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.stats.iterations_total.numpy(), ref.stats.iterations_total)
    np.testing.assert_array_equal(res.stats.iterations_outer.numpy(), ref.stats.iterations_outer)
    np.testing.assert_allclose(res.Z.U.numpy(), ref.Z.U, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.stats.violations.numpy(), ref.stats.violations, rtol=1e-6, atol=1e-12)
    assert res.Z.X.shape == ref.Z.X.shape and res.Z.t.shape == ref.Z.t.shape
    assert res.K.shape == ref.K.shape and res.d.shape == ref.d.shape
    for st, st_ref in zip(res.al, ref.al):
        assert isinstance(st, ConState) and st.lam.shape == st_ref.lam.shape
        np.testing.assert_allclose(st.lam.numpy(), st_ref.lam, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(st.rho.numpy(), st_ref.rho, rtol=0)


def test_batched_al_solver_fills_stats_its_own_way(batched_pair):
    """The leaves the docstring names: no history rows at the default
    capacity (the per-instance solver keeps stats_capacity rows), so every
    length is 0; `cost` is the per-instance solver's on the SOLVED lanes
    and differs on the lane that ends MAX_PENALTY, where the lane-major
    solver keeps the cost its last inner solve started from."""
    ref, res, _, _ = batched_pair
    assert tuple(res.stats.rows.shape) == (4, 0, 8) and ref.stats.rows.shape == (4, 304, 8)
    assert (res.stats.length.numpy() == 0).all() and (ref.stats.length > 0).all()
    status = res.status.numpy()
    solved = status == int(SolverStatus.SOLVED)
    capped = status == int(SolverStatus.MAX_PENALTY)
    assert solved.any() and capped.any()
    np.testing.assert_allclose(res.stats.cost.numpy()[solved], ref.stats.cost[solved], rtol=1e-9)
    assert not np.allclose(res.stats.cost.numpy()[capped], ref.stats.cost[capped], rtol=1e-3)
    np.testing.assert_array_equal(res.stats.cost.numpy()[capped], res.stats.initial_cost.numpy()[capped])


def test_batched_al_solver_warm_start(batched_pair):
    """A warm start from the JAX result's own trajectory and AL state: the
    same statuses and iterations as the JAX BatchedALSolver's warm solve,
    U within 1e-8."""
    ref, _, x0s, solver = batched_pair
    lanes = [0, 1]  # the SOLVED lanes; the MAX_PENALTY lane runs to its cap again
    defn = JUnicycle()
    defn.N = 20
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    Zw = jax.tree_util.tree_map(lambda a: jnp.asarray(a[lanes]), ref.Z)
    alw = jax.tree_util.tree_map(lambda a: jnp.asarray(a[lanes]), ref.al)
    ref2 = numpy_tree(JBatched(prob_j, JOptions(constraint_tolerance=1e-6)).solve(
        prob_j.params.replace(x0=jnp.asarray(x0s[lanes])), Zw, alw))
    res2 = solver.solve(
        solver.prob.params.replace(x0=torch.as_tensor(x0s[lanes])),
        convert.instance_trajectory(jax.tree_util.tree_map(np.asarray, Zw), "cpu", F64),
        convert.instance_al_state(jax.tree_util.tree_map(np.asarray, alw), "cpu", F64),
    )
    np.testing.assert_array_equal(res2.status.numpy(), ref2.status)
    np.testing.assert_array_equal(res2.stats.iterations_total.numpy(), ref2.stats.iterations_total)
    np.testing.assert_allclose(res2.Z.U.numpy(), ref2.Z.U, rtol=0, atol=1e-8)


def test_params_axes_prefix_trees():
    """`params_axes` is the JAX package's prefix tree: an int batches every
    leaf below it, None shares them, a dict chooses per entry.  Batching
    only the cost's `q` moves that leaf's batch axis to the end and leaves
    the others as they are; lanes whose time grids differ raise."""
    from altro_tpu_torch.parallel.batch import batch_last_inputs

    assert params_axes() == params_axes(x0=0, dynamics=None, costs=None, constraints=None)
    tdef = UnicycleProblem(dtype=F64, N=12, device="cpu")
    prob = tdef.make_problem().compile()
    Bb = 3
    cost = prob.params.costs[0]
    params = prob.params.replace(
        x0=torch.zeros((Bb, 3), dtype=F64),
        costs=(dict(cost, q=cost["q"][None].expand(Bb, -1, -1).clone()),),
    )
    Z0 = tdef.initial_trajectory()
    Z = Z0.replace(X=Z0.X.expand(Bb, -1, -1), U=Z0.U.expand(Bb, -1, -1), t=Z0.t.expand(Bb, -1),
                   h=Z0.h.expand(Bb, -1))
    p_b, Zb, al = batch_last_inputs(params_axes(x0=0, costs=({"q": 0},)), params, Z)
    assert p_b.x0.shape == (3, Bb) and al is None
    assert p_b.costs[0]["q"].shape == (13, 3, Bb)
    assert all(p_b.costs[0][k] is cost[k] for k in cost if k != "q")
    assert p_b.constraints is params.constraints
    assert Zb.X.shape == (13, 3, Bb) and Zb.U.shape == (12, 2, Bb) and Zb.t.shape == (13,)
    p_all, _, _ = batch_last_inputs(params_axes(x0=0, costs=0),
                                    params.replace(costs=({k: v[None].expand(Bb, *v.shape) for k, v in cost.items()},)), Z)
    assert all(p_all.costs[0][k].shape == v.shape + (Bb,) for k, v in cost.items())
    with pytest.raises(ValueError, match="time grids differ"):
        batch_last_inputs(params_axes(), params, Z.replace(t=Z.t + torch.arange(Bb)[:, None]))

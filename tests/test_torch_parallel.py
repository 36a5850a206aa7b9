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


def test_reversed_mesh_matches_jax(ranks):
    """`make_mesh` over the ranks in reverse order, called as the JAX
    package calls it (a positional list): rank 1 takes lanes [0, 32) and
    rank 0 lanes [32, 64), each rank's lanes those that the JAX
    ShardedBatchedALSolver places on the same device of
    make_mesh(jax.devices()[:2][::-1]) (statuses and iterations equal, U
    within 1e-9, as test_sharded_batched_matches_jax); the folds are the
    JAX folds and those of the mesh in rank order."""
    prob, opts, params, Zb = jax_lane_major()
    devices = jax.devices()[:WORLD]
    s = JShardedBatched(prob, jmake_mesh(devices[::-1]), opts)
    res, viol, solved, stalled = s.solve(s.shard_params(params), s.shard_batch(Zb))
    status, it = (np.asarray(a) for a in (res["status"], res["stats"].iterations_total))
    shard_of = {sh.device: sh for sh in res["Z"].U.addressable_shards}
    got, in_order = ranks("reversed"), ranks("lane_major")
    W = B // WORLD
    for r, out in got.items():
        start, stop = (int(v) for v in out["lanes"])
        assert (start, stop) == ((WORLD - 1 - r) * W, (WORLD - r) * W)
        assert list(out["mesh_ranks"]) == list(range(WORLD))[::-1]
        shard = shard_of[devices[r]]
        assert shard.index[-1] == slice(start, stop)
        np.testing.assert_array_equal(out["reversed_status"], status[start:stop])
        np.testing.assert_array_equal(out["reversed_iterations"], it[start:stop])
        np.testing.assert_allclose(out["reversed_U"], np.asarray(shard.data), rtol=0, atol=1e-9)
        v, n_solved, n_stalled = out["reversed_folds"]
        assert (int(n_solved), int(n_stalled)) == (int(solved), int(stalled))
        np.testing.assert_allclose(v, float(viol), rtol=1e-9)
        assert list(out["reversed_folds"]) == list(in_order[r]["lane_major_folds"])
        assert list(out["reversed_collectives"]) == ["all_reduce_max:1:8", "all_reduce_sum:1:4", "all_reduce_sum:1:4"]


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


def test_batched_al_solver_stats_match_jax(batched_pair):
    """Every leaf of the stats as the JAX BatchedALSolver (the per-instance
    solver vmapped) fills it, on lanes that include one ending MAX_PENALTY:
    the iteration counts and the row pointer `length` equal; `cost` (the
    last cost logged), `violations`, `max_penalty`, `initial_cost`,
    `alpha` and `regularization` within 1e-9 relative (and 1e-15
    absolute: a violation of 2e-8 is the residual of states of order 1,
    whose rounding is 2.2e-16); the history rows up to and including the
    pointer's (the values after each iteration, then the final ones) in
    those columns the same, the rows after it zero, and the final leaves
    the pointer's row; each lane's own time grid.

    The named exception (BatchedALSolver's docstring): three columns that
    are ill-conditioned functions of the ones above, each held at 1e-9
    relative of what it is computed from.  The two solvers' costs differ
    by up to 8.6e-11 relative (their trajectories by their order of
    operations), so
    - `cost_decrease`, the difference of the costs before and after an
      iteration, is held within 1e-9 of the larger of the two, and of the
      lane's largest logged cost (measured: 8.4e-11; relative to the
      decrease itself, up to 7.3e-4 where it is 1.6e-10);
    - `improvement_ratio`, that decrease over the line search's predicted
      one, is held through the prediction (decrease / ratio) within 1e-9
      relative, with the cost's rounding eps * cost as the floor (measured:
      2.3e-10, and 3.9e-19 where the prediction is 1.9e-11), on the
      iterations whose line search succeeded, and within 1e-3 absolute
      (measured: 5.5e-4 where the decrease is 1.6e-10); after a failed
      one both solvers carry the ratio over unchanged;
    - `gradient`, the feedforward gains' size, comes from solves with the
      penalty ρ on the active rows, whose rounding grows as eps * ρ: it is
      held within min(1e-9 + 30 eps ρ, 1e-6) relative, ρ the row's largest
      penalty (measured: 7.8e-11 on the SOLVED lanes, up to 1e4; 3.2e-7
      at ρ = 1e8, 14.5 eps ρ)."""
    from altro_tpu_torch.types import _COLUMNS

    ref, res, _, _ = batched_pair
    st, sj = res.stats, ref.stats
    status = res.status.numpy()
    assert (status == int(SolverStatus.SOLVED)).any() and (status == int(SolverStatus.MAX_PENALTY)).any()
    for name in ("iterations_inner", "iterations_outer", "iterations_total", "length"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), getattr(sj, name), err_msg=name)
    for name in ("cost", "violations", "max_penalty", "initial_cost", "alpha", "regularization"):
        np.testing.assert_allclose(getattr(st, name).numpy(), getattr(sj, name), rtol=1e-9, atol=1e-15, err_msg=name)
    rows = st.rows.numpy()
    assert rows.shape == sj.rows.shape == (4, 304, 8)
    col = {name: i for i, name in enumerate(_COLUMNS)}
    eps = np.finfo(np.float64).eps
    for b, L in enumerate(sj.length):
        got, want = rows[b, :L + 1], sj.rows[b, :L + 1]
        for name in ("cost", "alpha", "regularization", "violations", "max_penalty"):
            np.testing.assert_allclose(got[:, col[name]], want[:, col[name]], rtol=1e-9, atol=1e-15,
                                       err_msg=f"lane {b} {name}")
        for stats, r in ((st, got), (sj, want)):  # the final leaves are the pointer's row
            for name in _COLUMNS:
                assert float(getattr(stats, name)[b]) == r[L, col[name]], f"lane {b} {name}"
        J = want[:, col["cost"]]
        scale = np.maximum(np.abs(J), np.abs(np.concatenate([[sj.initial_cost[b]], J[:-1]])))
        dg, dw = got[:, col["cost_decrease"]], want[:, col["cost_decrease"]]
        assert (np.abs(dg - dw) <= 1e-9 * np.minimum(scale, np.abs(J).max())).all(), f"lane {b} cost_decrease"
        zg, zw = got[:, col["improvement_ratio"]], want[:, col["improvement_ratio"]]
        ok = dw != 0  # a line search that succeeded
        pg, pw = dg[ok] / zg[ok], dw[ok] / zw[ok]
        assert (np.abs(pg - pw) <= 1e-9 * np.abs(pw) + eps * np.abs(J[ok])).all(), f"lane {b} improvement_ratio"
        np.testing.assert_allclose(zg, zw, rtol=0, atol=1e-3, err_msg=f"lane {b} improvement_ratio")
        carried = np.nonzero(~ok)[0]
        assert (dg[carried] == 0).all() and carried.min(initial=1) > 0, f"lane {b} failed line searches"
        np.testing.assert_array_equal(zg[carried], zg[carried - 1])
        np.testing.assert_array_equal(zw[carried], zw[carried - 1])
        rho = want[:, col["max_penalty"]]
        np.testing.assert_array_less(np.abs(got[:, col["gradient"]] - want[:, col["gradient"]]),
                                     np.minimum(1e-9 + 30 * eps * rho, 1e-6) * np.abs(want[:, col["gradient"]])
                                     + 1e-300,
                                     err_msg=f"lane {b} gradient")
        assert not rows[b, L + 1:].any() and not sj.rows[b, L + 1:].any()
    np.testing.assert_array_equal(res.Z.t.numpy(), ref.Z.t)
    np.testing.assert_array_equal(res.Z.h.numpy(), ref.Z.h)


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
    the others as they are.  Lanes whose time grids differ solve, each as
    the JAX BatchedALSolver solves it: statuses, iterations and the row
    pointer equal, U within rtol 1e-8 / atol 1e-10 (as
    test_batched_al_solver_matches_jax), the logged cost within 1e-9."""
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
    # lanes 1 and 3 on a grid 5% longer than lanes 0 and 2's: two lane-major
    # solves put back in order, as the JAX class vmaps the grids whole
    Bg = 4
    defn = JUnicycle()
    defn.N = 12
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    x0s = np.asarray(defn.x0)[None, :] + np.random.default_rng(2).uniform(-0.1, 0.1, (Bg, 3))
    scale = np.array([1.0, 1.05, 1.0, 1.05])[:, None]
    Zj = _broadcast(defn.initial_trajectory(), Bg)
    Zj = Zj.replace(t=Zj.t * scale, h=Zj.h * scale)
    ref = numpy_tree(JBatched(prob_j, JOptions()).solve(prob_j.params.replace(x0=jnp.asarray(x0s)), Zj))
    with torch_threads(1):
        res = BatchedALSolver(prob, SolverOptions()).solve(
            prob.params.replace(x0=torch.as_tensor(x0s)), convert.instance_trajectory(numpy_tree(Zj), "cpu", F64))
    np.testing.assert_array_equal(res.Z.t.numpy(), ref.Z.t)
    np.testing.assert_array_equal(res.Z.h.numpy(), ref.Z.h)
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.stats.iterations_total.numpy(), ref.stats.iterations_total)
    np.testing.assert_array_equal(res.stats.length.numpy(), ref.stats.length)
    np.testing.assert_allclose(res.Z.U.numpy(), ref.Z.U, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.stats.cost.numpy(), ref.stats.cost, rtol=1e-9)
    assert not np.allclose(ref.Z.U[0], ref.Z.U[1], atol=1e-6)

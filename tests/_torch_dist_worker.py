"""One rank of the port's sharded solvers over gloo, for
tests/test_torch_parallel.py (which starts every rank of a world) and for
tests/test_torch_gpu.py (two ranks on one card).

    python tests/_torch_dist_worker.py RANK WORLD PORT OUT_DIR [DEVICE [kernels]]

Each rank joins the world at tcp://localhost:PORT, solves its slice of the
cases below and writes `OUT_DIR/rank{RANK}_{case}.npz` as each case ends:
its lanes' statuses, iterations and U, the three folds, the solver's record
of its collectives and the count of every `torch.distributed` collective
the solve called.  The inputs are made with numpy from the seeds of the JAX package's
tests, so the caller can hold each shard against the JAX package:
  lane_major  — `ShardedBatchedALSolver`, the turn-90 unicycle at N=20,
                B=64, x0 uniform in ±0.1 (tests/test_sharded_batched.py:_setup)
  obstacles   — the same over the three-obstacle scenario at N=12, B=64,
                per-lane obstacle centres and x0, initial penalty 10
                (tests/test_sharded_batched.py:86-128)
  instance    — `ShardedALSolver` on the triple integrator (dof 2), B=16,
                x0 moved by ±0.4 (tests/multihost_worker.py)
  indivisible — the ValueError of a batch of 3 (world 2 and up), saved
                with the instance case
  reversed    — the lane_major case on `make_mesh` over the ranks in
                reverse order, given as the JAX call form's positional
                list: the last rank takes the first slice
With `kernels` every case runs the fused CUDA kernels (`KERNELS`), which
need the card.  It imports nothing of JAX.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from altro_tpu_torch import SolverOptions  # noqa: E402
from altro_tpu_torch.models.problems import TripleIntegratorProblem, UnicycleProblem  # noqa: E402
from altro_tpu_torch.parallel.mesh import (  # noqa: E402
    ShardedALSolver,
    ShardedBatchedALSolver,
    _local_range,
    init_distributed,
    make_mesh,
)
from altro_tpu_torch.solver.batched import BatchedTrajectory  # noqa: E402

F64 = torch.float64
B = 64
KERNELS = dict(backward_pass="fused", forward_pass="cuda")
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "send", "recv", "barrier",
               "gather", "scatter")


def count_collectives() -> dict:
    """Wrap every collective of `torch.distributed` with a counter."""
    calls = {}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name in COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, wrap(name, getattr(dist, name)))
    return calls


def fleet_Z(defn, Bsz):
    Z0 = defn.initial_trajectory()
    return BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, Bsz).contiguous(),
                             U=Z0.U[..., None].expand(-1, -1, Bsz).contiguous(), t=Z0.t, h=Z0.h)


def lane_major_case(dev, dtype=F64, Bsz=B, N=20):
    """(problem, options, params, Z) of the lane_major case, full batch."""
    defn = UnicycleProblem(dtype=dtype, N=N, device=dev)
    prob = defn.make_problem().compile()
    x0 = np.random.default_rng(0).uniform(-0.1, 0.1, (3, Bsz))
    return prob, SolverOptions(), prob.params.replace(x0=torch.as_tensor(x0, device=dev).to(dtype)), fleet_Z(defn, Bsz)


def obstacles_case(dev):
    defn = UnicycleProblem(scenario="three_obstacles", dtype=F64, N=12, device=dev)
    prob = defn.make_problem().compile()
    rng = np.random.default_rng(1)
    cx0, cy0, _ = defn.obstacles
    ci = next(i for i, f in enumerate(prob.constraint_families) if f.constraint.structure[0] == "circle")
    cons = list(prob.params.constraints)
    cons[ci] = dict(cons[ci], cx=torch.as_tensor(cx0[:, None] + rng.uniform(-0.1, 0.1, (3, B)), device=dev),
                    cy=torch.as_tensor(cy0[:, None] + rng.uniform(-0.1, 0.1, (3, B)), device=dev))
    params = prob.params.replace(x0=torch.as_tensor(rng.uniform(-0.1, 0.1, (3, B)), device=dev),
                                 constraints=tuple(cons))
    return prob, SolverOptions(initial_penalty=10.0), params, fleet_Z(defn, B)


def instance_case(dev):
    Bi = 16
    defn = TripleIntegratorProblem(dof=2, dtype=F64, device=dev)
    prob = defn.make_problem(add_constraints=True).compile()
    rng = np.random.default_rng(0)
    x0s = np.asarray(defn.x0)[None, :] + rng.uniform(-0.4, 0.4, (Bi, defn.n))
    Z0 = defn.initial_trajectory()
    Zb = Z0.replace(X=Z0.X.expand(Bi, -1, -1), U=Z0.U.expand(Bi, -1, -1),
                    t=Z0.t.expand(Bi, -1), h=Z0.h.expand(Bi, -1))
    return prob, SolverOptions(), prob.params.replace(x0=torch.as_tensor(x0s, device=dev)), Zb


def record(out_dir, rank, name, solver, res, folds, calls, **extra):
    """Save one case's local lanes, folds and collectives, with `extra`, to
    `rank{rank}_{name}.npz` in `out_dir` (written under another name and
    renamed, so that a reader never sees half a file)."""
    out = dict(extra)
    if isinstance(res, dict):
        status, it, U = res["status"], res["stats"].iterations_total, res["Z"].U
    else:
        status, it, U = res.status, res.stats.iterations_total, res.Z.U
    viol, solved, stalled = folds
    out[f"{name}_status"] = status.cpu().numpy()
    out[f"{name}_iterations"] = it.cpu().numpy()
    out[f"{name}_U"] = U.cpu().numpy()
    out[f"{name}_folds"] = np.array([float(viol), int(solved), int(stalled)])
    out[f"{name}_local_viol_max"] = float((res["stats"].violations if isinstance(res, dict)
                                          else res.stats.violations).amax())
    out[f"{name}_collectives"] = np.array([f"{op}:{n}:{nbytes}" for op, n, nbytes in solver.collectives])
    out[f"{name}_calls"] = np.array([f"{k}:{v}" for k, v in sorted(calls.items())])
    path = os.path.join(out_dir, f"rank{rank}_{name}.npz")
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)


def main(argv) -> int:
    rank, world, port, out_dir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    dev = torch.device(argv[4] if len(argv) > 4 else "cpu")
    passes = KERNELS if argv[5:] == ["kernels"] else {}
    torch.set_num_threads(1)  # the ranks share the host's cores
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mesh = init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    calls = count_collectives()
    mesh_info = dict(world=world, mesh_size=mesh.size(), mesh_dims=np.array(mesh.mesh_dim_names))
    try:
        cases = [("lane_major", lane_major_case(dev)), ("obstacles", obstacles_case(dev))]
        for name, (prob, opts, params, Zb) in cases:
            s = ShardedBatchedALSolver(prob, mesh, opts.replace(**passes))
            p_l, Z_l = s.shard_params(params), s.shard_batch(Zb)
            calls.clear()
            res, *folds = s.solve(p_l, Z_l)
            record(out_dir, rank, name, s, res, folds, calls, **mesh_info)
        prob, opts, params, Zb = instance_case(dev)
        s = ShardedALSolver(prob, mesh, opts.replace(**passes))
        p_l, Z_l = s.shard_params(params), s.shard_batch(Zb)
        calls.clear()
        res, *folds = s.solve(p_l, Z_l)
        indivisible = "no error"
        try:
            s.shard_batch(Zb.replace(X=Zb.X[:3], U=Zb.U[:3], t=Zb.t[:3], h=Zb.h[:3]))
        except ValueError as e:
            indivisible = f"ValueError: {e}"
        record(out_dir, rank, "instance", s, res, folds, calls, indivisible=indivisible, **mesh_info)
        rev = make_mesh(list(reversed(range(world))))
        prob, opts, params, Zb = lane_major_case(dev)
        s = ShardedBatchedALSolver(prob, rev, opts.replace(**passes))
        p_l, Z_l = s.shard_params(params), s.shard_batch(Zb)
        calls.clear()
        res, *folds = s.solve(p_l, Z_l)
        record(out_dir, rank, "reversed", s, res, folds, calls, lanes=np.array(_local_range(B, rev, "batch")),
               mesh_ranks=np.array(rev.mesh.tolist()), **mesh_info)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

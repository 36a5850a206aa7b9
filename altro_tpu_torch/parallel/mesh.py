"""Sharded batched solves over `torch.distributed` (`altro_tpu/parallel/mesh.py`).

The batch of scenarios is split over the ranks of a one-dimensional
`DeviceMesh` (`make_mesh`), one contiguous slice each, in the mesh's
order: the rank at position i of the mesh's dimension takes the i-th
slice, as the JAX mesh's i-th device takes the i-th shard.  Per-scenario
solves are independent, so each rank solves its slice alone; the only
communication is the three
scalar statistics folds the reference also performs
(`altro/augmented_lagrangian/al_solver.hpp:417-434`): the maximum
violation (one `MAX` `all_reduce`) and the SOLVED and SOLVED_STALLED counts
(two `SUM` `all_reduce`s) over the mesh dimension's process group, one
element each, 12 or 16 bytes a rank per solve.  The JAX package runs them
as `pmax`/`psum` inside `shard_map`.

Backends: NCCL for ranks on their own GPUs (it takes one rank per GPU),
gloo on the CPU and for several ranks sharing one GPU (gloo reduces CUDA
tensors too).  The caller starts the ranks and gives
`init_process_group` its address, world size and rank (`init_distributed`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..solver.batched import ALSolverBatched, per_instance
from ..types import SolverStatus, Trajectory
from ..utils.tree import tree_map
from .batch import BatchedALSolver, map_axes, params_axes


def make_mesh(devices=None, axis: str = "batch"):
    """A one-dimensional `DeviceMesh` over the global ranks `devices`, in
    that order (None: every rank of the default group), its dimension named
    `axis`.  The JAX call form `make_mesh(devices)` reads here as a list of
    ranks.  Every rank of the default group builds the mesh (its process
    group is made collectively), also a rank that is not in it."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis,))


def init_distributed(**kwargs):
    """`torch.distributed.init_process_group(**kwargs)`, with the NCCL
    backend when CUDA is available and gloo otherwise unless `backend` is
    given, and the mesh over its ranks (`make_mesh`)."""
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)
    return make_mesh()


def _local_range(B: int, mesh, axis: str) -> tuple[int, int]:
    """This rank's contiguous slice [start, stop) of a batch of B: the slice
    of its position along the mesh dimension `axis`."""
    dim = mesh.mesh_dim_names.index(axis)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    world, pos = mesh.size(dim), coord[dim]
    if B % world:
        raise ValueError(f"a batch of {B} does not split evenly over {world} ranks")
    size = B // world
    return pos * size, (pos + 1) * size


class _Folds:
    """The solve's statistics folds over the process group of the mesh
    dimension `axis`, recorded: `collectives` lists each `all_reduce` of
    the last solve as (op, elements, bytes)."""

    def __init__(self, mesh, axis: str):
        self.mesh = mesh
        self.axis = axis
        self.collectives: list[tuple[str, int, int]] = []

    def _all_reduce(self, value: torch.Tensor, op, name: str) -> torch.Tensor:
        buf = value.reshape(1).clone()
        dist.all_reduce(buf, op=op, group=self.mesh.get_group(self.axis))
        self.collectives.append((name, buf.numel(), buf.numel() * buf.element_size()))
        return buf[0]

    def fold(self, violations: torch.Tensor, status: torch.Tensor):
        """(max violation, SOLVED count, SOLVED_STALLED count) over every
        rank's lanes."""
        self.collectives = []
        viol = self._all_reduce(violations.amax(), dist.ReduceOp.MAX, "all_reduce_max")
        solved = self._all_reduce((status == int(SolverStatus.SOLVED)).sum().to(torch.int32),
                                  dist.ReduceOp.SUM, "all_reduce_sum")
        stalled = self._all_reduce((status == int(SolverStatus.SOLVED_STALLED)).sum().to(torch.int32),
                                   dist.ReduceOp.SUM, "all_reduce_sum")
        return viol, solved, stalled


class ShardedALSolver(_Folds):
    """`BatchedALSolver` (batch-leading) over a batch split across the ranks
    (`altro_tpu.parallel.mesh.ShardedALSolver`).  `shard_batch` and
    `shard_params` cut this rank's slice of the leading axis out of the
    full host batch; `solve` solves it and folds the fleet's statistics."""

    def __init__(self, prob: CompiledProblem, mesh, opts: SolverOptions = None,
                 in_axes: ProblemParams = None, axis: str = "batch"):
        super().__init__(mesh, axis)
        self.prob = prob
        self.in_axes = in_axes if in_axes is not None else params_axes(x0=0)
        self.solver = BatchedALSolver(prob, opts, self.in_axes)
        self.device = prob.params.x0.device

    def _slice(self, leaf, axis: int = 0) -> torch.Tensor:
        leaf = torch.as_tensor(leaf)
        start, stop = _local_range(leaf.shape[axis], self.mesh, self.axis)
        return leaf.narrow(axis, start, stop - start).contiguous().to(self.device)

    def shard_batch(self, tree):
        """This rank's slice of the leading axis of every leaf of `tree`."""
        return tree_map(self._slice, tree)

    def shard_params(self, params: ProblemParams) -> ProblemParams:
        """`params` with this rank's slice of every leaf `in_axes` batches."""
        return map_axes(lambda ax, leaf: self._slice(leaf, ax), self.in_axes, params)

    def solve(self, params: ProblemParams, Z: Trajectory):
        """Solve this rank's slice.  Returns ``(result, max_violation,
        n_solved, n_stalled)``: the local `ALResult` (batch-leading) and the
        folds over every rank.  ``n_solved`` counts SOLVED only; stall exits
        (SOLVED_STALLED) are counted apart, so that fleet statistics cannot
        absorb non-convergence."""
        res = self.solver.solve(params, Z)
        return (res, *self.fold(res.stats.violations, res.status))


class ShardedBatchedALSolver(_Folds):
    """The lane-major `ALSolverBatched` (fused kernels included) on this
    rank's slice of the batch-last axis
    (`altro_tpu.parallel.mesh.ShardedBatchedALSolver`).

    The solve is communication-free: each rank iterates as long as its own
    lanes need, and a lane's result does not depend on the other lanes
    (the regularization retry and the kernels are per lane), so a rank's
    lanes are bit for bit those of the unsharded solve.  The only
    collectives are the three folds (module docstring)."""

    def __init__(self, prob: CompiledProblem, mesh, opts: SolverOptions = None, axis: str = "batch"):
        super().__init__(mesh, axis)
        self.prob = prob
        self.solver = ALSolverBatched(prob, opts)
        self.device = prob.params.x0.device

    def _slice_last(self, leaf) -> torch.Tensor:
        leaf = torch.as_tensor(leaf)
        start, stop = _local_range(leaf.shape[-1], self.mesh, self.axis)
        return leaf[..., start:stop].contiguous().to(self.device)

    def shard_batch(self, tree):
        """This rank's slice of the trailing axis of every leaf of a
        batch-last trajectory or AL state; 1-D leaves (the shared time grid
        t, h) stay whole."""
        return tree_map(lambda leaf: self._slice_last(leaf) if leaf.ndim > 1 else leaf.to(self.device), tree)

    def shard_params(self, params: ProblemParams) -> ProblemParams:
        """This rank's slice of every per-instance (trailing-batch) param
        leaf; shared leaves stay whole (the `batch_axes` rule)."""
        return tree_map(
            lambda c, leaf: self._slice_last(leaf) if per_instance(c, leaf) else torch.as_tensor(leaf).to(self.device),
            self.prob.params, params,
        )

    def solve(self, params: ProblemParams, Zb):
        """Solve this rank's slice of the batch-last fleet.  Returns
        ``(res dict, max_violation, n_solved, n_stalled)``: the local result
        with the contract of `ALSolverBatched.solve`, and the folds over
        every rank."""
        res = self.solver.solve(params, Zb)
        return (res, *self.fold(res["stats"].violations, res["status"]))

"""Batched solves of many problem instances (`altro_tpu/parallel/batch.py`).

The JAX package lifts the per-instance solver to a batch with `jax.vmap`.
The port's per-instance solver (`solver/al.py`) is a host loop, which
`torch.func.vmap` cannot lift, and looping it over the lanes costs about a
second and a half a solve on the card.  So `BatchedALSolver` keeps the
JAX class's batch-leading contract and runs the lane-major solver
(`ALSolverBatched`, the caller's passes and fused kernels included) in
between: it moves the batch axis of the inputs to the end, solves, and
moves it back to the front of a per-instance `ALResult`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..solver.al import ALResult
from ..solver.batched import ALSolverBatched, to_batch_last
from ..solver.functions import ConState
from ..types import SolverStats, Trajectory


def params_axes(x0=0, dynamics=None, costs=None, constraints=None) -> ProblemParams:
    """A `ProblemParams` of batch axes in pytree-prefix form (the JAX
    package's vmap `in_axes`): an int batches every leaf below it along that
    axis, None shares them, a matching tuple or dict chooses per entry.

    Defaults to batching only the initial state."""
    return ProblemParams(x0=x0, dynamics=dynamics, costs=costs, constraints=constraints)


def map_axes(fn, axes, tree):
    """`fn(axis, leaf)` over the leaves of `tree` that the prefix tree `axes`
    gives an int axis; the leaves under None stay as they are."""
    if axes is None or tree is None:
        return tree
    if isinstance(axes, int):
        if isinstance(tree, dict):
            return {k: map_axes(fn, axes, v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(map_axes(fn, axes, v) for v in tree)
        if isinstance(tree, ProblemParams):
            return map_axes(fn, ProblemParams(axes, axes, axes, axes), tree)
        return fn(axes, tree)
    if isinstance(axes, ProblemParams):
        return ProblemParams(*(map_axes(fn, getattr(axes, f.name), getattr(tree, f.name))
                               for f in dataclasses.fields(ProblemParams)))
    if isinstance(axes, dict):
        return {k: map_axes(fn, axes.get(k), v) for k, v in tree.items()}
    return type(tree)(map_axes(fn, a, v) for a, v in zip(axes, tree))


def _last(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return torch.movedim(t, axis, -1).contiguous()


def _first(t: torch.Tensor) -> torch.Tensor:
    return torch.movedim(t, -1, 0).contiguous()


def batch_last_inputs(in_axes: ProblemParams, params: ProblemParams, Z: Trajectory, al=None):
    """The lane-major solver's inputs from batch-leading ones: the batched
    param leaves' batch axis moved to the end, the trajectory's X and U as
    [N+1, n, B] and [N, m, B] with the shared time grid, and an AL state
    of `ConState` with a leading batch axis as the lane-major tuple of
    {lam [nk, p, B], rho [nk, B]}.  Lanes whose time grids differ raise
    ValueError: the lane-major solver shares one grid."""
    t, h = Z.t, Z.h
    if t.ndim == 2 and not (torch.equal(t, t[:1].expand_as(t)) and torch.equal(h, h[:1].expand_as(h))):
        raise ValueError("the lanes' time grids differ; the lane-major solver shares one")
    params_b = map_axes(lambda ax, leaf: _last(torch.as_tensor(leaf), ax), in_axes, params)
    al_b = None if al is None else tuple(dict(lam=_last(s.lam), rho=_last(s.rho)) for s in al)
    return params_b, to_batch_last(Z), al_b


def instance_result(res: dict) -> ALResult:
    """A lane-major result dict as the per-instance `ALResult` with a
    leading batch axis (see `BatchedALSolver` for the leaves the two
    solvers fill differently)."""
    Zb, st = res["Z"], res["stats"]
    B = res["status"].shape[0]
    length = st.iterations_total.clamp(max=st.rows.shape[0]).to(torch.int32)
    stats = SolverStats(
        iterations_inner=st.iterations_inner, iterations_outer=st.iterations_outer,
        iterations_total=st.iterations_total, initial_cost=st.initial_cost, cost=st.cost,
        alpha=st.alpha, improvement_ratio=st.improvement_ratio, gradient=st.gradient,
        cost_decrease=st.cost_decrease, regularization=st.regularization, violations=st.violations,
        max_penalty=st.max_penalty, rows=torch.movedim(st.rows, -1, 0).contiguous(), length=length,
    )
    Z = Trajectory(X=_first(Zb.X), U=_first(Zb.U), t=Zb.t.expand(B, -1), h=Zb.h.expand(B, -1))
    al = tuple(ConState(lam=_first(s["lam"]), rho=_first(s["rho"])) for s in res["al"])
    return ALResult(Z=Z, al=al, status=res["status"], stats=stats, K=_first(res["K"]), d=_first(res["d"]))


class BatchedALSolver:
    """AL-iLQR over a batch of problem instances, batch-leading
    (`altro_tpu.parallel.batch.BatchedALSolver`).

    ``in_axes`` selects which problem parameters vary across the batch
    (default: the initial state only).  The trajectory guess is always
    batched.  The solve runs `ALSolverBatched` with the caller's options
    (module docstring), so its statuses, iterations and trajectories are
    the per-instance solver's (`tests/test_batched.py:37-66` holds the two
    solvers to each other).  The leaves of the returned `ALResult` that the
    lane-major solver fills differently from the per-instance one:
      * `stats.rows`: the lane-major history, row i holding a lane's values
        after its (i+1)-th iteration, capacity `iteration_history_capacity`
        (default 0: no rows); the per-instance solver keeps
        `stats_capacity` rows, the first being the values before the solve.
      * `stats.length`: each lane's count of valid rows, its iterations
        capped at that capacity; the per-instance solver's row pointer.
      * `stats.cost` on a lane whose last inner solve took no step (its
        line searches failed, as on a lane that ends MAX_PENALTY): the
        cost that solve started from; the per-instance solver reports the
        last cost it logged.
      * `Z.t`, `Z.h`: the one time grid, broadcast over the batch.
    `stats.improvement_ratio`, `gradient`, `cost_decrease` and the gains
    `K`, `d` agree with the per-instance solver's to each solver's order
    of operations only.
    """

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None, in_axes: ProblemParams = None):
        self.solver = ALSolverBatched(prob, opts)
        self.prob = prob
        self.in_axes = in_axes if in_axes is not None else params_axes(x0=0)

    def solve(self, params: ProblemParams, Z: Trajectory, al=None) -> ALResult:
        """Solve a batch.  `params` leaves selected by `in_axes` carry a
        leading batch dim; `Z` is batched; `al` optionally warm-starts
        (batched)."""
        return instance_result(self.solver.solve(*batch_last_inputs(self.in_axes, params, Z, al)))

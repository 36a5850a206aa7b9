"""Batched solves of many problem instances (`altro_tpu/parallel/batch.py`).

The JAX package lifts the per-instance solver to a batch with `jax.vmap`.
The port's per-instance solver (`solver/al.py`) is a host loop, which
`torch.func.vmap` cannot lift, and looping it over the lanes costs about a
second and a half a solve on the card.  So `BatchedALSolver` keeps the
JAX class's batch-leading contract and runs the lane-major solver
(`ALSolverBatched`, the caller's passes and fused kernels included) in
between: it moves the batch axis of the inputs to the end, solves, and
moves it back to the front of a per-instance `ALResult`, its statistics
laid out as the per-instance solver lays them out.
"""
from __future__ import annotations

import dataclasses

import torch

from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..solver.al import ALResult
from ..solver.batched import ALSolverBatched, to_batch_last
from ..solver.functions import ConState
from ..types import _COLUMNS, SolverStats, Trajectory
from ..utils.tree import tree_map


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
    [N+1, n, B] and [N, m, B] with the first lane's time grid (the lanes
    share one: `BatchedALSolver` groups them so), and an AL state of
    `ConState` with a leading batch axis as the lane-major tuple of
    {lam [nk, p, B], rho [nk, B]}."""
    params_b = map_axes(lambda ax, leaf: _last(torch.as_tensor(leaf), ax), in_axes, params)
    al_b = None if al is None else tuple(dict(lam=_last(s.lam), rho=_last(s.rho)) for s in al)
    return params_b, to_batch_last(Z), al_b


# the stand-in logger of a silent `_InstanceStats`: the solver's row hooks
# run where its logger is not None
_SILENT = object()


class _InstanceStats(ALSolverBatched):
    """`ALSolverBatched` that also keeps what the per-instance solver's
    statistics need and the lane-major ones lack: the cost it logs.

    The per-instance solver logs `cost` only after a line search that
    succeeds (`altro_tpu/solver/ilqr.py:289-299`), so its cost stays at the
    last logged one, 0 before the first; the lane-major solver's is the
    cost each inner solve goes on from, which starts at the rollout's.
    The per-iteration history (`iteration_history_capacity`) holds every
    other column as the per-instance rows hold it, the violation and
    penalty seeded with their values before the solve.  This class records
    each lane's logged cost after each of its iterations, in the history's
    row, through the lane-major solver's per-iteration hooks
    (`_emit_inner_row`, run where it has a logger, after the iteration's
    one `forward_pass`, as `ALSolverBatched`'s docstring states; a silent
    solver gets a stand-in that prints nothing).  The record reads what the solve
    computes and feeds nothing back, and adds no host synchronisation, so
    the solve is the parent's, lane for lane bit for bit."""

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None):
        opts = opts or SolverOptions()
        super().__init__(prob, opts.replace(iteration_history_capacity=opts.stats_capacity))
        self._live = self._logger is not None  # live rows asked for by `verbose`
        if not self._live:
            self._logger = _SILENT
        self._success = None
        self.logged_cost = None  # [B]: the per-instance solver's `stats.cost`
        self.cost_rows = None  # [capacity, B]: `logged_cost` after each iteration

    def solve(self, params, Z, al=None, active=None, lane_opts=None):
        Bsz = Z.X.shape[-1]
        self.logged_cost = Z.X.new_zeros((Bsz,))
        self.cost_rows = Z.X.new_zeros((self.opts.iteration_history_capacity, Bsz))
        return super().solve(params, Z, al, active, lane_opts)

    def forward_pass(self, *args, **kwargs):
        fp = super().forward_pass(*args, **kwargs)
        self._success = fp["success"]
        return fp

    def _emit_inner_row(self, active, stats) -> None:
        self.logged_cost = torch.where(active & self._success, stats.cost, self.logged_cost)
        cap = self.cost_rows.shape[0]
        if cap:
            # the row `_record_history` wrote for this iteration
            row = torch.clamp(stats.iterations_total.long() - 1, 0, cap - 1)
            lane = torch.arange(row.shape[0], device=row.device)
            self.cost_rows[row, lane] = torch.where(active, self.logged_cost, self.cost_rows[row, lane])
        if self._live:
            super()._emit_inner_row(active, stats)

    def _emit_outer_row(self, active, status, stats) -> None:
        if self._live:
            super()._emit_outer_row(active, status, stats)


def instance_stats(st, logged_cost, cost_rows, capacity: int) -> SolverStats:
    """The per-instance solver's `SolverStats` with a leading batch axis,
    from the lane-major stats `st` (history capacity `capacity`) and the
    logged costs of `_InstanceStats`.  Per lane, with L = min(total
    iterations, capacity - 1) the row pointer: rows [0, L) hold the values
    after each iteration, row L the final values, the rows after it zeros
    (`altro_tpu/types.py:stats_log, stats_new_iteration`)."""
    final = dict(
        cost=logged_cost, alpha=st.alpha, improvement_ratio=st.improvement_ratio, gradient=st.gradient,
        cost_decrease=st.cost_decrease, regularization=st.regularization, violations=st.violations,
        max_penalty=st.max_penalty,
    )
    length = torch.clamp(st.iterations_total, max=capacity - 1).to(torch.int32)
    rows = st.rows.clone()  # [capacity, 8, B]
    if capacity:
        rows[:, _COLUMNS.index("cost")] = cost_rows
        i = torch.arange(capacity, device=rows.device)[:, None, None]
        last = torch.stack([final[name] for name in _COLUMNS])[None]  # [1, 8, B]
        L = length.long()[None, None, :]
        rows = torch.where(i < L, rows, torch.where(i == L, last, torch.zeros_like(rows)))
    return SolverStats(
        iterations_inner=st.iterations_inner, iterations_outer=st.iterations_outer,
        iterations_total=st.iterations_total, initial_cost=st.initial_cost,
        rows=torch.movedim(rows, -1, 0).contiguous(), length=length, **final,
    )


def instance_result(res: dict, stats: SolverStats, t: torch.Tensor, h: torch.Tensor) -> ALResult:
    """A lane-major result dict as the per-instance `ALResult` with a
    leading batch axis, with the per-instance `stats` and each lane's time
    grid t [B, N+1], h [B, N]."""
    Zb = res["Z"]
    Z = Trajectory(X=_first(Zb.X), U=_first(Zb.U), t=t, h=h)
    al = tuple(ConState(lam=_first(s["lam"]), rho=_first(s["rho"])) for s in res["al"])
    return ALResult(Z=Z, al=al, status=res["status"], stats=stats, K=_first(res["K"]), d=_first(res["d"]))


class BatchedALSolver:
    """AL-iLQR over a batch of problem instances, batch-leading
    (`altro_tpu.parallel.batch.BatchedALSolver`).

    ``in_axes`` selects which problem parameters vary across the batch
    (default: the initial state only).  The trajectory guess is always
    batched, its time grid too: lanes whose grids differ are solved in
    groups of equal grids, one lane-major solve each, and put back in
    order.  The solve runs `ALSolverBatched` with the caller's options
    (module docstring), so its statuses, iterations and trajectories are
    the per-instance solver's (`tests/test_batched.py:37-66` holds the two
    solvers to each other), and the `ALResult` has the JAX class's leaves:
    `stats.rows` with `stats_capacity` rows, the first holding the values
    before the solve, `stats.length` the per-instance row pointer,
    `stats.cost` the last cost logged (`_InstanceStats`), `Z.t` and `Z.h`
    each lane's own.  The one exception is three columns, in the rows and
    as leaves, that are ill-conditioned functions of the others and agree
    to each solver's order of operations only, as the gains `K`, `d` do:
    `cost_decrease`, a difference of two costs; `improvement_ratio`, that
    difference over the line search's prediction; and `gradient`, the
    feedforward gains' size, whose rounding grows with the penalty
    (`tests/test_torch_parallel.py::test_batched_al_solver_stats_match_jax`
    holds each to 1e-9 relative of what it is computed from).
    """

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None, in_axes: ProblemParams = None):
        self.solver = _InstanceStats(prob, opts)
        self.prob = prob
        self.in_axes = in_axes if in_axes is not None else params_axes(x0=0)

    def solve(self, params: ProblemParams, Z: Trajectory, al=None) -> ALResult:
        """Solve a batch.  `params` leaves selected by `in_axes` carry a
        leading batch dim; `Z` is batched; `al` optionally warm-starts
        (batched)."""
        B = Z.X.shape[0]
        Z = Z.replace(t=Z.t if Z.t.ndim == 2 else Z.t.expand(B, -1),
                      h=Z.h if Z.h.ndim == 2 else Z.h.expand(B, -1))
        _, group = torch.unique(torch.cat([Z.t, Z.h], dim=1), dim=0, return_inverse=True)
        groups = [torch.nonzero(group == g).flatten() for g in range(int(group.max()) + 1)]

        def lanes(idx):
            """The inputs of the lanes `idx`."""
            take = lambda leaf: leaf.index_select(0, idx)  # noqa: E731
            return (map_axes(lambda ax, leaf: torch.as_tensor(leaf).index_select(ax, idx), self.in_axes, params),
                    tree_map(take, Z), None if al is None else tree_map(take, al))

        parts = [self._solve(*lanes(idx)) for idx in groups]
        order = torch.argsort(torch.cat(groups))
        return tree_map(lambda *leaves: torch.cat(leaves).index_select(0, order), *parts)

    def _solve(self, params: ProblemParams, Z: Trajectory, al) -> ALResult:
        """One lane-major solve of lanes that share the time grid."""
        s = self.solver
        params_b, Zb, al_b = batch_last_inputs(self.in_axes, params, Z, al)
        res = s.solve(params_b, Zb, al_b)
        stats = instance_stats(res["stats"], s.logged_cost, s.cost_rows, s.opts.iteration_history_capacity)
        return instance_result(res, stats, Z.t, Z.h)

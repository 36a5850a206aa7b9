"""Core data types: trajectories, solver status, statistics.

Struct-of-arrays like the JAX package (`altro_tpu/types.py`): a trajectory
is stacked `X:[N+1,n], U:[N,m], t:[N+1], h:[N]` tensors.
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class SolverStatus(enum.IntEnum):
    """Solver termination codes, the same integers as `altro_tpu.types`."""

    SOLVED = 0
    UNSOLVED = 1
    STATE_LIMIT = 2
    CONTROL_LIMIT = 3
    COST_INCREASE = 4
    MAX_ITERATIONS = 5
    MAX_OUTER_ITERATIONS = 6
    MAX_INNER_ITERATIONS = 7
    MAX_PENALTY = 8
    BACKWARD_PASS_REGULARIZATION_FAILED = 9
    # the inner solve exited through the numerical-floor stall heuristic
    # (SolverOptions.max_stall_iterations); distinct from SOLVED
    SOLVED_STALLED = 10
    # the instance's constraints are provably unsatisfiable
    INFEASIBLE = 11


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """State/control trajectory with knot-point times.

    X: [N+1, n] states. U: [N, m] controls. t: [N+1] times. h: [N] steps.
    """

    X: torch.Tensor
    U: torch.Tensor
    t: torch.Tensor
    h: torch.Tensor

    @property
    def N(self) -> int:
        return self.U.shape[-2]

    @property
    def n(self) -> int:
        return self.X.shape[-1]

    @property
    def m(self) -> int:
        return self.U.shape[-1]

    def upad(self) -> torch.Tensor:
        """Controls padded with a zero terminal row -> [N+1, m]."""
        return torch.cat([self.U, self.U.new_zeros(self.U.shape[:-2] + (1, self.m))], dim=-2)

    def replace(self, **updates) -> "Trajectory":
        return dataclasses.replace(self, **updates)


def default_device(device: torch.device | str | None = None) -> torch.device:
    """`device`, or the card when none is given.  The port's entry points
    run on the card unless the caller asks for the CPU; without CUDA, asking
    for the default raises instead of quietly making CPU tensors."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def initial_trajectory(
    n: int,
    m: int,
    N: int,
    h: float,
    u0=None,
    x0=None,
    *,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str | None = None,
) -> Trajectory:
    """Uniform-step initial trajectory with constant controls
    (`altro_tpu.types.initial_trajectory`), on the card unless `device`
    says otherwise."""
    device = default_device(device)
    X = torch.zeros((N + 1, n), dtype=dtype, device=device)
    if x0 is not None:
        X = X + torch.as_tensor(x0, dtype=dtype, device=device)[None, :]
    U = torch.zeros((N, m), dtype=dtype, device=device)
    if u0 is not None:
        U = U + torch.as_tensor(u0, dtype=dtype, device=device)[None, :]
    t = torch.arange(N + 1, dtype=dtype, device=device) * h
    hs = torch.full((N,), h, dtype=dtype, device=device)
    return Trajectory(X=X, U=U, t=t, h=hs)


@dataclasses.dataclass(frozen=True)
class SolverStats:
    """Per-iteration statistics of the per-instance solver
    (`altro_tpu.types.SolverStats`, `altro/common/solver_stats.hpp:44-203`).

    Fixed-capacity rows with a row pointer replace the reference's growing
    vectors: `stats_log` writes the current row, `stats_new_iteration`
    advances the pointer and carries the row forward
    (`solver_stats.cpp:54-66`).  The iteration counters and the row
    pointer are host ints: the loops that advance them run on the host.
    The current-row values are 0-d tensors on the solve's device.
    """

    iterations_inner: int
    iterations_outer: int
    iterations_total: int
    initial_cost: torch.Tensor
    cost: torch.Tensor
    alpha: torch.Tensor
    improvement_ratio: torch.Tensor
    gradient: torch.Tensor
    cost_decrease: torch.Tensor
    regularization: torch.Tensor
    violations: torch.Tensor
    max_penalty: torch.Tensor
    rows: torch.Tensor  # [capacity, 8] in _COLUMNS order
    length: int

    def replace(self, **updates) -> "SolverStats":
        return dataclasses.replace(self, **updates)


_COLUMNS = (
    "cost",
    "alpha",
    "improvement_ratio",
    "gradient",
    "cost_decrease",
    "regularization",
    "violations",
    "max_penalty",
)


def stats_init(capacity: int, dtype: torch.dtype = torch.float64, device=None) -> SolverStats:
    z = torch.zeros((), dtype=dtype, device=device)
    return SolverStats(
        iterations_inner=0, iterations_outer=0, iterations_total=0,
        initial_cost=z, cost=z, alpha=z, improvement_ratio=z, gradient=z,
        cost_decrease=z, regularization=z, violations=z, max_penalty=z,
        rows=torch.zeros((capacity, len(_COLUMNS)), dtype=dtype, device=device),
        length=0,
    )


def stats_log(stats: SolverStats, **values) -> SolverStats:
    """Log values into the current row (overwrites, like `SolverStats::Log`).
    The rows are written in place: a solve owns its stats' buffer."""
    like = stats.rows
    cur = {name: getattr(stats, name) for name in _COLUMNS}
    cur.update({k: torch.as_tensor(v, dtype=like.dtype, device=like.device) for k, v in values.items()})
    like[stats.length] = torch.stack([cur[name] for name in _COLUMNS])
    return stats.replace(**{k: cur[k] for k in values})


def stats_new_iteration(stats: SolverStats) -> SolverStats:
    """Advance the row pointer; the current values carry forward
    (`solver_stats.cpp:54-66`)."""
    length = min(stats.length + 1, stats.rows.shape[0] - 1)
    stats.rows[length] = torch.stack([getattr(stats, name) for name in _COLUMNS])
    return stats.replace(length=length)


def stats_column(stats: SolverStats, name: str) -> torch.Tensor:
    """Full history column for `name` (valid up to `stats.length`)."""
    return stats.rows[:, _COLUMNS.index(name)]

"""Core data types: trajectories and solver status.

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

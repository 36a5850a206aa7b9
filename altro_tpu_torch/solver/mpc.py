"""Receding-horizon MPC on the AL-iLQR solvers (`altro_tpu/solver/mpc.py`).

The reference's MPC workflow is warm starting: the solution is the next
initial guess (`altro/ilqr/ilqr.hpp:222-235`) and the duals carry over
unless reset (`al_solver.hpp:288-302`, `solver_options.hpp:47-48`); its
benchmark re-solves in a loop (`perf/benchmark_unicycle.cpp:45-75`).  Here
that state is explicit: `MPCState = (Z, al, status, iterations)` goes
through `step()`.  `MPC` controls one vehicle with the per-instance
`ALSolver`; `BatchedMPC` a fleet with the batch-last `ALSolverBatched`,
whose passes are the fused CUDA kernels when the options select them.

`rollout_ticks` closes the loop over several ticks with a plant function,
a host loop of `step` calls whose histories stay on the device; it adds no
host synchronisation to the solver's own.  (The JAX package chains the
ticks into one device program instead; here that is work for a
device-side loop.)  Each controller's `host_syncs` counts the
synchronisations of its last `step` or `rollout_ticks`.  A `step` is the
tracer's span `mpc.step` (`utils/timer.py`), its warm start's shift
`mpc.shift`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..options import SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import SolverStatus, Trajectory
from ..utils.timer import host_reads, root_span, span
from .al import ALSolver


@dataclasses.dataclass(frozen=True)
class MPCState:
    Z: Any  # Trajectory, or a BatchedTrajectory for BatchedMPC
    al: tuple
    status: torch.Tensor
    iterations: Any  # total iterations of the last solve: an int, or [B] for BatchedMPC

    def replace(self, **updates) -> "MPCState":
        return dataclasses.replace(self, **updates)


def _warm_options(opts: Optional[SolverOptions]) -> SolverOptions:
    """The controllers keep the duals across re-solves (`reset_duals=False`)
    and restart the penalties at `initial_penalty`, as the reference does
    with `reset_duals=false` (`al_solver.hpp:288-302`)."""
    opts = opts or SolverOptions()
    return opts.replace(reset_duals=False) if opts.reset_duals else opts


class _Controller:
    """`rollout_ticks` and the sync count of both controllers."""

    def rollout_ticks(self, state: MPCState, x0, plant_fn, n_ticks: int):
        """`n_ticks` warm-started ticks with `plant_fn(x, u) -> x_next`, the
        simulated vehicle, closing the loop.  Returns `(final_state,
        x_final, X_hist, U_hist)`, the histories with a leading tick axis
        (the plant's states after each tick, the controls applied)."""
        x = torch.as_tensor(x0)
        Xs, Us = [], []
        syncs = 0
        for _ in range(int(n_ticks)):
            u0, state = self.step(state, x)
            syncs += self.host_syncs
            x = plant_fn(x, u0)
            Xs.append(x)
            Us.append(u0)
        self.host_syncs = syncs
        return state, x, torch.stack(Xs), torch.stack(Us)


class MPC(_Controller):
    """Warm-started receding-horizon controller of one vehicle.

    `shift=True` advances the warm-start guess one knot each step (receding
    horizon); `shift=False` re-solves the same horizon (the reference
    benchmark's behaviour)."""

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None, shift: bool = True):
        self.opts = _warm_options(opts)
        self.prob = prob
        self.solver = ALSolver(prob, self.opts)
        self.shift = shift
        self.host_syncs = 0

    def init(self, Z0: Trajectory) -> MPCState:
        return MPCState(
            Z=Z0,
            al=self.solver.init_al_state(Z0.X.dtype, Z0.X.device),
            status=torch.full((), int(SolverStatus.UNSOLVED), dtype=torch.int32, device=Z0.X.device),
            iterations=0,
        )

    def step(self, state: MPCState, x0, params: Optional[ProblemParams] = None):
        """Re-solve from the measured state `x0` [n]; returns (u0, new_state).
        `params` may replace other problem data (moving references,
        obstacles) with the same structure."""
        with root_span("mpc.step"):
            params = (params or self.prob.params).replace(x0=torch.as_tensor(x0))
            res = self.solver.solve(params, state.Z, state.al)
            self.host_syncs = self.solver.host_syncs
            with span("mpc.shift"):
                Zwarm = _shift_trajectory(res.Z) if self.shift else res.Z
            new_state = MPCState(Z=Zwarm, al=res.al, status=res.status, iterations=res.stats.iterations_total)
            return res.Z.U[..., 0, :], new_state


def _shift_trajectory(Z: Trajectory) -> Trajectory:
    """Advance the warm-start guess one knot: the controls shift left and
    the last one repeats, the states likewise (the solver rolls the states
    out from x0 anyway, `ilqr.hpp:453-459`)."""
    U = torch.cat([Z.U[..., 1:, :], Z.U[..., -1:, :]], dim=-2)
    X = torch.cat([Z.X[..., 1:, :], Z.X[..., -1:, :]], dim=-2)
    return Z.replace(X=X, U=U)


class BatchedMPC(_Controller):
    """Warm-started receding-horizon control of a fleet: one lockstep
    `ALSolverBatched` solve per tick, each instance warm-started from its
    own previous trajectory and duals (the batched analog of the reference's
    re-solve loop, `perf/benchmark_unicycle.cpp:45-75`).  The options'
    `backward_pass` and `forward_pass` pass through: "fused" and "cuda" run
    every tick on the fused CUDA kernels.

    States and controls are batch-last: `x0` is [n, B] and `step` returns
    u0 [m, B].  For real-time use cap the work per tick with
    `SolverOptions(max_iterations_total=K)`: the fleet steps in lockstep, so
    one instance that never converges would otherwise hold the whole fleet
    at the full cap every tick.  A capped instance reports MAX_ITERATIONS
    that tick and improves across ticks through the warm start (real-time
    iteration practice)."""

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None, shift: bool = True):
        from .batched import ALSolverBatched

        self.opts = _warm_options(opts)
        self.prob = prob
        self.solver = ALSolverBatched(prob, self.opts)
        self.shift = shift
        self.host_syncs = 0

    def init(self, Zb) -> MPCState:
        """`Zb`: the batch-last initial guess (`to_batch_last`)."""
        B = Zb.X.shape[-1]
        dev = Zb.X.device
        return MPCState(
            Z=Zb,
            al=self.solver.al_state_init(B, Zb.X.dtype, dev),
            status=torch.full((B,), int(SolverStatus.UNSOLVED), dtype=torch.int32, device=dev),
            iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        )

    def step(self, state: MPCState, x0, params: Optional[ProblemParams] = None):
        """Re-solve the whole fleet from the measured states `x0` [n, B];
        returns (u0 [m, B], new_state)."""
        reads = host_reads()
        with root_span("mpc.step"):
            params = (params or self.prob.params).replace(x0=torch.as_tensor(x0))
            res = self.solver.solve(params, state.Z, state.al)
            Zsol = res["Z"]
            with span("mpc.shift"):
                Zwarm = _shift_batch_last(Zsol) if self.shift else Zsol
            new_state = MPCState(Z=Zwarm, al=res["al"], status=res["status"],
                                 iterations=res["stats"].iterations_total)
        self.host_syncs = host_reads() - reads
        return Zsol.U[0], new_state


def _shift_batch_last(Z):
    """`_shift_trajectory` for the batch-last layout ([N, dim, B]: time is
    the leading axis)."""
    U = torch.cat([Z.U[1:], Z.U[-1:]], dim=0)
    X = torch.cat([Z.X[1:], Z.X[-1:]], dim=0)
    return Z.replace(X=X, U=U)

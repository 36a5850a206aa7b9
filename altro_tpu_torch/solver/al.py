"""Augmented-Lagrangian outer loop of the per-instance solver
(`altro_tpu/solver/al.py`, the analog of `AugmentedLagrangianiLQR<n,m>`,
`altro/augmented_lagrangian/al_solver.hpp:28-443`): solve the penalized
problem with the inner iLQR, update the duals, test convergence, scale the
penalties.  The dual and penalty state is an explicit value (`ALState`),
so a warm start, the reference's MPC workflow (`al_solver.hpp:288-302`),
passes the previous state back in.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..options import LogLevel, SolverOptions
from ..problem.constraints import cone_violation
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import SolverStats, SolverStatus, Trajectory, stats_init, stats_log
from .functions import ALState, ProblemFunctions
from .ilqr import ILQRSolver, _status


@dataclasses.dataclass(frozen=True)
class ALResult:
    Z: Trajectory
    al: tuple
    status: torch.Tensor
    stats: SolverStats
    K: torch.Tensor
    d: torch.Tensor

    def replace(self, **updates) -> "ALResult":
        return dataclasses.replace(self, **updates)


class ALSolver:
    """AL-iLQR solver over a compiled problem.  `host_syncs` counts the
    host synchronisations of the last solve: the inner solves', one per
    outer iteration, and one per printed row or status line."""

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None):
        self.prob = prob
        self.opts = opts or SolverOptions()
        self.ilqr = ILQRSolver(prob, self.opts)
        self.fns: ProblemFunctions = self.ilqr.fns
        # the phase profile of the last solve (`GetTimer()`,
        # `solver_stats.hpp:105`), active with `profiler_enable`, and the
        # live rows: the inner solver's own, so its phases nest under "al"
        self.timer = self.ilqr.timer
        self.logger = self.ilqr.logger
        self.host_syncs = 0

    def init_al_state(self, dtype=torch.float64, device=None) -> ALState:
        return self.fns.al_state_init(dtype, device)

    def _start(self, params, Z, al):
        """The AL state a solve starts from and its stats with the pre-solve
        violation and penalty logged (`al_solver.hpp:288-302`)."""
        opts, fns = self.opts, self.fns
        dt, dev = Z.X.dtype, Z.X.device
        if al is None:
            al = fns.al_state_init(dt, dev)
        if opts.reset_duals:
            al = fns.reset_duals(al)
        if opts.initial_penalty > 0:
            al = fns.set_penalty(al, opts.initial_penalty)
        stats = stats_init(opts.stats_capacity, dt, dev)
        cvals0 = fns.constraint_values(params, Z)
        zero = torch.zeros((), dtype=dt, device=dev)
        stats = stats_log(
            stats,
            violations=fns.max_violation(cvals0) if cvals0 else zero,
            max_penalty=fns.max_penalty(al).to(dt) if al else zero,
        )
        return al, stats

    def solve(self, params: ProblemParams, Z: Trajectory, al: ALState = None) -> ALResult:
        """Full constrained solve (`al_solver.hpp:305-334`).

        `al` warm-starts the duals and penalties; the options `reset_duals`
        and `initial_penalty` set how much carries over
        (`al_solver.hpp:288-302`).  `profiler_enable` times the phases in
        `timer` (`al_solver.hpp:307-309`) and `verbose` prints the
        iteration rows and the final status; neither changes the result."""
        opts, fns, timer, logger = self.opts, self.fns, self.timer, self.logger
        self.host_syncs = 0
        timer.reset()
        timer.device = Z.X.device
        logger.reset()
        with timer.trace_context("al"):
            with timer.trace_context("init", block=True):
                al, stats = self._start(params, Z, al)

            if not self.prob.constraint_families:
                # unconstrained: a single inner solve, like a plain iLQR
                res = self.ilqr.solve(params, (), Z, stats)
                self.host_syncs += self.ilqr.host_syncs
                result = ALResult(Z=res.Z, al=(), status=res.status, stats=res.stats, K=res.K, d=res.d)
            else:
                result = self._outer_loop(params, Z, al, stats)
        self._finish(result.status)
        return result

    def _outer_loop(self, params, Z, al, stats) -> ALResult:
        opts, fns, timer = self.opts, self.fns, self.timer
        while True:
            res = self.ilqr.solve(params, al, Z, stats)
            self.host_syncs += self.ilqr.host_syncs
            Z, stats = res.Z, res.stats
            with timer.trace_context("dual_update", block=True):
                # the dual update on the accepted trajectory (`al_solver.hpp:337-345`)
                cvals = fns.constraint_values(params, Z)
                al_new = fns.update_duals(al, cvals)
                viol = fns.max_violation(cvals)
                pen = fns.max_penalty(al_new).to(Z.X.dtype)
                stats = stats.replace(iterations_outer=stats.iterations_outer + 1)
                stats = stats_log(stats, violations=viol, max_penalty=pen)
            if self.logger.level >= LogLevel.OUTER:
                self._print_row(stats)

            with timer.trace_context("convergence_check"):
                # IsDone (`al_solver.hpp:369-401`).  A stall-exited inner
                # solve (SOLVED_STALLED) continues the outer loop like a
                # solved one, but a solve that ends feasible on it reports
                # SOLVED_STALLED
                inner_solved = res.status == int(SolverStatus.SOLVED)
                inner_ok = inner_solved | (res.status == int(SolverStatus.SOLVED_STALLED))
                sat = viol < opts.constraint_tolerance
                pen_hi = pen > opts.maximum_penalty
                outer_hi = stats.iterations_outer >= opts.max_iterations_outer
                total_hi = stats.iterations_total >= opts.max_iterations_total
                cap = (SolverStatus.MAX_OUTER_ITERATIONS if outer_hi
                       else SolverStatus.MAX_ITERATIONS if total_hi else SolverStatus.UNSOLVED)
                status = torch.where(
                    ~inner_ok, res.status,
                    torch.where(
                        sat,
                        torch.where(inner_solved, _status(SolverStatus.SOLVED, Z.X),
                                    _status(SolverStatus.SOLVED_STALLED, Z.X)),
                        torch.where(pen_hi, _status(SolverStatus.MAX_PENALTY, Z.X), _status(cap, Z.X)),
                    ),
                )
                done = outer_hi or total_hi
                if not done:
                    self.host_syncs += 1
                    done = bool(~inner_ok | sat | pen_hi)
            with timer.trace_context("penalty_update"):
                # penalties scale only when the loop goes on (`al_solver.hpp:324-332`)
                al = al_new if done else fns.update_penalties(al_new)
            if done:
                return ALResult(Z=Z, al=al, status=status, stats=stats, K=res.K, d=res.d)

    def _print_row(self, stats) -> None:
        """One outer-iteration row (`al_solver.hpp:318-331`), one read."""
        self.host_syncs += 1
        cost, viol, pen = torch.stack([stats.cost, stats.violations, stats.max_penalty]).tolist()
        log = self.logger.log
        log("iters", stats.iterations_total)
        log("iter_al", stats.iterations_outer)
        log("cost", cost)
        log("viol", viol)
        log("pen", pen)
        self.logger.print_row()

    def _finish(self, status) -> None:
        """The final status line and the profile, as the options ask
        (`al_solver.hpp:307-309`, `solver_stats.cpp:68-78`)."""
        opts = self.opts
        if self.logger.level > LogLevel.SILENT:
            self.host_syncs += 1
            print(f"status: {SolverStatus(int(status)).name}")
        if not opts.profiler_enable:
            return
        if opts.profiler_output_to_file:
            directory = opts.log_directory or "."
            os.makedirs(directory, exist_ok=True)
            with open(os.path.join(directory, opts.profile_filename), "w") as f:
                self.timer.print_summary(file=f)
        else:
            self.timer.print_summary()

    # pieces that mirror the reference's public methods
    def max_violation(self, params, Z):
        """`AugmentedLagrangianiLQR::MaxViolation` (`al_solver.hpp:405-408`)."""
        return self.fns.max_violation(self.fns.constraint_values(params, Z))

    def num_constraints(self, k=None) -> int:
        """Constraint rows at knot k, or in total (`al_solver.hpp:252-269`)."""
        fams = self.prob.constraint_families
        if k is None:
            return sum(f.dim * len(f.knots) for f in fams)
        return sum(f.dim for f in fams if k in f.knots)

    def constraint_info(self, params, Z, sort: bool = False):
        """Violation of every (constraint, knot) pair
        (`AugmentedLagrangianiLQR::GetConstraintInfo`, `al_solver.hpp:86-104`):
        dicts {label, knot, violation (numpy array), cone}, by knot or, with
        `sort`, largest violation first."""
        cvals = self.fns.constraint_values(params, Z)
        info = []
        for fam, c in zip(self.prob.constraint_families, cvals):
            v = cone_violation(fam.cone, c).detach().cpu().numpy()
            for i, k in enumerate(fam.knots):
                info.append({"label": fam.label, "knot": int(k), "violation": v[i], "cone": fam.cone.name})
        if sort:
            info.sort(key=lambda e: -float(e["violation"].max(initial=0.0)))
        else:
            info.sort(key=lambda e: e["knot"])
        return info

    def print_violations(self, params, Z, sort: bool = False, precision: int = 4):
        """`AugmentedLagrangianiLQR::PrintViolations` (`al_solver.hpp:68-74`)."""
        info = self.constraint_info(params, Z, sort=sort)
        print(f"Got {len(info)} constraints")
        for e in info:
            with np.printoptions(precision=precision):
                print(f"{e['label']} [{e['cone']}] @ knot {e['knot']}: {e['violation']}")

    def update_duals(self, params, Z, al):
        return self.fns.update_duals(al, self.fns.constraint_values(params, Z))

    def update_penalties(self, al):
        return self.fns.update_penalties(al)

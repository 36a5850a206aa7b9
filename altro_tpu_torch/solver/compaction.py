"""Straggler compaction for the batch-native AL-iLQR solver
(`altro_tpu/solver/compaction.py`, its device-side tail).

A lockstep batched solve runs until its slowest instance converges.
`CompactedALSolver` runs the full batch for a capped iteration budget, then
gathers the unconverged lanes (a stable argsort puts them first) into a
dense `tail_batch`-wide batch (every per-instance param leaf gathered with
them, `gather_params`), solves only those with `active` marking the real
ones, and scatters the results back — round after round until every
lane has had one uncapped tail solve.  Phase boundaries restart the inner
solver while duals and penalties carry over (`al_solver.hpp:288-302`).
Then an optional restart portfolio re-solves the lanes still not SOLVED
from scratch, under a cascade of penalty-ladder variants.

The f64 polish and the infeasibility certificates of the JAX package are
not ported yet.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..options import SolverOptions
from ..problem.problem import CompiledProblem
from ..types import SolverStatus
from .batched import ALSolverBatched, BatchedTrajectory, gather_params

# statuses that mean "ran out of a phase budget, still making progress";
# after an uncapped tail round they are terminal (`al_solver.hpp:378-381`)
_RESUMABLE = (
    SolverStatus.MAX_ITERATIONS,
    SolverStatus.MAX_INNER_ITERATIONS,
    SolverStatus.MAX_OUTER_ITERATIONS,
    SolverStatus.UNSOLVED,
)


class CompactedALSolver:
    """Capped full-batch phase, then compacted tail rounds.

    Parameters
    ----------
    phase1_iters : total-iteration cap of the full-batch phase.
    tail_batch : lane width of each tail round.
    finish_stalled : tail rounds run with `stalled_feasible_exits=False`
        and treat SOLVED_STALLED as resumable, so feasible-but-stalled
        instances keep escalating the penalty until they converge.
    restart_portfolio : after the tail rounds, re-solve the lanes not
        SOLVED from the original initial guess with fresh duals, under each
        variant in turn, each on the lanes every earlier variant failed
        (`altro_tpu/solver/compaction.py:291-373`).  A variant is a dict of
        any of `penalty_scaling`, `initial_penalty`, `max_iterations_outer`,
        `max_iterations_total`; only lanes it SOLVES are merged.
    restart_width : lanes per variant's solve (0: `tail_batch`).
    restart_rounds : passes over the variants.

    After each `solve`, `host_syncs` holds the solve's host
    synchronisations and `telemetry` the iteration distribution, the
    lanes each restart variant took and the host syncs of the cascade.
    """

    def __init__(
        self,
        prob: CompiledProblem,
        opts: SolverOptions = None,
        *,
        phase1_iters: int = 20,
        tail_batch: int = 1024,
        finish_stalled: bool = True,
        restart_portfolio: tuple = (),
        restart_width: int = 0,
        restart_rounds: int = 1,
    ):
        if tail_batch <= 0:
            raise ValueError("tail_batch must be positive")
        self.prob = prob
        self.opts = opts or SolverOptions()
        self.phase1_iters = int(phase1_iters)
        self.tail_batch = int(tail_batch)
        self.finish_stalled = bool(finish_stalled)
        self.restart_portfolio = tuple(restart_portfolio)
        self.restart_width = int(restart_width)
        self.restart_rounds = int(restart_rounds)
        # phases never update duals from a capped (unconverged) inner solve
        p1_opts = self.opts.replace(
            max_iterations_total=min(self.phase1_iters, self.opts.max_iterations_total),
            update_duals_on_failed_inner=False,
        )
        # tail rounds resume the AL state: keep duals, keep penalties
        tail_opts = self.opts.replace(
            reset_duals=False, initial_penalty=0.0, update_duals_on_failed_inner=False,
        )
        if self.finish_stalled:
            tail_opts = tail_opts.replace(stalled_feasible_exits=False)
        self._p1 = ALSolverBatched(prob, p1_opts)
        self._tail = ALSolverBatched(prob, tail_opts)
        codes = [int(s) for s in _RESUMABLE]
        if self.finish_stalled:
            codes.append(int(SolverStatus.SOLVED_STALLED))
        self._codes = torch.as_tensor(codes, dtype=torch.int32, device=self._p1.device)
        # the restart solver: each variant's duals and penalties come in
        # through its `al` argument, so the solver leaves them as given
        self._restart = None
        if self.restart_portfolio:
            self._restart = ALSolverBatched(prob, self.opts.replace(
                reset_duals=False, initial_penalty=0.0, update_duals_on_failed_inner=False,
            ))
        self.host_syncs = 0
        self.telemetry: dict = {}

    @staticmethod
    def _merge(res, sub, idx, real):
        """Scatter a tail round's results back into the full-batch result,
        masked to the real (gathered unconverged) lanes."""

        def sel(old, new):
            out = old.clone()
            out[..., idx] = torch.where(real, new, old[..., idx])
            return out

        res = dict(res)
        res["Z"] = res["Z"].replace(X=sel(res["Z"].X, sub["Z"].X), U=sel(res["Z"].U, sub["Z"].U))
        res["al"] = tuple(
            dict(lam=sel(o["lam"], s["lam"]), rho=sel(o["rho"], s["rho"]))
            for o, s in zip(res["al"], sub["al"])
        )
        res["K"] = sel(res["K"], sub["K"])
        res["d"] = sel(res["d"], sub["d"])
        res["status"] = sel(res["status"], sub["status"])
        st, su = res["stats"], sub["stats"]

        def add(old, new):
            out = old.clone()
            out[idx] += new * real.to(new.dtype)
            return out

        res["stats"] = st.replace(
            iterations_inner=sel(st.iterations_inner, su.iterations_inner),
            iterations_outer=add(st.iterations_outer, su.iterations_outer),
            iterations_total=add(st.iterations_total, su.iterations_total),
            **{
                name: sel(getattr(st, name), getattr(su, name))
                for name in (
                    "cost", "cost_decrease", "gradient", "alpha", "improvement_ratio",
                    "violations", "max_penalty", "regularization",
                )
            },
        )
        return res

    def _portfolio(self, params, Z0: BatchedTrajectory, res):
        """The fresh-restart cascade over `res`, the tail rounds' result:
        per variant, the (at most `restart_width`) lanes not SOLVED, from
        their original initial guess `Z0` with zero duals and the variant's
        initial penalty, under its per-lane options; lanes that come back
        SOLVED are merged.  Returns (res, the real lanes each variant took,
        host syncs): one per variant (its lane count, which also ends the
        cascade once no lane is left), plus its solve's."""
        opts = self.opts
        dt, dev = Z0.X.dtype, Z0.X.device
        R = self.restart_width or self.tail_batch
        solved = int(SolverStatus.SOLVED)
        lanes, syncs = [], 0
        for _ in range(self.restart_rounds):
            for variant in self.restart_portfolio:
                undone = res["status"] != solved
                order = torch.argsort((~undone).to(torch.int8), stable=True)
                idx = order[:R]
                real = undone[idx]
                count = int(real.sum())
                syncs += 1
                if count == 0:
                    return res, lanes, syncs
                lanes.append(count)
                W = idx.shape[0]
                lane_opts = dict(
                    penalty_scaling=torch.full(
                        (W,), variant.get("penalty_scaling", opts.penalty_scaling), dtype=dt, device=dev),
                    max_iterations_outer=torch.full(
                        (W,), variant.get("max_iterations_outer", opts.max_iterations_outer),
                        dtype=torch.int32, device=dev),
                    max_iterations_total=torch.full(
                        (W,), variant.get("max_iterations_total", opts.max_iterations_total),
                        dtype=torch.int32, device=dev),
                )
                rho0 = variant.get("initial_penalty", opts.initial_penalty)
                al_r = tuple(
                    dict(lam=torch.zeros((len(f.knots), f.dim, W), dtype=dt, device=dev),
                         rho=torch.full((len(f.knots), W), rho0, dtype=dt, device=dev))
                    for f in self.prob.constraint_families
                )
                params_r = gather_params(self.prob.params, params, idx)
                # from the original initial guess, not the failed trajectory
                Z_r = Z0.replace(X=Z0.X[..., idx], U=Z0.U[..., idx])
                sub = self._restart.solve(params_r, Z_r, al_r, active=real, lane_opts=lane_opts)
                syncs += self._restart.host_syncs
                res = self._merge(res, sub, idx, real & (sub["status"] == solved))
        return res, lanes, syncs

    def solve(self, params, Z: BatchedTrajectory, al=None):
        """Same contract as `ALSolverBatched.solve` (batch-last dict)."""
        t0 = time.perf_counter()
        res = self._p1.solve(params, Z, al)
        syncs = self._p1.host_syncs
        B = Z.X.shape[-1]
        K_t = self.tail_batch
        tried = torch.zeros((B,), dtype=torch.bool, device=Z.X.device)
        rounds = 0
        # enough rounds to cover every lane; a lane that ran an uncapped
        # tail round is terminal.  Once a round gathers no unconverged lane
        # no later round can, so the loop stops there.
        for _ in range(-(-B // K_t)):
            undone = torch.isin(res["status"], self._codes) & ~tried
            order = torch.argsort((~undone).to(torch.int8), stable=True)
            idx = order[:K_t]
            real = undone[idx]
            syncs += 1
            if not bool(real.any()):
                break
            rounds += 1
            params_t = gather_params(self.prob.params, params, idx)
            Z_t = res["Z"].replace(X=res["Z"].X[..., idx], U=res["Z"].U[..., idx])
            al_t = tuple(dict(lam=s["lam"][..., idx], rho=s["rho"][..., idx]) for s in res["al"])
            sub = self._tail.solve(params_t, Z_t, al_t, active=real)
            syncs += self._tail.host_syncs
            res = self._merge(res, sub, idx, real)
            tried[idx] |= real
        restart_lanes, restart_syncs = [], 0
        if self._restart is not None:
            res, restart_lanes, restart_syncs = self._portfolio(params, Z, res)
            syncs += restart_syncs
        self.host_syncs = syncs
        it = res["stats"].iterations_total.cpu().numpy()
        self.telemetry = dict(
            tail_rounds=rounds,
            restart_lanes=restart_lanes,
            restart_host_syncs=restart_syncs,
            iters_p50=float(np.percentile(it, 50)),
            iters_p99=float(np.percentile(it, 99)),
            iters_max=int(it.max()),
            total_s=time.perf_counter() - t0,
        )
        return res

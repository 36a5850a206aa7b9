"""Straggler compaction for the batch-native AL-iLQR solver
(`altro_tpu/solver/compaction.py`, its device-side tail).

A lockstep batched solve runs until its slowest instance converges.
`CompactedALSolver` runs the full batch for a capped iteration budget, then
gathers the unconverged lanes (a stable argsort puts them first) into a
dense `tail_batch`-wide batch, solves only those with `active` marking the
real ones, and scatters the results back — round after round until every
lane has had one uncapped tail solve.  Phase boundaries restart the inner
solver while duals and penalties carry over (`al_solver.hpp:288-302`).

The f64 polish, the restart portfolio and the infeasibility certificates of
the JAX package are not ported yet.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..options import SolverOptions
from ..problem.problem import CompiledProblem
from ..types import SolverStatus
from .batched import ALSolverBatched, BatchedTrajectory

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

    After each `solve`, `host_syncs` holds the solve's host
    synchronisations and `telemetry` the iteration distribution.
    """

    def __init__(
        self,
        prob: CompiledProblem,
        opts: SolverOptions = None,
        *,
        phase1_iters: int = 20,
        tail_batch: int = 1024,
        finish_stalled: bool = True,
    ):
        if tail_batch <= 0:
            raise ValueError("tail_batch must be positive")
        self.prob = prob
        self.opts = opts or SolverOptions()
        self.phase1_iters = int(phase1_iters)
        self.tail_batch = int(tail_batch)
        self.finish_stalled = bool(finish_stalled)
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
            x0 = params.x0
            params_t = params.replace(x0=x0[:, idx]) if x0.ndim == 2 else params
            Z_t = res["Z"].replace(X=res["Z"].X[..., idx], U=res["Z"].U[..., idx])
            al_t = tuple(dict(lam=s["lam"][..., idx], rho=s["rho"][..., idx]) for s in res["al"])
            sub = self._tail.solve(params_t, Z_t, al_t, active=real)
            syncs += self._tail.host_syncs
            res = self._merge(res, sub, idx, real)
            tried[idx] |= real
        self.host_syncs = syncs
        it = res["stats"].iterations_total.cpu().numpy()
        self.telemetry = dict(
            tail_rounds=rounds,
            iters_p50=float(np.percentile(it, 50)),
            iters_p99=float(np.percentile(it, 99)),
            iters_max=int(it.max()),
            total_s=time.perf_counter() - t0,
        )
        return res

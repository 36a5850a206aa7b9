"""Straggler compaction for the batch-native AL-iLQR solver
(`altro_tpu/solver/compaction.py`).

A lockstep batched solve runs until its slowest instance converges.
`CompactedALSolver` runs the full batch for a capped iteration budget, then
solves only the unconverged lanes (every per-instance param leaf gathered
with them, `gather_params`) and scatters the results back.  Phase
boundaries restart the inner solver while duals and penalties carry over
(`al_solver.hpp:288-302`).  The tail runs one of two ways, as in the JAX
package:
  * `device_tail=True`, the JAX package's single-dispatch program: rounds
    that gather the unconverged lanes (a stable argsort puts them first)
    into a dense `tail_batch`-wide batch, solve it with `active` marking
    the real ones, and merge — until every lane has had one uncapped tail
    solve, or `device_tail_rounds` rounds.  Then an optional restart
    portfolio re-solves the lanes still not SOLVED from scratch under a
    cascade of penalty-ladder variants, and optional infeasibility
    certificates keep provably infeasible lanes out of every solve.
  * `device_tail=False` (the default), the host-driven rounds: each round
    solves every unconverged lane in `tail_batch`-wide chunks; with
    `tail_iters > 0` each tail solve is capped and the lanes it leaves
    unconverged re-enter the next round, up to `max_tail_rounds`.
After either, an optional float64 polish re-solves the lanes still
unconverged.

With `tail_iters == 0` each unconverged lane gets exactly one uncapped tail
solve from its phase-1 state on both paths, and a lane's solve does not
depend on the other lanes of its batch, so the two paths give every lane
the same status, iterations and U.

Where the JAX package differs, and why:
  * The host path runs on the host in both packages; the device path does
    too here (the port has no one-dispatch program yet), with the JAX
    program's semantics: a `tried` mask, argsort gathers, `active` masks.
  * The f64 polish's passes.  The JAX package forces the scan passes in the
    polish, because the TPU's Pallas kernels do not run in float64.  The
    port's fused kernels have float64 instantiations, while its scan passes
    are eager PyTorch ops that are slow on the card, so the polish keeps
    the passes the caller chose: with `backward_pass="fused"` and
    `forward_pass="cuda"` it runs the kernels' float64 instantiations
    (shared-param or lane-params, as phase 1 does), with "scan" the eager
    passes.  A problem the kernels refuse in float64 takes the same
    fallback as in phase 1 (`Ineligible`).
  * The chunks of the host path's tail rounds and of the polish.  The
    port's kernels take any batch width, so the last chunk is not padded
    with copies of its first lane; each lane's result does not depend on
    the others, so the merged result is the same.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..options import SolverOptions
from ..problem.infeasibility import goal_obstacle_certificates
from ..problem.problem import CompiledProblem
from ..types import SolverStatus
from ..utils.timer import (
    FINAL_READBACK, host_read, host_reads, ls_block_tries, ls_tries, root_span, search_counts, span,
)
from .batched import ALSolverBatched, BatchedTrajectory, gather_params

# statuses that mean "ran out of a phase budget, still making progress";
# after an uncapped tail round they are terminal (`al_solver.hpp:378-381`)
_RESUMABLE = (
    SolverStatus.MAX_ITERATIONS,
    SolverStatus.MAX_INNER_ITERATIONS,
    SolverStatus.MAX_OUTER_ITERATIONS,
    SolverStatus.UNSOLVED,
)
# the polish's hard failures; stage 0 takes SOLVED_STALLED as well
_HARD = tuple(int(s) for s in _RESUMABLE) + (int(SolverStatus.MAX_PENALTY),)
# stage 1 retries the hard failures left after stage 0 under a gentler x4
# penalty ladder; it leaves stalled-feasible results to stage 0's x10 ladder
_POLISH_STAGES = (
    (_HARD + (int(SolverStatus.SOLVED_STALLED),), {}),
    (_HARD, dict(penalty_scaling=4.0, max_iterations_outer=60, max_iterations_total=900)),
)


class CompactedALSolver:
    """Capped full-batch phase, then compacted tail rounds.

    Parameters (the JAX package's keywords and defaults)
    ----------
    phase1_iters : total-iteration cap of the full-batch phase.
    tail_batch : lane width of each tail round (of each chunk on the host
        path).
    tail_iters : host path: total-iteration cap of each tail solve (0:
        uncapped).  Capped lanes that end unconverged re-enter the next
        round.  The device path takes only 0.
    max_tail_rounds : host path: rounds before the last status stands.
    finish_stalled : tail rounds run with `stalled_feasible_exits=False`
        and treat SOLVED_STALLED as resumable, so feasible-but-stalled
        instances keep escalating the penalty until they converge.
    f64_polish : after the tail rounds and the restart cascade, re-solve
        the lanes still unconverged in float64, in two stages
        (`_POLISH_STAGES`): fresh duals, from the original initial guess,
        line search 20, stall 10, `stalled_feasible_exits=False`.  Results
        are cast back to the fleet's dtype and merged.  Certified-infeasible
        lanes are never polished.
    polish_batch : lanes per polish solve.
    device_tail : run the tail as the JAX package's device program (module
        docstring); False runs the host-driven rounds.
    device_tail_rounds : device path: at most this many rounds (0: enough
        to give every lane one).
    restart_portfolio : device path: after the tail rounds, re-solve the
        lanes not SOLVED from the original initial guess with fresh duals,
        under each variant in turn, each on the lanes every earlier variant
        failed (`altro_tpu/solver/compaction.py:291-373`).  A variant is a
        dict of any of `penalty_scaling`, `initial_penalty`,
        `max_iterations_outer`, `max_iterations_total`; only lanes it
        SOLVES are merged.
    restart_width : lanes per variant's solve (0: `tail_batch`).
    restart_rounds : passes over the variants.
    detect_infeasible : device path: certify goal-in-obstacle lanes before
        phase 1 (`problem/infeasibility.py`); they never iterate and end
        INFEASIBLE.
    infeasible_step_bound : one-step (x, y) travel bound that enables the
        certificate at knot N-1 (0: knot N only).

    After each `solve`, `host_syncs` holds the solve's host
    synchronisations (`utils/timer.py:host_read`) but its final read-back
    of statuses and iterations, and `telemetry` the iteration distribution,
    `ls_tries` and `ls_block_tries` (the forward kernel's line-search
    tries, and the lane tries its blocks ran, per searched lane, read with
    the statuses; None without the kernel) and, when the polish
    ran, its lanes, stages and wall time; on the device path the number
    of tail rounds, the lanes each restart variant took and the host syncs
    of the cascade; on the host path phase 1's wall time and, per tail
    round, its stragglers and wall time.

    Tracer spans (`utils/timer.py`): `compaction.solve` around a solve,
    `compaction.phase1`, one `compaction.tail_round` per round (host path:
    per round of chunks), one `compaction.restart` per variant, one
    `compaction.polish_stage` per f64 polish stage that takes lanes (its
    chunks, their merges and its `polish_readback`), inside it one
    `compaction.polish` per polish chunk, `compaction.gather` and
    `compaction.merge` around each sub-solve's gather and merge; host reads
    at `tail_round`, `restart`, `polish_readback` and `final_readback`, and
    the uploads of host lane indices (`upload`).
    """

    def __init__(
        self,
        prob: CompiledProblem,
        opts: SolverOptions = None,
        *,
        phase1_iters: int = 20,
        tail_batch: int = 1024,
        tail_iters: int = 0,
        max_tail_rounds: int = 8,
        finish_stalled: bool = True,
        f64_polish: bool = False,
        polish_batch: int = 512,
        device_tail: bool = False,
        device_tail_rounds: int = 0,
        restart_portfolio: tuple = (),
        restart_width: int = 0,
        restart_rounds: int = 1,
        detect_infeasible: bool = False,
        infeasible_step_bound: float = 0.0,
    ):
        if tail_batch <= 0:
            raise ValueError("tail_batch must be positive")
        if polish_batch <= 0:
            raise ValueError("polish_batch must be positive")
        self.prob = prob
        self.opts = opts or SolverOptions()
        self.phase1_iters = int(phase1_iters)
        self.tail_batch = int(tail_batch)
        self.tail_iters = int(tail_iters)
        self.max_tail_rounds = int(max_tail_rounds)
        self.finish_stalled = bool(finish_stalled)
        self.f64_polish = bool(f64_polish)
        self.polish_batch = int(polish_batch)
        self.device_tail = bool(device_tail)
        self.device_tail_rounds = int(device_tail_rounds)
        self.restart_portfolio = tuple(restart_portfolio)
        self.restart_width = int(restart_width)
        self.restart_rounds = int(restart_rounds)
        self.detect_infeasible = bool(detect_infeasible)
        self.infeasible_step_bound = float(infeasible_step_bound)
        if self.restart_portfolio and not self.device_tail:
            raise ValueError("restart_portfolio requires device_tail=True")
        if self.detect_infeasible and not self.device_tail:
            raise ValueError("detect_infeasible requires device_tail=True")
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
        if self.tail_iters > 0:
            tail_opts = tail_opts.replace(
                max_iterations_total=min(self.tail_iters, tail_opts.max_iterations_total))
        self._p1 = ALSolverBatched(prob, p1_opts)
        self._tail = ALSolverBatched(prob, tail_opts)
        codes = [int(s) for s in _RESUMABLE]
        if self.finish_stalled:
            codes.append(int(SolverStatus.SOLVED_STALLED))
        self._codes_np = np.asarray(codes, dtype=np.int32)
        self._codes = torch.as_tensor(self._codes_np, device=self._p1.device)
        # the restart solver: each variant's duals and penalties come in
        # through its `al` argument, so the solver leaves them as given
        self._restart = None
        if self.restart_portfolio:
            self._restart = ALSolverBatched(prob, self.opts.replace(
                reset_duals=False, initial_penalty=0.0, update_duals_on_failed_inner=False,
            ))
        # one float64 solver per polish stage, on a float64 copy of the
        # problem: the solver and its kernels take their scalar type from it
        self._polish = ()
        if self.f64_polish:
            prob64 = prob.with_dtype(torch.float64)
            base = self.opts.replace(
                line_search_max_iterations=20, max_stall_iterations=10,
                stalled_feasible_exits=False, reset_duals=True,
            )
            self._polish = tuple(ALSolverBatched(prob64, base.replace(**extra)) for _, extra in _POLISH_STAGES)
        self.host_syncs = 0
        self.telemetry: dict = {}

    @staticmethod
    def _merge(res, sub, idx, real):
        """Scatter a sub-solve's results (tail round, restart variant or
        polish chunk) back into the full-batch result, masked to the real
        lanes, in the full batch's dtypes: trajectories, AL state, gains,
        status and scalars replace, the iteration counters add, and the
        history rows splice after each lane's earlier iterations (rows past
        the capacity drop)."""

        def sel(old, new):
            out = old.clone()
            out[..., idx] = torch.where(real, new.to(old.dtype), old[..., idx])
            return out

        def add(old, new):
            out = old.clone()
            out[idx] += new * real.to(new.dtype)
            return out

        with span("compaction.merge"):
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
            rows = st.rows
            cap = rows.shape[0]
            if cap > 0:
                # row j of lane idx[b] takes the sub-solve's row j - T0[b], with
                # T0 the lane's iterations before this merge
                r = torch.arange(cap, device=rows.device)[:, None] - st.iterations_total[idx].long()[None, :]
                valid = (r >= 0) & (r < su.iterations_total.long()[None, :]) & real[None, :]
                src = su.rows.gather(0, r.clamp(0, cap - 1)[:, None, :].expand(cap, rows.shape[1], r.shape[1]))
                rows = rows.clone()
                rows[..., idx] = torch.where(valid[:, None, :], src.to(rows.dtype), rows[..., idx])
            res["stats"] = st.replace(
                iterations_inner=sel(st.iterations_inner, su.iterations_inner),
                iterations_outer=add(st.iterations_outer, su.iterations_outer),
                iterations_total=add(st.iterations_total, su.iterations_total),
                rows=rows,
                **{
                    name: sel(getattr(st, name), getattr(su, name))
                    for name in (
                        "cost", "cost_decrease", "gradient", "alpha", "improvement_ratio",
                        "violations", "max_penalty", "regularization",
                    )
                },
            )
            return res

    def _portfolio(self, params, Z0: BatchedTrajectory, res, skip):
        """The fresh-restart cascade over `res`, the tail rounds' result:
        per variant, the (at most `restart_width`) lanes not SOLVED and not
        in `skip` (the certified-infeasible lanes, or None), from their
        original initial guess `Z0` with zero duals and the variant's
        initial penalty, under its per-lane options; lanes that come back
        SOLVED are merged.  Returns (res, the real lanes each variant
        took); each variant reads its lane count on the host (a `restart`
        read, which also ends the cascade once no lane is left)."""
        opts = self.opts
        dt, dev = Z0.X.dtype, Z0.X.device
        R = self.restart_width or self.tail_batch
        solved = int(SolverStatus.SOLVED)
        lanes = []
        for _ in range(self.restart_rounds):
            for variant in self.restart_portfolio:
                with span("compaction.restart"):
                    undone = res["status"] != solved
                    if skip is not None:
                        undone = undone & ~skip
                    order = torch.argsort((~undone).to(torch.int8), stable=True)
                    idx = order[:R]
                    real = undone[idx]
                    count = host_read("restart", lambda: int(real.sum()))
                    if count == 0:
                        return res, lanes
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
                    with span("compaction.gather"):
                        al_r = tuple(
                            dict(lam=torch.zeros((len(f.knots), f.dim, W), dtype=dt, device=dev),
                                 rho=torch.full((len(f.knots), W), rho0, dtype=dt, device=dev))
                            for f in self.prob.constraint_families
                        )
                        params_r = gather_params(self.prob.params, params, idx)
                        # from the original initial guess, not the failed trajectory
                        Z_r = Z0.replace(X=Z0.X[..., idx], U=Z0.U[..., idx])
                    sub = self._restart.solve(params_r, Z_r, al_r, active=real, lane_opts=lane_opts)
                    res = self._merge(res, sub, idx, real & (sub["status"] == solved))
        return res, lanes

    def _run_polish(self, solver: ALSolverBatched, params, Z0: BatchedTrajectory, res, lanes: np.ndarray):
        """Re-solve `lanes` (host indices) with the float64 `solver`, in
        chunks of `polish_batch`, with fresh duals from their original
        initial guess `Z0` (a warm start from the failed f32 trajectory
        converts fewer: its high-penalty shape traps the solve), and merge
        every chunk's results into `res`.  Returns `res`."""
        dev, f64 = Z0.X.device, torch.float64
        for start in range(0, len(lanes), self.polish_batch):
            with span("compaction.polish"):
                with span("compaction.gather"):
                    idx = _upload(lanes[start:start + self.polish_batch], dev)
                    params_p = gather_params(self.prob.params, params, idx).astype(f64)
                    Z_p = Z0.replace(X=Z0.X[..., idx].to(f64), U=Z0.U[..., idx].to(f64), t=Z0.t.to(f64),
                                     h=Z0.h.to(f64))
                sub = solver.solve(params_p, Z_p)
                res = self._merge(res, sub, idx, torch.ones(idx.shape, dtype=torch.bool, device=dev))
        return res

    def _solve_device(self, params, Z: BatchedTrajectory, al):
        """Phase 1 and the device program's tail rounds, restart cascade
        and certificates (module docstring).  Returns (res, telemetry)."""
        B = Z.X.shape[-1]
        infeasible = None
        with span("compaction.phase1"):
            if self.detect_infeasible:
                infeasible = goal_obstacle_certificates(self.prob, params, B, step_bound=self.infeasible_step_bound)
                res = self._p1.solve(params, Z, al, active=~infeasible)
            else:
                res = self._p1.solve(params, Z, al)
        K_t = self.tail_batch
        # certified lanes never resume
        tried = torch.zeros((B,), dtype=torch.bool, device=Z.X.device)
        if infeasible is not None:
            tried = tried | infeasible
        rounds = 0
        # enough rounds to cover every lane unless capped; a lane that ran
        # an uncapped tail round is terminal.  Once a round gathers no
        # unconverged lane no later round can, so the loop stops there.
        for _ in range(self.device_tail_rounds or -(-B // K_t)):
            with span("compaction.tail_round"):
                undone = torch.isin(res["status"], self._codes) & ~tried
                order = torch.argsort((~undone).to(torch.int8), stable=True)
                idx = order[:K_t]
                real = undone[idx]
                if not host_read("tail_round", lambda: bool(real.any())):
                    break
                rounds += 1
                sub = self._tail.solve(*self._gather(params, res, idx), active=real)
                res = self._merge(res, sub, idx, real)
                tried[idx] |= real
        restart_lanes, restart_syncs = [], 0
        if self._restart is not None:
            reads = host_reads()
            res, restart_lanes = self._portfolio(params, Z, res, infeasible)
            restart_syncs = host_reads() - reads
        if infeasible is not None:
            res = dict(res, status=torch.where(
                infeasible, int(SolverStatus.INFEASIBLE), res["status"]).to(torch.int32))
        return res, dict(tail_rounds=rounds, restart_lanes=restart_lanes, restart_host_syncs=restart_syncs)

    def _solve_host(self, params, Z: BatchedTrajectory, al, t0: float):
        """Phase 1 and the host-driven tail rounds
        (`altro_tpu/solver/compaction.py:502-615`): each round solves every
        unconverged lane in chunks of `tail_batch`; capped lanes re-enter
        the next round, and after an uncapped round (`tail_iters == 0`) none
        does.  Returns (res, telemetry)."""
        with span("compaction.phase1"):
            res = self._p1.solve(params, Z, al)
        undone = np.isin(host_read("tail_round", lambda: res["status"].cpu().numpy()), self._codes_np)
        tel = dict(phase1_s=time.perf_counter() - t0, tail_rounds=[])
        dev = Z.X.device
        while undone.any() and len(tel["tail_rounds"]) < self.max_tail_rounds:
            with span("compaction.tail_round"):
                t_round = time.perf_counter()
                lanes = np.nonzero(undone)[0]
                for start in range(0, len(lanes), self.tail_batch):
                    idx = _upload(lanes[start:start + self.tail_batch], dev)
                    sub = self._tail.solve(*self._gather(params, res, idx))
                    res = self._merge(res, sub, idx, torch.ones(idx.shape, dtype=torch.bool, device=dev))
                undone = np.isin(host_read("tail_round", lambda: res["status"].cpu().numpy()), self._codes_np)
                if self.tail_iters == 0:
                    # every straggler just had an uncapped solve: the budget
                    # statuses are terminal now (`_RESUMABLE`)
                    undone[:] = False
                tel["tail_rounds"].append(dict(stragglers=int(lanes.size), wall_s=time.perf_counter() - t_round))
        return res, tel

    def _gather(self, params, res, idx):
        """The params, trajectory and AL state of the lanes `idx` of a
        result."""
        with span("compaction.gather"):
            Z = res["Z"].replace(X=res["Z"].X[..., idx], U=res["Z"].U[..., idx])
            al = tuple(dict(lam=s["lam"][..., idx], rho=s["rho"][..., idx]) for s in res["al"])
            return gather_params(self.prob.params, params, idx), Z, al

    @staticmethod
    def _readback(site: str, res, searched):
        """Statuses and total iterations of every lane, and `searched`, the
        solve's (tries, searched lanes, lane tries run) of the forward
        kernel's line searches so far, on the host in one read."""
        B = res["status"].shape[-1]
        rows = torch.cat([res["status"].long(), res["stats"].iterations_total.long(), searched])
        host = host_read(site, lambda: rows.cpu().numpy())
        return host[:B], host[B:2 * B], host[2 * B:]

    def solve(self, params, Z: BatchedTrajectory, al=None):
        """Same contract as `ALSolverBatched.solve` (batch-last dict)."""
        t0 = time.perf_counter()
        reads = host_reads()
        counts = search_counts(Z.X.device)
        start = counts.clone()
        with root_span("compaction.solve"):
            if self.device_tail:
                if self.tail_iters > 0:
                    raise ValueError("device_tail supports uncapped tail rounds only (tail_iters=0)")
                res, tel = self._solve_device(params, Z, al)
            else:
                res, tel = self._solve_host(params, Z, al, t0)
            # the final read-back, which every solve makes for its telemetry,
            # also decides the polish; each polish stage reads the statuses again
            status, it, searched = self._readback(FINAL_READBACK, res, counts - start)
            polish = []
            for stage, (solver, (codes, _)) in enumerate(zip(self._polish, _POLISH_STAGES)):
                bad = np.nonzero(np.isin(status, codes))[0]
                if bad.size == 0:
                    continue
                t_p = time.perf_counter()
                with span("compaction.polish_stage"):
                    res = self._run_polish(solver, params, Z, res, bad)
                    status, it, searched = self._readback("polish_readback", res, counts - start)
                polish.append(dict(stage=stage, instances=int(bad.size), wall_s=time.perf_counter() - t_p))
            self.telemetry = dict(
                tel,
                iters_p50=float(np.percentile(it, 50)),
                iters_p95=float(np.percentile(it, 95)),
                iters_p99=float(np.percentile(it, 99)),
                iters_max=int(it.max()),
                ls_tries=ls_tries(searched),
                ls_block_tries=ls_block_tries(searched),
                total_s=time.perf_counter() - t0,
            )
            if polish:
                self.telemetry["polish"] = dict(
                    instances=polish[0]["instances"],
                    stages=polish,
                    wall_s=sum(p["wall_s"] for p in polish),
                    solved_after=int((status == int(SolverStatus.SOLVED)).sum()),
                )
        self.host_syncs = host_reads() - reads
        return res


def _upload(lanes: np.ndarray, dev) -> torch.Tensor:
    """Host lane indices on the device: a copy that waits for the device's
    queue (an `upload` host read)."""
    return host_read("upload", lambda: torch.as_tensor(lanes, dtype=torch.long, device=dev))

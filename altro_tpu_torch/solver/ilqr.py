"""Inner iLQR solver of one instance: expansions → backward pass →
line-searched forward pass (`altro_tpu/solver/ilqr.py`, the analog of
`ilqr::iLQR<n,m>`, `altro/ilqr/ilqr.hpp:47-813`).

Each `lax.while_loop` of the JAX package is a Python loop here whose exit
test reads one device value: `ILQRSolver.host_syncs` counts them per solve
(the backward pass's retries, the line search's tries, the iterations).
Everything else stays on the tensors' device.  The solver reaches no CUDA
kernel: like the JAX package's per-instance path (`lax.scan` recursions),
it is plain tensor code, launch-bound on a card.
"""
from __future__ import annotations

import dataclasses

import torch

from ..options import LogLevel, SolverOptions
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import (
    SolverStats,
    SolverStatus,
    Trajectory,
    stats_init,
    stats_log,
    stats_new_iteration,
)
from ..utils.logging import SolverLogger
from ..utils.timer import Timer
from .functions import ALState, ProblemFunctions
from .riccati import (
    BackwardPassResult,
    backward_pass,
    decrease_regularization,
    increase_regularization,
)


@dataclasses.dataclass(frozen=True)
class ForwardPassResult:
    Z: Trajectory
    J: torch.Tensor
    alpha: torch.Tensor
    z: torch.Tensor
    success: torch.Tensor
    rho: torch.Tensor
    drho: torch.Tensor
    status: torch.Tensor

    def replace(self, **updates) -> "ForwardPassResult":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class ILQRResult:
    Z: Trajectory
    costs: torch.Tensor  # [N+1] final per-knot costs
    K: torch.Tensor  # [N, m, n] final feedback gains
    d: torch.Tensor  # [N, m] final feedforward gains
    status: torch.Tensor
    stats: SolverStats

    def replace(self, **updates) -> "ILQRResult":
        return dataclasses.replace(self, **updates)


def _status(code: int, like: torch.Tensor) -> torch.Tensor:
    """A status code as a 0-d int32 tensor on `like`'s device (a fill, not
    a copy from the host, which would wait for the device)."""
    return torch.full((), int(code), dtype=torch.int32, device=like.device)


class ILQRSolver:
    """iLQR over a compiled problem, optionally with an AL cost.

    Methods are functional: `(params, al, Z, ...) -> result`; pass `al=()`
    for an unconstrained problem.  `ALSolver` drives it as
    `AugmentedLagrangianiLQR` drives its inner `iLQR` (`al_solver.hpp:313-333`).
    `opts.matmul_precision` and `opts.scan_unroll` have no effect here:
    float32 products run in full float32 (TF32 is off, `solver/batched.py`)
    and the recursions are Python loops.
    """

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None):
        self.prob = prob
        self.opts = opts or SolverOptions()
        self.fns = ProblemFunctions(prob, self.opts)
        # host synchronisations of the last `solve` (one per loop exit test,
        # and one per printed row)
        self.host_syncs = 0
        # phase profile and live rows; `ALSolver` shares both
        self.timer = Timer(active=self.opts.profiler_enable)
        self.logger = SolverLogger(self.opts.verbose, frequency=self.opts.header_frequency)
        self.logger.set_tolerances(
            self.opts.cost_tolerance, self.opts.constraint_tolerance, self.opts.gradient_tolerance
        )

    def _read(self, t: torch.Tensor) -> bool:
        """One exit test: a device bool read on the host."""
        self.host_syncs += 1
        return bool(t)

    # ------------------------------------------------------------- components
    def rollout(self, params: ProblemParams, Z: Trajectory) -> Trajectory:
        return self.fns.rollout(params, Z)

    def expansions(self, params, al, Z):
        return self.fns.expand(params, al, Z)

    def backward_pass(self, exp, rho=0.0, drho=0.0) -> BackwardPassResult:
        """The sequential sweep with its retry loop (`backward_pass="pscan"`,
        retired in the JAX package, is refused by `SolverOptions`)."""
        bp = backward_pass(exp, rho, drho, self.opts)
        self.host_syncs += bp.attempts
        return bp

    def closed_loop_rollout(self, params, Z: Trajectory, K, d, alpha):
        """Feedback rollout ū = u + K(x̄−x) + αd with the state and control
        bound guards (`ilqr.hpp:468-499`).  Returns (Zbar, valid, status)."""
        opts = self.opts
        prob = self.prob
        x0 = torch.as_tensor(params.x0).to(Z.X.dtype)
        unsolved = _status(SolverStatus.UNSOLVED, Z.X)
        state_limit = _status(SolverStatus.STATE_LIMIT, Z.X)
        control_limit = _status(SolverStatus.CONTROL_LIMIT, Z.X)
        xbar = x0
        valid = torch.ones((), dtype=torch.bool, device=Z.X.device)
        status = unsolved
        Xs, Us = [x0], []
        for k in range(prob.N):
            ubar = Z.U[k] + K[k] @ (xbar - Z.X[k]) + alpha * d[k]
            xnext = prob.dynamics_step(params.dynamics, k, xbar, ubar, Z.t[k], Z.h[k])
            if opts.check_forwardpass_bounds:
                state_ok = torch.linalg.vector_norm(xnext) <= opts.state_max
                ctrl_ok = torch.linalg.vector_norm(ubar) <= opts.control_max
                fail_now = valid & ~(state_ok & ctrl_ok)
                status = torch.where(fail_now, torch.where(state_ok, control_limit, state_limit), status)
                valid = valid & state_ok & ctrl_ok
                xbar = torch.where(valid, xnext, xbar)
            else:
                xbar = xnext
            Xs.append(xbar)
            Us.append(ubar)
        status = torch.where(valid, unsolved, status)
        return Z.replace(X=torch.stack(Xs), U=torch.stack(Us)), valid, status

    def forward_pass(self, params, al, Z: Trajectory, bp: BackwardPassResult, J0,
                     rho=None, drho=None) -> ForwardPassResult:
        """Backtracking line search with the z-ratio acceptance rule
        (`ilqr.hpp:512-558`).

        `rho`/`drho` are the regularization after the backward pass's
        end-of-pass decrease (`ilqr.hpp:443-444`); a failed search increases
        from there (`ilqr.hpp:550`).  They default to the backward pass's."""
        opts = self.opts
        dt = Z.X.dtype
        J0 = torch.as_tensor(J0, dtype=dt, device=Z.X.device)
        rho = bp.rho if rho is None else rho
        drho = bp.drho if drho is None else drho
        alpha = torch.ones((), dtype=dt, device=Z.X.device)
        success = torch.zeros((), dtype=torch.bool, device=Z.X.device)
        Zbar, J, z, status = Z, J0, -torch.ones_like(J0), _status(SolverStatus.UNSOLVED, Z.X)
        it = 0
        while it < opts.line_search_max_iterations and not (it > 0 and self._read(success)):
            Zbar, valid, status = self.closed_loop_rollout(params, Z, bp.K, bp.d, alpha)
            J_try = self.fns.total_cost(params, al, Zbar)
            # only a valid rollout updates J (`ilqr.hpp:526-527`)
            J = torch.where(valid, J_try, J)
            expected = -alpha * (bp.dV1 + alpha * bp.dV2)
            z = torch.where(expected > 0.0, (J0 - J_try) / expected, -torch.ones_like(J0))
            success = (
                valid
                & (opts.line_search_lower_bound <= z)
                & (z <= opts.line_search_upper_bound)
                & (J_try < J0)
            )
            alpha = torch.where(success, alpha, alpha / opts.line_search_decrease_factor)
            it += 1
        Z_out = Z.replace(X=torch.where(success, Zbar.X, Z.X), U=torch.where(success, Zbar.U, Z.U))
        rho_i, drho_i = increase_regularization(rho, drho, opts)
        rho, drho = torch.where(success, rho, rho_i), torch.where(success, drho, drho_i)
        J_final = torch.where(success, J, J0)
        # unreachable in exact arithmetic (failure sets J = J0), kept as the
        # reference keeps it (`ilqr.hpp:554-557`)
        status = torch.where(J_final > J0, _status(SolverStatus.COST_INCREASE, Z.X), status)
        return ForwardPassResult(Z=Z_out, J=J_final, alpha=alpha, z=z, success=success,
                                 rho=rho, drho=drho, status=status)

    def normalized_feedforward_gain(self, d, U):
        """Gradient proxy: mean over k of max_j |d_j|/(|u_j|+1)
        (`ilqr.hpp:662-668`)."""
        return (d.abs() / (U.abs() + 1.0)).amax(dim=-1).mean()

    # ------------------------------------------------------------------ solve
    def solve(self, params: ProblemParams, al: ALState, Z: Trajectory,
              stats: SolverStats = None) -> ILQRResult:
        """Full inner solve (`iLQR::Solve`, `ilqr.hpp:284-316`): rollout, then
        {expand, backward, forward, stats} until done.  `stats` carries
        across the AL outer iterations (iterations_total).

        With `profiler_enable` each phase is a `Timer` scope
        (`ilqr.hpp:294,351,386,469,513,569,598,630`) that waits for the
        card; at `verbose` INNER or above each iteration prints a row
        (`solver_logger.cpp:47-54`) after one more read of the device."""
        self.host_syncs = 0
        opts, fns, timer, logger = self.opts, self.fns, self.timer, self.logger
        dt, dev = Z.X.dtype, Z.X.device
        timer.device = dev
        if stats is None:
            stats = stats_init(opts.stats_capacity, dt, dev)
        with timer.trace_context("ilqr"):
            with timer.trace_context("init", block=True):
                Z = fns.rollout(params, Z)
                J_init = fns.total_cost(params, al, Z)
            stats = stats.replace(initial_cost=J_init, iterations_inner=0)
            rho = torch.full((), opts.bp_reg_initial, dtype=dt, device=dev)
            drho = torch.zeros((), dtype=dt, device=dev)
            cost_last = J_init
            stall = torch.zeros((), dtype=torch.int32, device=dev)
            solved = _status(SolverStatus.SOLVED, Z.X)
            stalled_code = _status(SolverStatus.SOLVED_STALLED, Z.X)
            while True:
                with timer.trace_context("expansions", block=True):
                    exp = fns.expand(params, al, Z)
                    J0 = exp.costs.sum()
                with timer.trace_context("backward_pass", block=True):
                    bp = self.backward_pass(exp, rho, drho)
                stats = stats_log(stats, regularization=bp.rho)
                # end-of-pass decrease (`ilqr.hpp:443-444`); a failed line
                # search increases again from the decreased value
                rho_d, drho_d = decrease_regularization(bp.rho, bp.drho, opts)
                with timer.trace_context("forward_pass", block=True):
                    fp = self.forward_pass(params, al, Z, bp, J0, rho_d, drho_d)
                status = _status(bp.status, Z.X) if bp.failed else fp.status

                with timer.trace_context("stats"):
                    # statistics (`ilqr.hpp:568-587`): cost, α and z are
                    # logged only on a successful line search
                    # (`ilqr.hpp:535-541`)
                    cost_new = torch.where(fp.success, fp.J, cost_last)
                    stats = stats_log(
                        stats,
                        cost=torch.where(fp.success, fp.J, stats.cost),
                        alpha=torch.where(fp.success, fp.alpha, stats.alpha),
                        improvement_ratio=torch.where(fp.success, fp.z, stats.improvement_ratio),
                    )
                    grad = self.normalized_feedforward_gain(bp.d, fp.Z.U)
                    dJ = cost_last - cost_new
                    stats = stats_log(stats, cost_decrease=dJ, gradient=grad)
                    stats = stats.replace(iterations_inner=stats.iterations_inner + 1,
                                          iterations_total=stats.iterations_total + 1)
                    stats = stats_new_iteration(stats)
                if logger.level >= LogLevel.INNER:
                    self._print_row(stats, cost_new, dJ, grad, fp, bp)

                with timer.trace_context("convergence_check"):
                    # IsDone (`ilqr.hpp:597-619`): convergence wins over failure
                    small_dj = dJ < opts.cost_tolerance
                    converged = small_dj & (grad < opts.gradient_tolerance)
                    # the numerical-floor stall exit
                    # (SolverOptions.max_stall_iterations) ends with its own
                    # status, never SOLVED
                    stall = torch.where(small_dj, stall + 1, 0).to(torch.int32)
                    if opts.max_stall_iterations > 0:
                        stalled = (stall >= opts.max_stall_iterations) & ~converged
                    else:
                        stalled = torch.zeros_like(converged)
                    hit_inner = stats.iterations_inner >= opts.max_iterations_inner
                    hit_total = stats.iterations_total >= opts.max_iterations_total
                    if hit_inner:
                        status = _status(SolverStatus.MAX_INNER_ITERATIONS, Z.X)
                    elif hit_total:
                        status = _status(SolverStatus.MAX_ITERATIONS, Z.X)
                    status = torch.where(converged, solved, torch.where(stalled, stalled_code, status))
                    Z, rho, drho, cost_last = fp.Z, fp.rho, fp.drho, cost_new
                    done = hit_inner or hit_total or bp.failed or self._read(status != int(SolverStatus.UNSOLVED))
                if done:
                    break
        return ILQRResult(Z=Z, costs=exp.costs, K=bp.K, d=bp.d, status=status, stats=stats)

    def _print_row(self, stats, cost, dJ, grad, fp, bp) -> None:
        """One inner-iteration row (`solver_stats.cpp:80-114`), one read:
        α and z only after a successful line search; the violation and
        penalty of the outer iteration it belongs to."""
        vals = [cost, dJ, grad, fp.alpha, fp.z, bp.rho, fp.success, stats.violations, stats.max_penalty]
        self.host_syncs += 1
        cost, dJ, grad, alpha, z, reg, success, viol, pen = torch.stack(
            [torch.as_tensor(v).to(torch.float64) for v in vals]).tolist()
        log = self.logger.log
        log("iters", stats.iterations_total)
        log("iter_al", stats.iterations_outer)
        log("cost", cost)
        log("dJ", dJ)
        log("grad", grad)
        if success:
            log("alpha", alpha)
            log("z", z)
        log("reg", reg)
        log("viol", viol)
        log("pen", pen)
        self.logger.print_row()

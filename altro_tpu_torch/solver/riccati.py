"""Riccati backward pass of the per-instance solver
(`altro_tpu/solver/riccati.py`).

The sequential recursion of `iLQR::BackwardPass` /
`KnotPointFunctions::CalcActionValueExpansion..CalcCostToGo`
(`altro/ilqr/ilqr.hpp:385-445`, `ilqr/knot_point_function_type.hpp:149-235`)
as a Python loop over the knots, and the regularization retry loop around
it.  A Cholesky failure (Eigen's `LLT::info()` in the reference) is
`torch.linalg.cholesky_ex`'s info or a non-finite factor; the whole sweep
then retries with a larger regularization, one host synchronisation per
attempt (the reference restarts its k-loop from N-1, `ilqr.hpp:409-427`;
the terminal cost-to-go is the same, so restarting the sweep is
equivalent).
"""
from __future__ import annotations

import dataclasses

import torch

from ..options import SolverOptions
from ..types import SolverStatus
from .functions import Expansions


@dataclasses.dataclass(frozen=True)
class BackwardPassResult:
    K: torch.Tensor  # [N, m, n] feedback gains
    d: torch.Tensor  # [N, m] feedforward gains
    P: torch.Tensor  # [N+1, n, n] cost-to-go Hessians
    p: torch.Tensor  # [N+1, n] cost-to-go gradients
    dV1: torch.Tensor  # expected decrease, linear term  Σ dᵀQu
    dV2: torch.Tensor  # expected decrease, quadratic term  Σ ½dᵀQuu d
    rho: torch.Tensor  # regularization after the pass (before the decrease)
    drho: torch.Tensor
    status: SolverStatus  # BACKWARD_PASS_REGULARIZATION_FAILED on give-up
    failed: bool
    attempts: int  # sweeps run, each ended by one host synchronisation

    def replace(self, **updates) -> "BackwardPassResult":
        return dataclasses.replace(self, **updates)


def increase_regularization(rho, drho, opts: SolverOptions):
    """ρ, dρ damped increase (`ilqr.hpp:770-775`)."""
    drho = torch.clamp(drho * opts.bp_reg_increase_factor, min=opts.bp_reg_increase_factor)
    rho = torch.clamp(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho


def decrease_regularization(rho, drho, opts: SolverOptions):
    """ρ, dρ damped decrease (`ilqr.hpp:781-786`)."""
    drho = torch.clamp(drho / opts.bp_reg_increase_factor, max=1.0 / opts.bp_reg_increase_factor)
    rho = torch.clamp(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho


def _riccati_scan(exp: Expansions, rho, gain_limit: float = 1e8):
    """One full backward sweep at a fixed regularization.

    Returns (K, d, P, p, dV1, dV2, failed).  After a knot whose regularized
    Quu is not positive definite the carry stays frozen for the earlier
    knots, as the reference breaks out (`ilqr.hpp:409-427`); the caller
    retries with a larger ρ.  Gains beyond `gain_limit` count as a failure
    too (a finite but singular factorization gives unbounded gains; see
    SolverOptions.bp_gain_limit).
    """
    A_all, B_all = exp.A, exp.B
    N, n = A_all.shape[0], A_all.shape[-1]
    m = B_all.shape[-1]
    eye_m = torch.eye(m, dtype=A_all.dtype, device=A_all.device)
    P, p = exp.lxx[N], exp.lx[N]
    dV1 = dV2 = A_all.new_zeros(())
    failed = torch.zeros((), dtype=torch.bool, device=A_all.device)
    K_out, d_out = A_all.new_empty((N, m, n)), A_all.new_empty((N, m))
    P_out, p_out = A_all.new_empty((N + 1, n, n)), A_all.new_empty((N + 1, n))
    P_out[N], p_out[N] = P, p
    for k in reversed(range(N)):
        A, B = A_all[k], B_all[k]
        # action-value expansion (`knot_point_function_type.hpp:149-164`)
        AtP = A.T @ P
        Qxx = exp.lxx[k] + AtP @ A
        Qxu = exp.lxu[k] + AtP @ B
        Quu = exp.luu[k] + B.T @ (P @ B)
        Qx = exp.lx[k] + A.T @ p
        Qu = exp.lu[k] + B.T @ p
        # control-only regularization (`knot_point_function_type.hpp:175-186`)
        L, info = torch.linalg.cholesky_ex(Quu + rho * eye_m)
        fail_k = (info != 0) | ~torch.isfinite(L).all()
        L = torch.where(fail_k, eye_m, L)
        # gains (`knot_point_function_type.hpp:197-211`): K and d from one
        # pair of triangular solves over [Qxuᵀ | Qu]
        rhs = torch.cat([Qxu.T, Qu[:, None]], dim=1)
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        sol = -torch.linalg.solve_triangular(L.T, y, upper=True)
        K, d = sol[:, :n], sol[:, n]
        # NaN-safe magnitude guard: ~(x <= lim) is True for NaN and inf too
        fail_k = fail_k | ~(sol.abs().max() <= gain_limit)
        # cost-to-go with the unregularized Quu
        # (`knot_point_function_type.hpp:220-230`)
        KtQuu = K.T @ Quu
        p_new = Qx + KtQuu @ d + K.T @ Qu + Qxu @ d
        P_new = Qxx + KtQuu @ K + K.T @ Qxu.T + Qxu @ K
        dV1_new = dV1 + d @ Qu
        dV2_new = dV2 + 0.5 * d @ (Quu @ d)
        failed = failed | fail_k
        P, p = torch.where(failed, P, P_new), torch.where(failed, p, p_new)
        dV1, dV2 = torch.where(failed, dV1, dV1_new), torch.where(failed, dV2, dV2_new)
        K_out[k], d_out[k], P_out[k], p_out[k] = K, d, P_new, p_new
    return K_out, d_out, P_out, p_out, dV1, dV2, failed


def backward_pass(exp: Expansions, rho, drho, opts: SolverOptions) -> BackwardPassResult:
    """Full backward pass with the regularization retry loop
    (`ilqr.hpp:385-445`).  Each exit test is one host synchronisation
    (`attempts` of them), so the result's `failed` and `status` are host
    values."""
    rho = torch.as_tensor(rho, dtype=exp.A.dtype, device=exp.A.device)
    drho = torch.as_tensor(drho, dtype=exp.A.dtype, device=exp.A.device)
    count = attempts = 0
    while True:
        K, d, P, p, dV1, dV2, failed = _riccati_scan(exp, rho, gain_limit=opts.bp_gain_limit)
        rho2, drho2 = increase_regularization(rho, drho, opts)
        attempts += 1
        failed, at_max = torch.stack([failed, rho2 >= opts.bp_reg_max]).tolist()
        if not failed:
            break
        rho, drho = rho2, drho2
        count += int(at_max)
        if count >= opts.bp_reg_fail_threshold:
            break
    status = SolverStatus.BACKWARD_PASS_REGULARIZATION_FAILED if failed else SolverStatus.UNSOLVED
    return BackwardPassResult(K=K, d=d, P=P, p=p, dV1=dV1, dV2=dV2, rho=rho, drho=drho,
                              status=status, failed=failed, attempts=attempts)

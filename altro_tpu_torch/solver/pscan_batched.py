"""Parallel-prefix Riccati backward sweep in the batch-last layout
(`altro_tpu/solver/pscan_batched.py`).

`solver/pscan.py`'s associative-scan sweep (arXiv:1809.06360, the
O(log N)-depth form of the reference's sequential recursion,
`altro/ilqr/ilqr.hpp:402-441`) in the lane layout of `ALSolverBatched`:
every tensor carries the instance batch in its last axis ([N, n, n, B]
etc.), so the small-matrix algebra is broadcast-multiply-reduce over the
tiny axes and elementwise over the lanes (`solver/batched.py:mm`).

The n×n inverses inside the combine are Gauss-Jordan unrolled over static
indices without pivoting (`inv_unrolled`), the general-matrix analog of
`chol_unrolled`, so that every operation stays elementwise over the lanes.
That is safe only for the matrices it is given: M = I + C·J with C and J
positive semidefinite has eigenvalues ≥ 1.  (I + J·C)⁻¹ follows from
(I + C·J)⁻¹ by the push-through identity instead of a second elimination.

Regularization: at ρ = 0 the sweep equals the sequential one
(`ALSolverBatched.riccati_scan`) to rounding.  At ρ > 0 they differ by
construction: the elements eliminate the control against the regularized
control cost luu + ρI, so the propagated cost-to-go is that of the
control-regularized LQR problem, where the sequential pass
(`knot_point_function_type.hpp:175-230`) regularizes the gain solve only
and propagates the unregularized Quu.  That mixed update is the Riccati
recursion of no LQR problem and has no associative form.  Both are damped
Newton steps, and the solver's retry and line search treat them alike; the
per-instance `backward_pass_pscan` makes the same choice and is this
sweep's oracle at ρ > 0.

Route `ALSolverBatched` through it by replacing its `riccati_scan`
(`solver.riccati_scan = lambda exp, rho: riccati_pscan_batched(exp, rho,
gain_limit=solver.opts.bp_gain_limit)`) on a solver whose backward pass
is `"scan"`.  Its depth is about 2⌈log₂N⌉ combine levels of about eight small
products and an inversion each, against N dependent steps of about six
products for the sequential sweep: it does more work, so it can only pay
where the horizon is long and the batch too narrow to fill the card.
"""
from __future__ import annotations

import torch

from .batched import chol_failed, chol_solve_mat, chol_solve_vec, chol_unrolled, dotv, mm, mT, mv
from .pscan import associative_scan


def inv_unrolled(M):
    """Inverse of M [..., n, n, B] by pivot-free Gauss-Jordan unrolled over
    static indices; every operation is elementwise over the lane axis."""
    n = M.shape[-3]
    a = [[M[..., i, j, :] for j in range(n)] for i in range(n)]
    one = torch.ones_like(M[..., 0, 0, :])
    zero = torch.zeros_like(one)
    inv = [[one if i == j else zero for j in range(n)] for i in range(n)]
    for k in range(n):
        ipiv = 1.0 / a[k][k]
        a[k] = [x * ipiv for x in a[k]]
        inv[k] = [x * ipiv for x in inv[k]]
        for i in range(n):
            if i == k:
                continue
            f = a[i][k]
            a[i] = [x - f * y for x, y in zip(a[i], a[k])]
            inv[i] = [x - f * y for x, y in zip(inv[i], inv[k])]
    return torch.stack([torch.stack(row, dim=-2) for row in inv], dim=-3)  # [..., n, n, B]


def _safe(L):
    """Cholesky entries with the non-finite ones replaced by 1, so that the
    solves after a failed factor stay finite (`chol_failed` reports the
    failure)."""
    return [[None if e is None else torch.where(torch.isfinite(e), e, 1.0) for e in row] for row in L]


def _combine(e_next, e_prev):
    """`solver/pscan.py:_combine` batch-last: `e_prev` the earlier interval,
    `e_next` the later; every leaf [..., n(, n), B]."""
    Fi, fi, Ci, Ji, etai = e_prev
    Fj, fj, Cj, Jj, etaj = e_next
    n = Fi.shape[-3]
    I = torch.eye(n, dtype=Fi.dtype, device=Fi.device)[..., None]
    Minv = inv_unrolled(I + mm(Ci, Jj))
    FjM = mm(Fj, Minv)
    F = mm(FjM, Fi)
    f = mv(FjM, fi + mv(Ci, etaj)) + fj
    C = mm(FjM, mm(Ci, mT(Fj))) + Cj
    # (I + Jj Ci)⁻¹ = I - Jj Minv Ci  (push-through identity)
    Ntinv = I - mm(Jj, mm(Minv, Ci))
    FiT = mT(Fi)
    J = mm(FiT, mm(Ntinv, mm(Jj, Fi))) + Ji
    eta = mv(FiT, mv(Ntinv, etaj - mv(Jj, fi))) + etai
    return (F, f, C, J, eta)


def riccati_pscan_batched(exp: dict, rho, gain_limit: float = 1e8):
    """One backward sweep at the per-instance regularization ρ [B], with
    the contract of `ALSolverBatched.riccati_scan`: returns (K [N,m,n,B],
    d [N,m,B], dV1 [B], dV2 [B], failed [B]).  Gains beyond `gain_limit`
    count as a failure (SolverOptions.bp_gain_limit)."""
    A, Bd = exp["A"], exp["B"]
    N, n, m = A.shape[0], A.shape[1], Bd.shape[2]
    lxx, lxu, luu = exp["lxx"][:N], exp["lxu"][:N], exp["luu"][:N]
    lx, lu = exp["lx"][:N], exp["lu"][:N]
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)[..., None]
    eye_n = torch.eye(n, dtype=A.dtype, device=A.device)[..., None]

    # the steps' elements (`solver/pscan.py:_elem_from_step`)
    L = chol_unrolled(luu + eye_m * rho)
    fail_elem = chol_failed(L)  # [N, B]
    Ls = _safe(L)
    Kc = chol_solve_mat(Ls, mT(lxu))  # [N, m, n, B]
    kc = chol_solve_vec(Ls, lu)  # [N, m, B]
    F = A - mm(Bd, Kc)
    f = -mv(Bd, kc)
    C = mm(Bd, chol_solve_mat(Ls, mT(Bd)))
    Jc = lxx - mm(lxu, Kc)
    eta = -(lx - mv(lxu, kc))

    # element k composed with every step after it
    Fs, fs, Cs, Js, etas = associative_scan(_combine, (F, f, C, Jc, eta), reverse=True)

    # close each suffix against the terminal cost-to-go
    PN, pN = exp["lxx"][N], exp["lx"][N]  # [n, n, B], [n, B]
    Minv = inv_unrolled(eye_n + mm(PN[None], Cs))
    PM = mm(Minv, PN[None])
    Pk = Js + mm(mT(Fs), mm(PM, Fs))
    pk = -etas + mv(mT(Fs), mv(Minv, pN[None] + mv(PN[None], fs)))
    P = torch.cat([Pk, PN[None]])  # [N+1, n, n, B]
    p = torch.cat([pk, pN[None]])

    # the gains from P_{k+1}, p_{k+1}, as the sequential sweep takes them
    Pn, pn = P[1:], p[1:]
    Qxu = lxu + mm(mm(mT(A), Pn), Bd)
    Quu = luu + mm(mT(Bd), mm(Pn, Bd))
    Qu = lu + mv(mT(Bd), pn)
    Lg = chol_unrolled(Quu + eye_m * rho)
    fail_g = chol_failed(Lg)
    Lgs = _safe(Lg)
    K = -chol_solve_mat(Lgs, mT(Qxu))
    d = -chol_solve_vec(Lgs, Qu)
    dV1 = dotv(d, Qu).sum(dim=0)
    dV2 = 0.5 * dotv(d, mv(Quu, d)).sum(dim=0)

    # gain-magnitude guard (SolverOptions.bp_gain_limit), NaN-safe
    gains_ok = (K.abs().amax(dim=(0, 1, 2)) <= gain_limit) & (d.abs().amax(dim=(0, 1)) <= gain_limit)
    finite = torch.isfinite(P).flatten(0, 2).all(dim=0)
    failed = fail_elem.any(dim=0) | fail_g.any(dim=0) | ~finite | ~gains_ok
    return K, d, dV1, dV2, failed

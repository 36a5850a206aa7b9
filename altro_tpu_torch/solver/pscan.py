"""Parallel-prefix (associative scan) Riccati backward pass of the
per-instance solver (`altro_tpu/solver/pscan.py`).

The O(log N)-depth form (arXiv:1809.06360, "The Parallelization of Riccati
Recursion") of the reference's sequential backward recursion
(`altro/ilqr/ilqr.hpp:402-441`): each step's value-function update is an
element (F, f, C, J, η) of an associative composition, `associative_scan`
composes every suffix in ⌈log₂N⌉ levels of one batched combine each, each
suffix is closed against the terminal cost-to-go, and the gains come out
per step from the cost-to-go after it, as in the sequential pass.

The elements eliminate the control against the regularized control cost
luu + ρI, so at ρ > 0 the propagated cost-to-go is that of the
control-regularized LQR problem, where the sequential pass regularizes the
gain solve only (`solver/pscan_batched.py` says why the mixed update has no
associative form).  At ρ = 0 the two equal each other to rounding.  A
factor that is not positive definite, a non-finite cost-to-go or a gain
beyond `bp_gain_limit` fails the attempt, and the retry loop raises ρ as
`solver/riccati.py:backward_pass` does.

The JAX package keeps this module, and `solver/pscan_batched.py`, as entry
points for research: `backward_pass="pscan"` is refused
(`options.py`).  Route a solver's sweep through it by replacing the
solver's `backward_pass` (tests/test_torch_pscan.py:_patch_pscan).
"""
from __future__ import annotations

import torch

from ..options import SolverOptions
from ..types import SolverStatus
from .functions import Expansions
from .riccati import BackwardPassResult, increase_regularization


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of the associative `fn` over the leading axis of the
    tuple of tensors `elems`, in `jax.lax.associative_scan`'s order of
    combination: the same odd/even recursion, each of its ⌈log₂N⌉ levels
    down and up one call of `fn` over all that level's pairs at once.
    `fn(a, b)` takes two such tuples, a before b along the scan, and
    returns one; with `reverse` the scan runs from the last element, so
    element k of the result composes elements k..N-1."""
    elems = tuple(torch.flip(e, (0,)) if reverse else e for e in elems)

    def scan(es):
        n = es[0].shape[0]
        if n < 2:
            return es
        odd = scan(tuple(fn(tuple(e[0:-1:2] for e in es), tuple(e[1::2] for e in es))))
        first = tuple(e[:-1] for e in odd) if n % 2 == 0 else odd
        even = fn(first, tuple(e[2::2] for e in es))
        return tuple(_interleave(torch.cat([e[:1], r]), o) for e, r, o in zip(es, even, odd))

    out = scan(elems)
    return tuple(torch.flip(e, (0,)) for e in out) if reverse else out


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], … along the leading axis (a as long as b or
    one longer)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]))
    out[0::2] = a
    out[1::2] = b
    return out


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _chol(M, eye):
    """Cholesky factors of M [..., m, m] and a mask of the positive definite
    ones; a failed factor is replaced by the identity, as the JAX package's
    NaN factor is (`jnp.where(isfinite(L), L, eye)`)."""
    L, info = torch.linalg.cholesky_ex(M)
    ok = (info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], L, eye), ok


def _elem_from_step(A, B, lxx, lxu, luu, lx, lu, rho, eye_m):
    """The associative elements of the steps (leading axis: the knots):
    the control eliminated against the regularized luu, giving
      F = A - B Kc,  f = -B kc,  C = B (luu + ρI)⁻¹ Bᵀ,
    and the value-function accumulators J and η (arXiv:1809.06360 §III).
    Returns the element and a mask of the steps whose luu + ρI factors."""
    L, ok = _chol(luu + rho * eye_m, eye_m)
    luu_inv = torch.cholesky_solve(eye_m.expand_as(L), L)
    Kc = luu_inv @ lxu.mT  # [N, m, n]
    kc = _mv(luu_inv, lu)  # [N, m]
    F = A - B @ Kc
    f = -_mv(B, kc)
    C = B @ luu_inv @ B.mT
    Jc = lxx - lxu @ Kc
    eta = -(lx - _mv(lxu, kc))
    return (F, f, C, Jc, eta), ok


def _combine(e_next, e_prev):
    """The element of two consecutive intervals: `e_prev` the earlier one,
    `e_next` the later (arXiv:1809.06360 eq. (9)-(10); the argument order
    of `associative_scan(..., reverse=True)`)."""
    Fi, fi, Ci, Ji, etai = e_prev
    Fj, fj, Cj, Jj, etaj = e_next
    n = Fi.shape[-1]
    I = torch.eye(n, dtype=Fi.dtype, device=Fi.device)
    Minv = torch.linalg.solve(I + Ci @ Jj, I.expand_as(Ci))
    F = Fj @ Minv @ Fi
    f = _mv(Fj @ Minv, fi + _mv(Ci, etaj)) + fj
    C = Fj @ Minv @ Ci @ Fj.mT + Cj
    Ntinv = torch.linalg.solve(I + Jj @ Ci, I.expand_as(Ci))
    J = Fi.mT @ Ntinv @ Jj @ Fi + Ji
    eta = _mv(Fi.mT @ Ntinv, etaj - _mv(Jj, fi)) + etai
    return (F, f, C, J, eta)


def _sweep(exp: Expansions, rho, gain_limit: float):
    """One associative-scan sweep at the regularization ρ.  Returns
    (K, d, P, p, dV1, dV2, failed)."""
    N, n, m = exp.A.shape[0], exp.A.shape[-1], exp.B.shape[-1]
    dt, dev = exp.A.dtype, exp.A.device
    eye_m = torch.eye(m, dtype=dt, device=dev)
    eye_n = torch.eye(n, dtype=dt, device=dev)
    A, B = exp.A, exp.B
    lxx, lxu, luu, lx, lu = exp.lxx[:N], exp.lxu[:N], exp.luu[:N], exp.lx[:N], exp.lu[:N]
    elems, ok_e = _elem_from_step(A, B, lxx, lxu, luu, lx, lu, rho, eye_m)
    # element k composed with every step after it
    F, f, C, Jm, eta = associative_scan(_combine, elems, reverse=True)
    # close each suffix against the terminal cost-to-go:
    # P_k = J_k + Fᵀ(I + P_N C)⁻¹ P_N F, and the same closure for p
    PN, pN = exp.lxx[N], exp.lx[N]
    Minv = torch.linalg.solve(eye_n + PN @ C, eye_n.expand_as(C))
    P = torch.cat([Jm + F.mT @ (Minv @ PN) @ F, PN[None]])
    p = torch.cat([-eta + _mv(F.mT @ Minv, pN + _mv(PN, f)), pN[None]])
    # the gains from P_{k+1}, p_{k+1}, as the sequential pass takes them
    Pn, pn = P[1:], p[1:]
    Qxu = lxu + A.mT @ Pn @ B
    Quu = luu + B.mT @ (Pn @ B)
    Qu = lu + _mv(B.mT, pn)
    L, ok_g = _chol(Quu + rho * eye_m, eye_m)
    K = -torch.cholesky_solve(Qxu.mT, L)
    d = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
    dV1 = (d * Qu).sum()
    dV2 = 0.5 * (d * _mv(Quu, d)).sum()
    # gain-magnitude guard (SolverOptions.bp_gain_limit), NaN-safe
    gains_ok = (K.abs().amax() <= gain_limit) & (d.abs().amax() <= gain_limit)
    failed = ~ok_e.all() | ~ok_g.all() | ~torch.isfinite(P).all() | ~gains_ok
    return K, d, P, p, dV1, dV2, failed


def backward_pass_pscan(exp: Expansions, rho, drho, opts: SolverOptions) -> BackwardPassResult:
    """Backward pass by associative scan, with the retry loop and result of
    `solver/riccati.py:backward_pass`: each failed attempt raises ρ, and
    the pass gives up after `bp_reg_fail_threshold` attempts at the
    largest ρ.  One host synchronisation per attempt (`attempts`)."""
    rho = torch.as_tensor(rho, dtype=exp.A.dtype, device=exp.A.device)
    drho = torch.as_tensor(drho, dtype=exp.A.dtype, device=exp.A.device)
    count = attempts = 0
    while True:
        K, d, P, p, dV1, dV2, failed = _sweep(exp, rho, opts.bp_gain_limit)
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

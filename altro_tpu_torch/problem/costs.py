"""Cost functions and their second-order expansions
(`altro_tpu/problem/costs.py`).

A cost is a function ``fn(params, x, u) -> scalar``.  Expansions come from
`torch.func` AD by default; `QuadraticCost` overrides ``expand_fn`` since
its Hessian is its own parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd


@dataclasses.dataclass(frozen=True)
class CostExpansionTerms:
    """Second-order expansion of one knot's cost (`cost_expansion.hpp:26-141`)."""

    J: torch.Tensor
    lx: torch.Tensor
    lu: torch.Tensor
    lxx: torch.Tensor
    lxu: torch.Tensor  # [n, m] cross term
    luu: torch.Tensor

    def replace(self, **updates) -> "CostExpansionTerms":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class Cost:
    """A cost term ``fn(params, x, u) -> scalar``; ``expand_fn(params, x, u)
    -> CostExpansionTerms`` optionally overrides the AD expansion."""

    params: Any
    fn: Callable
    expand_fn: Optional[Callable] = None
    name: str = "cost"

    def __call__(self, x, u):
        return self.fn(self.params, x, u)

    def expand(self, x, u) -> CostExpansionTerms:
        if self.expand_fn is not None:
            return self.expand_fn(self.params, x, u)
        return ad_expansion(self.fn, self.params, x, u)

    def replace(self, **updates) -> "Cost":
        return dataclasses.replace(self, **updates)


def ad_expansion(fn: Callable, params, x, u) -> CostExpansionTerms:
    """Value, gradient and Hessian by forward-over-reverse AD."""
    J = fn(params, x, u)
    g = grad(fn, argnums=(1, 2))
    lx, lu = g(params, x, u)
    (lxx, lxu), (_, luu) = jacfwd(g, argnums=(1, 2))(params, x, u)
    return CostExpansionTerms(J=J, lx=lx, lu=lu, lxx=lxx, lxu=lxu, luu=luu)


def _quadcost_eval(params, x, u):
    Q, R, H, q, r, c = (
        params["Q"], params["R"], params["H"], params["q"], params["r"], params["c"],
    )
    # 0.5 x'Qx + x'Hu + 0.5 u'Ru + q'x + r'u + c  (`quadratic_cost.cpp:8-11`)
    return (
        0.5 * x @ (Q @ x)
        + x @ (H @ u)
        + 0.5 * u @ (R @ u)
        + q @ x
        + r @ u
        + c
    )


def _quadcost_expand(params, x, u):
    Q, R, H, q, r = params["Q"], params["R"], params["H"], params["q"], params["r"]
    J = _quadcost_eval(params, x, u)
    # `quadratic_cost.cpp:14-28`
    lx = Q @ x + q + H @ u
    lu = R @ u + r + H.T @ x
    return CostExpansionTerms(J=J, lx=lx, lu=lu, lxx=Q, lxu=H, luu=R)


def _as(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def quadratic_cost(Q, R, H=None, q=None, r=None, c=0.0, *, validate=True) -> Cost:
    """General quadratic cost ½xᵀQx + xᵀHu + ½uᵀRu + qᵀx + rᵀu + c.

    Params take Q's dtype and device."""
    Q = torch.as_tensor(Q)
    R = _as(R, Q)
    n, m = Q.shape[0], R.shape[0]
    H = Q.new_zeros((n, m)) if H is None else _as(H, Q)
    q = Q.new_zeros((n,)) if q is None else _as(q, Q)
    r = Q.new_zeros((m,)) if r is None else _as(r, Q)
    c = _as(c, Q)
    if validate:
        _validate_quadratic(Q.detach().cpu().numpy(), R.detach().cpu().numpy())
    params = {"Q": Q, "R": R, "H": H, "q": q, "r": r, "c": c}
    return Cost(
        params=params, fn=_quadcost_eval, expand_fn=_quadcost_expand, name="quadratic"
    )


def _validate_quadratic(Q: np.ndarray, R: np.ndarray) -> None:
    """Symmetry / semidefiniteness checks (`quadratic_cost.cpp:30-63`)."""
    if not (np.allclose(Q, Q.T) and np.allclose(R, R.T)):
        raise ValueError("Q and R must be symmetric")
    if np.any(np.linalg.eigvalsh(Q.astype(np.float64)) < -1e-10):
        raise ValueError("Q must be positive semi-definite")


def lqr_cost(Q, R, xref, uref=None, *, terminal: bool = False, validate=True) -> Cost:
    """Tracking cost ½‖x−xref‖²_Q + ½‖u−uref‖²_R (`quadratic_cost.hpp:29-39`)."""
    Q = torch.as_tensor(Q)
    R = _as(R, Q)
    xref = _as(xref, Q)
    uref = Q.new_zeros((R.shape[0],)) if uref is None else _as(uref, Q)
    q = -(Q @ xref)
    r = -(R @ uref)
    c = 0.5 * xref @ (Q @ xref) + 0.5 * uref @ (R @ uref)
    if validate and not terminal:
        if np.any(np.linalg.eigvalsh(R.detach().cpu().numpy().astype(np.float64)) <= 0):
            raise ValueError("R must be positive definite for a non-terminal cost")
    return quadratic_cost(Q, R, None, q, r, c, validate=validate)

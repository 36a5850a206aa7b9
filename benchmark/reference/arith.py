"""Arithmetic of the plain reference: its scalar type, its matrix products
and the small dense factorizations.

`Arith(torch.float64)` is the reference.  `Arith(torch.bfloat16)` is the
benchmark's control: the reference computed in the nearest precision below
the float32 that the configurations state for their kernels' scalar
arithmetic.
"""
from __future__ import annotations

import torch

class Arith:
    def __init__(self, dtype: torch.dtype = torch.float64):
        self.dtype = dtype

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Batched matrix product (broadcasting)."""
        return torch.matmul(a, b)

    def mv(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """[..., r, c] @ [..., c] -> [..., r]."""
        return self.mm(a, v[..., None])[..., 0]

    def quad(self, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """vᵀ M v over the last axis."""
        return (v * self.mv(M, v)).sum(dim=-1)


_LAPACK = (torch.float32, torch.float64)


def cholesky(M: torch.Tensor):
    """Lower Cholesky factor of [..., m, m].  Returns (L, failed [...]): a
    lane fails where the matrix is not positive definite or the factor is
    not finite.  Types without a library factorization (bfloat16) take the
    textbook recursion in their own arithmetic."""
    if M.dtype in _LAPACK:
        L, info = torch.linalg.cholesky_ex(M)
        return L, (info != 0) | ~torch.isfinite(L).flatten(-2).all(dim=-1)
    m = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(m):
        piv = M[..., j, j] - (L[..., j, :j] ** 2).sum(dim=-1)
        ljj = torch.sqrt(torch.where(piv > 0, piv, torch.full_like(piv, float("nan"))))
        L[..., j, j] = ljj
        for i in range(j + 1, m):
            L[..., i, j] = (M[..., i, j] - (L[..., i, :j] * L[..., j, :j]).sum(dim=-1)) / ljj
    return L, ~torch.isfinite(L).flatten(-2).all(dim=-1)


def cholesky_solve(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Solve L Lᵀ X = R for X, L [..., m, m], R [..., m, c]."""
    if L.dtype in _LAPACK:
        return torch.cholesky_solve(R, L)
    m = L.shape[-1]
    Y = torch.zeros_like(R)
    for i in range(m):
        Y[..., i, :] = (R[..., i, :] - (L[..., i, :i, None] * Y[..., :i, :]).sum(dim=-2)) / L[..., i, i, None]
    X = torch.zeros_like(R)
    for i in reversed(range(m)):
        X[..., i, :] = (Y[..., i, :] - (L[..., i + 1:, i, None] * X[..., i + 1:, :]).sum(dim=-2)) / L[..., i, i, None]
    return X

"""The terminal goal x_N = xf, an equality on every state (altro-cpp
`constraints/constraint.hpp` GoalConstraint)."""
import torch

KNOTS = "terminal"
EQUALITY = True


def build(entry, n, m, xf, vec):
    return dict(target=xf if entry.get("target") is None else vec(entry["target"], n))


def rows(data, n, m):
    return n


def value(data, x, u):
    return x - data["target"]


def al_terms(data, x, u, lam, rho):
    s = lam - rho[..., None] * value(data, x, u)
    J = ((s * s).sum(-1) - (lam * lam).sum(-1)) / (2.0 * rho)
    H = rho[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return J, dict(lx=-s, lxx=H)

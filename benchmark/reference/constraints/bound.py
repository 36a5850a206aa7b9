"""Control bounds lb ≤ u ≤ ub at every stage knot: rows lb − u, then
u − ub (altro-cpp `constraints/constraint.hpp` ControlBound)."""
import torch

KNOTS = "stage"
EQUALITY = False


def build(entry, n, m, xf, vec):
    return dict(lower=vec(entry["lower"], m), upper=vec(entry["upper"], m))


def rows(data, n, m):
    return 2 * m


def value(data, x, u):
    return torch.cat([data["lower"] - u, u - data["upper"]], dim=-1)


def al_terms(data, x, u, lam, rho):
    """Value, gradient and Gauss-Newton Hessian in u
    (`constraint_values.hpp:111-177`)."""
    m = u.shape[-1]
    c = value(data, x, u)
    s = lam - rho[..., None] * c
    lp = torch.clamp(s, max=0.0)
    J = ((lp * lp).sum(-1) - (lam * lam).sum(-1)) / (2.0 * rho)
    act = (s <= 0).to(u.dtype)  # the orthant's projection Jacobian
    g = lp[..., :m] - lp[..., m:]  # -Cuᵀ λp with Cu = [-I; I]
    H = torch.diag_embed(rho[..., None] * (act[..., :m] + act[..., m:]))
    return J, dict(lu=g, luu=H)

"""Keep-out circles on two state entries, one row a circle:
−((x − cx)² + (y − cy)² − r²) ≤ 0, with (x, y) the state's entries
`x_index`, `y_index` (altro-cpp `examples/obstacle_constraints.hpp:15-127`,
CircleConstraint).

altro-cpp puts these rows at knots 1..N-1 (`examples/problems/
unicycle.cpp:54-58`); here they stand, as every stage kind does, at knots
0..N-1.  At knot 0 the state is the fixed x0, which in every configuration
that uses this kind lies well outside each circle (the three-obstacle fleet's
x0 are at most 0.14 m from the origin, whose nearest centre is 1.06 m away,
so they clear the 0.425 m radius by at least 0.49 m): its rows are negative
there, and with λ = 0 they stay inactive, add no cost or gradient, and keep
λ = 0 through every dual update.
"""
import torch

KNOTS = "stage"
EQUALITY = False


def build(entry, n, m, xf, vec):
    cx = vec(entry["cx"], 1)
    rows = cx.shape[0]
    return dict(cx=cx, cy=vec(entry["cy"], rows), r=vec(entry["r"], rows),
                xi=int(entry["x_index"]), yi=int(entry["y_index"]))


def rows(data, n, m):
    return data["cx"].shape[0]


def _offsets(data, x):
    return x[..., data["xi"], None] - data["cx"], x[..., data["yi"], None] - data["cy"]


def value(data, x, u):
    dx, dy = _offsets(data, x)
    return -(dx * dx + dy * dy - data["r"] * data["r"])


def al_terms(data, x, u, lam, rho):
    """Value, gradient and Gauss-Newton Hessian in x
    (`constraint_values.hpp:111-177`): the rows' Jacobian in x has
    −2(x − cx) and −2(y − cy) in the columns `x_index`, `y_index`."""
    dx, dy = _offsets(data, x)
    c = -(dx * dx + dy * dy - data["r"] * data["r"])
    s = lam - rho[..., None] * c
    lp = torch.clamp(s, max=0.0)
    J = ((lp * lp).sum(-1) - (lam * lam).sum(-1)) / (2.0 * rho)
    act = (s <= 0).to(x.dtype)  # the orthant's projection Jacobian
    Cx = torch.zeros(c.shape + (x.shape[-1],), dtype=x.dtype, device=x.device)
    Cx[..., data["xi"]] = -2.0 * dx
    Cx[..., data["yi"]] = -2.0 * dy
    g = -(lp[..., None] * Cx).sum(-2)
    H = rho[..., None, None] * ((act[..., None] * Cx).transpose(-1, -2) @ Cx)
    return J, dict(lx=g, lxx=H)

"""Constraints and cones for the augmented-Lagrangian solver
(`altro_tpu/problem/constraints.py`).

The cones the reference ships are elementwise (Zero / Identity /
NegativeOrthant), so their projection Jacobians are diagonal; the
second-order (Lorentz) cone rounds out the conic AL and has a dense p×p
one (`cone_jacobian`).  The batched solver applies all four in `_al_terms`
(the SOC through `solver/batched.py:soc_project_bl` / `soc_jacobian_bl`,
the batch-last forms of `cone_project` / `cone_jacobian`).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap


class Cone(enum.Enum):
    """Constraint cone tags (values as in `altro_tpu.problem.constraints`).

    ZERO:  equality g(x,u) = 0      (`constraint.hpp:28-49`)
    NEGATIVE_ORTHANT: h(x,u) <= 0   (`constraint.hpp:98-122`)
    IDENTITY: whole space (dual of ZERO, `constraint.hpp:65-86`)
    SECOND_ORDER: ‖c[:-1]‖₂ ≤ c[-1] (Lorentz cone, self-dual; thrust and
        friction cones).  The reference's interface is written for general
        cones (`docs/Overview.dox:29-43`) but ships only the first three.
    """

    ZERO = 0
    NEGATIVE_ORTHANT = 1
    IDENTITY = 2
    SECOND_ORDER = 3


EQUALITY = Cone.ZERO
INEQUALITY = Cone.NEGATIVE_ORTHANT


def dual_cone(cone: Cone) -> Cone:
    if cone is Cone.ZERO:
        return Cone.IDENTITY
    if cone is Cone.IDENTITY:
        return Cone.ZERO
    return cone  # NEGATIVE_ORTHANT and SECOND_ORDER are self-dual


def cone_project(cone: Cone, x):
    """Projection onto the cone (`constraint.hpp:34,77,103`); x [p]."""
    if cone is Cone.ZERO:
        return torch.zeros_like(x)
    if cone is Cone.IDENTITY:
        return x
    if cone is Cone.SECOND_ORDER:
        return _soc_project(x)
    return torch.minimum(x, torch.zeros_like(x))


def _soc_project(x):
    """Projection onto the Lorentz cone {(v, s): ‖v‖ ≤ s}, s = x[-1]."""
    v = x[:-1]
    s = x[-1]
    a = torch.linalg.vector_norm(v)
    inside = a <= s
    polar = a <= -s
    scale = 0.5 * (1.0 + s / torch.clamp(a, min=1e-300))
    boundary = torch.cat([scale * v, (0.5 * (a + s))[None]])
    return torch.where(inside, x, torch.where(polar, torch.zeros_like(x), boundary))


def cone_is_diagonal(cone: Cone) -> bool:
    """Whether the projection Jacobian is diagonal (all reference cones are)."""
    return cone is not Cone.SECOND_ORDER


def cone_jacobian_diag(cone: Cone, x):
    """Diagonal of the projection Jacobian (`constraint.hpp:39,82,108`);
    1 where x <= 0 for the negative orthant, as the reference has it.
    Diagonal cones only: the SOC's is `cone_jacobian`."""
    if cone is Cone.ZERO:
        return torch.zeros_like(x)
    if cone is Cone.IDENTITY:
        return torch.ones_like(x)
    if cone is Cone.SECOND_ORDER:
        raise ValueError("SOC projection Jacobian is not diagonal")
    return torch.where(x > 0, 0.0, 1.0).to(x.dtype)


def cone_jacobian(cone: Cone, x):
    """Full projection Jacobian [p, p]."""
    if cone is not Cone.SECOND_ORDER:
        return torch.diag(cone_jacobian_diag(cone, x))
    p = x.shape[-1]
    v = x[:-1]
    s = x[-1]
    norm = torch.linalg.vector_norm(v)
    a = torch.clamp(norm, min=1e-300)
    inside = norm <= s
    polar = norm <= -s
    c = 0.5 + s / (2.0 * a)
    eye_v = torch.eye(p - 1, dtype=x.dtype, device=x.device)
    dPv_dv = c * eye_v - (s / (2.0 * a**3)) * torch.outer(v, v)
    dPv_ds = v / (2.0 * a)
    top = torch.cat([dPv_dv, dPv_ds[:, None]], dim=1)
    bot = torch.cat([dPv_ds, x.new_full((1,), 0.5)])[None, :]
    boundary = torch.cat([top, bot], dim=0)
    eye = torch.eye(p, dtype=x.dtype, device=x.device)
    return torch.where(inside, eye, torch.where(polar, torch.zeros_like(eye), boundary))


def cone_project_rows(cone: Cone, M):
    """Project each row of [..., p] onto the cone: elementwise cones at
    once, the SOC row by row."""
    if cone is not Cone.SECOND_ORDER:
        return cone_project(cone, M)
    flat = M.reshape((-1, M.shape[-1]))
    return vmap(_soc_project)(flat).reshape(M.shape)


def cone_violation(cone: Cone, c):
    """Elementwise violation |c − Π_K(c)| (`constraint_values.hpp:215-220`)
    of stacked rows [..., p]."""
    return (c - cone_project_rows(cone, c)).abs()


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A constraint term ``fn(params, x, u) -> c`` with ``c ∈ cone`` required.

    ``structure`` tags the algebraic form of canned constraints
    (("goal",), ("control_bound", lo, hi), ("circle", xi, yi)) so the
    fused kernels can evaluate them; None means an opaque function (eager
    path only).
    """

    params: Any
    fn: Callable
    cone: Cone
    dim: int
    jac_fn: Optional[Callable] = None
    label: str = "constraint"
    structure: Optional[tuple] = None

    def __call__(self, x, u):
        return self.fn(self.params, x, u)

    def jacobian(self, x, u):
        if self.jac_fn is not None:
            return self.jac_fn(self.params, x, u)
        return jacfwd(self.fn, argnums=(1, 2))(self.params, x, u)

    def replace(self, **updates) -> "Constraint":
        return dataclasses.replace(self, **updates)


def _goal_eval(params, x, u):
    del u
    return x - params["xf"]


def goal_constraint(xf) -> Constraint:
    """Terminal goal x == xf (`basic_constraints.hpp:15-40`)."""
    xf = torch.as_tensor(xf)
    return Constraint(
        params={"xf": xf},
        fn=_goal_eval,
        cone=EQUALITY,
        dim=int(xf.shape[-1]),
        label="Goal Constraint",
        structure=("goal",),
    )


def _rows(idx: tuple):
    """An index of the rows `idx`: a slice where they are contiguous, else
    a list."""
    if not idx:
        return slice(0, 0)
    if idx == tuple(range(idx[0], idx[0] + len(idx))):
        return slice(idx[0], idx[0] + len(idx))
    return list(idx)


def control_bound(lb, ub) -> Constraint:
    """Box bound lb <= u <= ub in inequality-cone form
    (`basic_constraints.hpp:42-151`).  Only finite bounds produce rows,
    lower bounds first, then upper."""
    lb_t = torch.as_tensor(lb)
    ub_t = torch.as_tensor(ub)
    dtype = torch.promote_types(lb_t.dtype, ub_t.dtype)
    device = lb_t.device
    lb_np = lb_t.detach().cpu().numpy().astype(np.float64)
    ub_np = ub_t.detach().cpu().numpy().astype(np.float64)
    if lb_np.shape != ub_np.shape:
        raise ValueError("Upper and lower bounds must have the same length")
    if np.any(lb_np > ub_np):
        raise ValueError("Lower bound isn't less than the upper bound")
    lo_idx = tuple(int(i) for i in np.flatnonzero(np.isfinite(lb_np)))
    hi_idx = tuple(int(i) for i in np.flatnonzero(np.isfinite(ub_np)))
    dim = len(lo_idx) + len(hi_idx)
    if dim == 0:
        raise ValueError("Control bound has no finite bounds")
    # basic slices where the rows are contiguous (every finite bound, the
    # usual case): a list index is copied to the device on every call, and
    # a host-to-device copy waits for the device's queue
    lo_arr = _rows(lo_idx)
    hi_arr = _rows(hi_idx)

    def eval_fn(params, x, u):
        del x
        lower = params["lb"][lo_arr] - u[lo_arr]
        upper = u[hi_arr] - params["ub"][hi_arr]
        return torch.cat([lower, upper])

    params = {
        "lb": torch.as_tensor(
            np.where(np.isfinite(lb_np), lb_np, 0.0), dtype=dtype, device=device
        ),
        "ub": torch.as_tensor(
            np.where(np.isfinite(ub_np), ub_np, 0.0), dtype=dtype, device=device
        ),
    }
    return Constraint(
        params=params, fn=eval_fn, cone=INEQUALITY, dim=dim,
        label="Control Bound", structure=("control_bound", lo_idx, hi_idx),
    )


def circle_constraint(cx, cy, radius, x_index: int = 0, y_index: int = 1) -> Constraint:
    """Keep-out circles: −(‖p−c‖² − r²) <= 0 per obstacle, p the state's
    entries (x_index, y_index) (`obstacle_constraints.hpp:75-127`)."""
    cx = torch.atleast_1d(torch.as_tensor(cx))
    cy = torch.atleast_1d(torch.as_tensor(cy, dtype=cx.dtype, device=cx.device))
    radius = torch.atleast_1d(torch.as_tensor(radius, dtype=cx.dtype, device=cx.device))

    def eval_fn(params, x, u):
        del u
        px = x[x_index]
        py = x[y_index]
        d2 = (px - params["cx"]) ** 2 + (py - params["cy"]) ** 2 - params["r"] ** 2
        return -d2

    return Constraint(
        params={"cx": cx, "cy": cy, "r": radius},
        fn=eval_fn,
        cone=INEQUALITY,
        dim=int(cx.shape[0]),
        label="Circle Constraint",
        structure=("circle", x_index, y_index),
    )

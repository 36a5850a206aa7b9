"""Constraints and cones for the augmented-Lagrangian solver
(`altro_tpu/problem/constraints.py`).

The cones the reference ships are elementwise (Zero / Identity /
NegativeOrthant), so projection Jacobians are diagonal; the batched solver
applies them in `_al_terms`.  The second-order cone is not ported yet.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd


class Cone(enum.Enum):
    """Constraint cone tags (values as in `altro_tpu.problem.constraints`).

    ZERO:  equality g(x,u) = 0      (`constraint.hpp:28-49`)
    NEGATIVE_ORTHANT: h(x,u) <= 0   (`constraint.hpp:98-122`)
    IDENTITY: whole space (dual of ZERO, `constraint.hpp:65-86`)
    """

    ZERO = 0
    NEGATIVE_ORTHANT = 1
    IDENTITY = 2


EQUALITY = Cone.ZERO
INEQUALITY = Cone.NEGATIVE_ORTHANT


def dual_cone(cone: Cone) -> Cone:
    if cone is Cone.ZERO:
        return Cone.IDENTITY
    if cone is Cone.IDENTITY:
        return Cone.ZERO
    return cone  # NEGATIVE_ORTHANT is self-dual


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
    lo_arr = list(lo_idx)
    hi_arr = list(hi_idx)

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

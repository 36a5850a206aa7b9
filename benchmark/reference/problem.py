"""The plain reference's trajectory-optimisation problem, built from a
configuration file's `problem` block alone: model and integrator, horizon,
tracking costs and constraints, each model and constraint kind from its
own file (`models/`, `constraints/`).  Nothing here reads the program
under test.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from . import constraints as kinds
from .models import dynamics, rk4


@dataclasses.dataclass
class Problem:
    N: int
    n: int
    m: int
    h: float
    model: str
    params: dict
    x0: torch.Tensor  # [n] the canonical initial state
    xf: torch.Tensor  # [n] the goal: stage and terminal reference
    u0: torch.Tensor  # [m] the initial guess's constant control
    uref: torch.Tensor  # [m]
    Q: torch.Tensor  # [n, n] stage
    R: torch.Tensor  # [m, m] stage
    Qf: torch.Tensor  # [n, n] terminal
    constraints: dict  # {kind: its data}, in the configuration's order

    def to(self, dtype, device=None) -> "Problem":
        def cv(v):
            if torch.is_tensor(v):
                return v.to(dtype=dtype, device=device)
            if isinstance(v, dict):
                return {k: cv(x) for k, x in v.items()}
            return v
        return dataclasses.replace(self, **{f.name: cv(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def step(self, x, u):
        """x_{k+1} from x [..., n], u [..., m]."""
        return rk4(dynamics(self.model), self.params, x, u, self.h)

    def initial_controls(self, S: int) -> torch.Tensor:
        return self.u0.expand(S, self.N, self.m).clone()


def _vec(v, n) -> np.ndarray:
    a = np.asarray(v, dtype=np.float64)
    return np.full(n, float(a)) if a.ndim == 0 else a


def build(block: dict, dtype=torch.float64, device="cpu") -> Problem:
    """A `Problem` from a configuration's `problem` block (see the files
    under `benchmark/configs/`)."""
    n, m, N, tf = int(block["n"]), int(block["m"]), int(block["N"]), float(block["tf"])
    # altro-cpp computes h = tf / N in float32 (`unicycle.hpp:79`)
    h = float(np.float32(tf) / np.float32(N)) if block.get("h_in_float32") else tf / N
    cost = block["cost"]
    scale = h if cost.get("stage_weights_times_h") else 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)  # noqa: E731
    xf = _vec(block["xf"], n)
    vec = lambda v, size: t(_vec(v, size))  # noqa: E731
    return Problem(
        N=N, n=n, m=m, h=h, model=block["model"],
        params={k: t(v) for k, v in block.get("model_params", {}).items()},
        x0=t(_vec(block["x0"], n)), xf=t(xf), u0=t(_vec(block["u0"], m)), uref=t(_vec(block["uref"], m)),
        Q=t(np.diag(_vec(cost["Q_diag"], n) * scale)), R=t(np.diag(_vec(cost["R_diag"], m) * scale)),
        Qf=t(np.diag(_vec(cost["Qf_diag"], n))),
        constraints={k: kinds.kind(k).build(entry, n, m, t(xf), vec) for k, entry in block["constraints"].items()},
    )

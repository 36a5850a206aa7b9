"""Kinematic unicycle model (`altro_tpu/models/unicycle.py`).

States (x, y, θ); controls (v, ω); ẋ = v cosθ, ẏ = v sinθ, θ̇ = ω.  The
fused CUDA kernels evaluate the same model, and its continuous Jacobian,
through the device functor `csrc/models.cuh:Unicycle`, named here by
`CUDA_MODEL`.
"""
from __future__ import annotations

import torch

from ..problem.dynamics import ContinuousModel, DiscreteModel, discretize

NSTATES = 3
NCONTROLS = 2
CUDA_MODEL = "unicycle"


def _unicycle_dynamics(params, x, u, t):
    del params, t
    theta = x[2]
    v = u[0]
    omega = u[1]
    return torch.stack([v * torch.cos(theta), v * torch.sin(theta), omega])


def unicycle() -> ContinuousModel:
    return ContinuousModel(
        params=None, fn=_unicycle_dynamics, n=NSTATES, m=NCONTROLS,
        name="unicycle", cuda_model=CUDA_MODEL,
    )


def unicycle_rk4() -> DiscreteModel:
    """RK4-discretized unicycle (`examples/problems/unicycle.hpp:33`)."""
    return discretize(unicycle(), "rk4")

"""Cartpole model: 4 states, 1 control; the classic swing-up benchmark
(`altro_tpu/models/cartpole.py`).

State x = [p, θ, ṗ, θ̇] with θ=0 down, θ=π up; control = cart force.  Takes
x [4] and a batch-last x [4, B] alike.  The fused CUDA kernels evaluate the
same model through the device functor `csrc/models.cuh:Cartpole`, named
here by `CUDA_MODEL`, with its Jacobian by forward-mode differentiation.
"""
from __future__ import annotations

import torch

from ..problem.dynamics import ContinuousModel, DiscreteModel, discretize
from ..types import default_device

NSTATES = 4
NCONTROLS = 1
CUDA_MODEL = "cartpole"


def _cartpole_dynamics(params, x, u, t):
    del t
    mc = params["mass_cart"]
    mp = params["mass_pole"]
    l = params["length"]  # noqa: E741
    g = params["gravity"]
    theta = x[1]
    pdot = x[2]
    thdot = x[3]
    f = u[0]
    s, c = torch.sin(theta), torch.cos(theta)
    denom = mc + mp * s**2
    pddot = (f + mp * s * (l * thdot**2 + g * c)) / denom
    thddot = (-f * c - mp * l * thdot**2 * c * s - (mc + mp) * g * s) / (l * denom)
    return torch.stack([pdot, thdot, pddot, thddot])


def cartpole(
    mass_cart: float = 1.0,
    mass_pole: float = 0.3,
    length: float = 0.5,
    gravity: float = 9.81,
    *,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str | None = None,
) -> ContinuousModel:
    """Params in `dtype` on `device` (the card unless given)."""
    dev = default_device(device)
    params = {
        name: torch.as_tensor(val, dtype=dtype, device=dev)
        for name, val in (
            ("mass_cart", mass_cart), ("mass_pole", mass_pole),
            ("length", length), ("gravity", gravity),
        )
    }
    return ContinuousModel(
        params=params, fn=_cartpole_dynamics, n=NSTATES, m=NCONTROLS, name="cartpole",
        cuda_model=CUDA_MODEL,
    )


def cartpole_rk4(**kwargs) -> DiscreteModel:
    return discretize(cartpole(**kwargs), "rk4")

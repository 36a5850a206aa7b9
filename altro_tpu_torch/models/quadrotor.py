"""Quadrotor model: 13 states, 4 rotor thrusts (`altro_tpu/models/quadrotor.py`).

State  x = [p(3), q(4, wxyz unit quaternion), v(3, world), ω(3, body)]
Input  u = [f1..f4] rotor thrusts (N).

Every operation is component-wise in the leading (state) axis, so the
model takes x [13] and a batch-last x [13, B] alike.  The fused CUDA
kernels evaluate the same model through the device functor
`csrc/models.cuh:Quadrotor`, named here by `CUDA_MODEL`, with its Jacobian
by forward-mode differentiation.
"""
from __future__ import annotations

import torch

from ..problem.dynamics import ContinuousModel, DiscreteModel, discretize
from ..types import default_device

NSTATES = 13
NCONTROLS = 4
CUDA_MODEL = "quadrotor"


def _quat_multiply(q, r):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = r
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _cross3(a, b):
    """Cross product over the leading axis."""
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def _quat_rotate(q, v):
    """Rotate vector v by unit quaternion q (body -> world)."""
    w = q[0]
    u = q[1:]
    return v + 2.0 * _cross3(u, _cross3(u, v) + w * v)


def _quadrotor_dynamics(params, x, u, t):
    del t
    mass = params["mass"]
    J = params["J"]  # diagonal inertia [3]
    g = params["gravity"]
    kf = params["kf"]  # thrust coefficient
    km = params["km"]  # moment coefficient
    L = params["arm_length"]

    q = x[3:7]
    v = x[7:10]
    omega = x[10:13]
    zero = torch.zeros_like(x[0])

    F = kf * u  # rotor thrusts
    thrust_body = torch.stack([zero, zero, F.sum(dim=0)])
    # torques: rotors at +x, +y, -x, -y arms; alternating spin directions
    tau = torch.stack(
        [
            L * kf * (u[1] - u[3]),
            L * kf * (u[2] - u[0]),
            km * (u[0] - u[1] + u[2] - u[3]),
        ]
    )

    pdot = v
    qdot = 0.5 * _quat_multiply(q, torch.cat([zero[None], omega], dim=0))
    g_vec = torch.stack([zero, zero, zero - g])
    vdot = g_vec + _quat_rotate(q, thrust_body) / mass
    Jw = torch.stack([J[i] * omega[i] for i in range(3)])
    wnum = tau - _cross3(omega, Jw)
    wdot = torch.stack([wnum[i] / J[i] for i in range(3)])
    return torch.cat([pdot, qdot, vdot, wdot], dim=0)


def quadrotor(
    mass: float = 0.5,
    J=(0.0023, 0.0023, 0.004),
    gravity: float = 9.81,
    kf: float = 1.0,
    km: float = 0.0245,
    arm_length: float = 0.1750,
    *,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str | None = None,
) -> ContinuousModel:
    """Params in `dtype` on `device` (the card unless given)."""
    dev = default_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    params = {
        "mass": t(mass), "J": t(J), "gravity": t(gravity),
        "kf": t(kf), "km": t(km), "arm_length": t(arm_length),
    }
    return ContinuousModel(
        params=params, fn=_quadrotor_dynamics, n=NSTATES, m=NCONTROLS, name="quadrotor",
        cuda_model=CUDA_MODEL,
    )


def quadrotor_rk4(**kwargs) -> DiscreteModel:
    return discretize(quadrotor(**kwargs), "rk4")


def hover_state(position=(0.0, 0.0, 1.0), *, dtype=torch.float64, device=None) -> torch.Tensor:
    """Hover state at a position: identity attitude, zero rates."""
    dev = default_device(device)
    return torch.cat(
        [
            torch.as_tensor(position, dtype=dtype, device=dev),
            torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev),
            torch.zeros(6, dtype=dtype, device=dev),
        ]
    )


def hover_controls(
    mass: float = 0.5, gravity: float = 9.81, kf: float = 1.0, *, dtype=torch.float64, device=None,
) -> torch.Tensor:
    """Per-rotor thrust that exactly cancels gravity."""
    return torch.full((4,), mass * gravity / (4.0 * kf), dtype=dtype, device=default_device(device))

"""Triple-integrator model (`altro_tpu/models/triple_integrator.py`,
`examples/triple_integrator.cpp:9-45`).

State [pos(dof), vel(dof), acc(dof)], control = jerk(dof); linear dynamics.
Takes x [3·dof] and a batch-last x [3·dof, B] alike.  The fused CUDA
kernels evaluate it through the device functor
`csrc/models.cuh:TripleIntegrator<DOF>`, named `triple_integrator{dof}`;
they are instantiated for dof 2 (`TripleIntegratorProblem`'s default), and
another dof takes the fused path's fallback.
"""
from __future__ import annotations

import torch

from ..problem.dynamics import ContinuousModel, DiscreteModel, discretize


def _make_dynamics(dof: int):
    def fn(params, x, u, t):
        del params, t
        return torch.cat([x[dof: 2 * dof], x[2 * dof: 3 * dof], u], dim=0)

    return fn


def triple_integrator(dof: int = 1) -> ContinuousModel:
    if dof <= 0:
        raise ValueError("The degrees of freedom must be greater than 0")
    return ContinuousModel(
        params=None, fn=_make_dynamics(dof), n=3 * dof, m=dof, name=f"triple_integrator{dof}",
        cuda_model=f"triple_integrator{dof}",
    )


def triple_integrator_rk4(dof: int = 1) -> DiscreteModel:
    return discretize(triple_integrator(dof), "rk4")

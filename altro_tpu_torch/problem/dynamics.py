"""Dynamics models and explicit integrators (`altro_tpu/problem/dynamics.py`).

Models are functions ``f(params, x, u, t) -> xdot`` on per-instance tensors;
the discrete Jacobian is forward-mode AD of the integrator step
(`torch.func.jacfwd`), the same chain rule the reference hand-derives for
RK4 (`integration.hpp:132-169`).

The batched solver evaluates a model on batch-last tensors (x [n, B],
u [m, B]), so a model indexes states and controls along their first axis
(`x[2]`, not `x[..., 2]`) and then takes one instance or a whole batch alike.
A model that the CUDA kernels can take also names its device functor
(`cuda_model`, e.g. "unicycle" for `csrc/models.cuh:Unicycle`); every other
model runs on the eager path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import hessian, jacfwd


@dataclasses.dataclass(frozen=True)
class ContinuousModel:
    """A continuous-time dynamical system ``xdot = fn(params, x, u, t)``."""

    params: Any
    fn: Callable
    n: int
    m: int
    name: str = "continuous"
    cuda_model: Optional[str] = None

    def __call__(self, x, u, t):
        return self.fn(self.params, x, u, t)

    def hessian_vp(self, x, u, t, b):
        """The Hessian of the b-weighted dynamics, ∂²(bᵀf)/∂(x,u)², over the
        stacked z = (x, u): (n+m)×(n+m).  The reference's
        `FunctionBase::Hessian` (`altro/common/functionbase.hpp:53-87`);
        the solver, Gauss-Newton as the reference's, does not use it."""
        return _hessian_vp(lambda x_, u_: self.fn(self.params, x_, u_, t), x, u, b)

    def replace(self, **updates) -> "ContinuousModel":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class DiscreteModel:
    """A discrete-time system ``x_{k+1} = fn(params, x, u, t, h)``.

    ``jac_fn(params, x, u, t, h) -> (A, B)`` defaults to forward-mode AD.
    """

    params: Any
    fn: Callable
    n: int
    m: int
    jac_fn: Optional[Callable] = None
    name: str = "discrete"
    # set by `discretize()`: the batched solver and the kernels use the
    # explicit integrator chain rule over the continuous model
    continuous_fn: Optional[Callable] = None
    method: Optional[str] = None
    cuda_model: Optional[str] = None

    def __call__(self, x, u, t, h):
        return self.fn(self.params, x, u, t, h)

    def jacobian(self, x, u, t, h):
        """Discrete Jacobian (A [n,n], B [n,m])."""
        if self.jac_fn is not None:
            return self.jac_fn(self.params, x, u, t, h)
        return jacfwd(self.fn, argnums=(1, 2))(self.params, x, u, t, h)

    def hessian_vp(self, x, u, t, h, b):
        """∂²(bᵀf)/∂(x,u)² of the discrete step (see
        `ContinuousModel.hessian_vp`; the reference routes it through
        `DiscreteDynamics`, `problem/dynamics.hpp:167-186`)."""
        return _hessian_vp(lambda x_, u_: self.fn(self.params, x_, u_, t, h), x, u, b)

    def replace(self, **updates) -> "DiscreteModel":
        return dataclasses.replace(self, **updates)


def _hessian_vp(f: Callable, x, u, b):
    """One `torch.func.hessian` of z ↦ bᵀ f(z[:n], z[n:])."""
    x, u = torch.as_tensor(x), torch.as_tensor(u)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    return hessian(lambda z: b @ f(z[:n], z[n:]))(torch.cat([x, u.to(x.dtype)]))


def rk4_step(f: Callable, params, x, u, t, h):
    """Classic fourth-order Runge-Kutta step (`integration.hpp:123-131`)."""
    k1 = f(params, x, u, t)
    k2 = f(params, x + 0.5 * h * k1, u, t + 0.5 * h)
    k3 = f(params, x + 0.5 * h * k2, u, t + 0.5 * h)
    k4 = f(params, x + h * k3, u, t + h)
    return x + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def euler_step(f: Callable, params, x, u, t, h):
    """Explicit Euler step (`integration.hpp:90-94`)."""
    return x + h * f(params, x, u, t)


_INTEGRATORS = {"rk4": rk4_step, "euler": euler_step}


def discretize(model: ContinuousModel, method: str = "rk4") -> DiscreteModel:
    """Adapt a continuous model into a discrete one
    (`discretized_model.hpp:25-65`)."""
    try:
        step = _INTEGRATORS[method]
    except KeyError:
        raise ValueError(
            f"Unknown integrator {method!r}; expected one of {sorted(_INTEGRATORS)}"
        ) from None
    cfn = model.fn

    def dfn(params, x, u, t, h):
        return step(cfn, params, x, u, t, h)

    return DiscreteModel(
        params=model.params,
        fn=dfn,
        n=model.n,
        m=model.m,
        name=f"{model.name}_{method}",
        continuous_fn=cfn,
        method=method,
        cuda_model=model.cuda_model,
    )

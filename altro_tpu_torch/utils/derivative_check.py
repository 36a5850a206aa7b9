"""Finite-difference derivative checker (`altro_tpu/utils/derivative_check.py`).

Test utility, the analog of `altro/utils/derivative_checker.hpp:10-138` and
the `FunctionBase::CheckJacobian/CheckHessian` helpers
(`common/functionbase.cpp:35-126`): there they validate hand-written
analytic derivatives; here they validate AD (`torch.func`) and any analytic
override a user supplies.  The callables get float64 CPU tensors and may
return tensors or arrays; the results are float64 numpy arrays.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy().astype(np.float64)
    return np.asarray(v, dtype=np.float64)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def finite_diff(f: Callable, x, eps: float = 1e-6, central: bool = True):
    """Finite-difference Jacobian of f: R^n -> R^p at x."""
    x = _np(x)
    f0 = _np(f(_t(x)))
    jac = np.zeros(f0.shape + x.shape)
    for i in range(x.size):
        dx = np.zeros_like(x)
        dx.flat[i] = eps
        if central:
            col = (_np(f(_t(x + dx))) - _np(f(_t(x - dx)))) / (2 * eps)
        else:
            col = (_np(f(_t(x + dx))) - f0) / eps
        jac[..., i] = col
    return jac


def finite_diff_jacobian(f: Callable, x, u, eps: float = 1e-6):
    """Jacobians (df/dx, df/du) of f(x, u) by central differences."""
    x, u = _np(x), _np(u)
    A = finite_diff(lambda x_: f(x_, _t(u)), x, eps)
    B = finite_diff(lambda u_: f(_t(x), u_), u, eps)
    return A, B


def finite_diff_gradient(f: Callable, x, eps: float = 1e-6):
    """Gradient of scalar f (`derivative_checker.hpp:94-101`)."""
    return finite_diff(lambda x_: _np(f(x_)).reshape(()), x, eps)


def finite_diff_hessian(f: Callable, x, eps: float = 1e-4):
    """Hessian of scalar f via nested differences
    (`derivative_checker.hpp:131-138`)."""
    return finite_diff(lambda x_: finite_diff_gradient(f, x_, eps), x, eps)

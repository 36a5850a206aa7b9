"""Plain dynamics of the benchmark's configurations, one file a model:
`<model>.py`, found by the name in a configuration's `problem.model`, holds
`dynamics(x, u, params)` on states and controls whose last axis is the
state or the control ([..., n], [..., m]).  Adding a model adds its file.
`rk4` is the classic step that discretizes them.
"""
from __future__ import annotations

import importlib


def dynamics(model: str):
    """The continuous dynamics of `model`, from `models/<model>.py`."""
    return importlib.import_module(f"{__name__}.{model}").dynamics


def rk4(f, params, x, u, h):
    """One classic fourth-order Runge-Kutta step of ẋ = f(x, u)."""
    k1 = f(x, u, params)
    k2 = f(x + 0.5 * h * k1, u, params)
    k3 = f(x + 0.5 * h * k2, u, params)
    k4 = f(x + h * k3, u, params)
    return x + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0

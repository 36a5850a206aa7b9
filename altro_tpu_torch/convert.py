"""Hand data of the JAX package to this package, so both compute on the same
inputs.

The functions take the JAX package's objects after their leaves were turned
into numpy arrays (for example with
`jax.tree_util.tree_map(numpy.asarray, tree)`); they read attributes and
dict keys only, so this module imports no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .problem.problem import ProblemParams
from .solver.batched import BatchedTrajectory
from .solver.functions import ConState
from .solver.mpc import MPCState
from .types import Trajectory


def tensor(a, device, dtype) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor; integer and bool arrays keep
    their kind, floating arrays take `dtype`."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)
    return torch.as_tensor(a, device=device)


def _tree(tree: Any, device, dtype):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, device, dtype) for v in tree)
    return tensor(tree, device, dtype)


def problem_params(params, device, dtype) -> ProblemParams:
    """The JAX package's `ProblemParams` as this package's."""
    return ProblemParams(
        x0=tensor(params.x0, device, dtype),
        dynamics=_tree(tuple(params.dynamics), device, dtype),
        costs=_tree(tuple(params.costs), device, dtype),
        constraints=_tree(tuple(params.constraints), device, dtype),
    )


def al_state(al, device, dtype) -> tuple:
    """A batch-last AL state: a tuple of {"lam" [nk,p,B], "rho" [nk,B]}."""
    return tuple(
        dict(lam=tensor(st["lam"], device, dtype), rho=tensor(st["rho"], device, dtype))
        for st in al
    )


def trajectory(Z, device, dtype) -> BatchedTrajectory:
    """A batch-last trajectory (X [N+1,n,B], U [N,m,B], t, h)."""
    return BatchedTrajectory(
        X=tensor(Z.X, device, dtype).contiguous(),
        U=tensor(Z.U, device, dtype).contiguous(),
        t=tensor(Z.t, device, dtype),
        h=tensor(Z.h, device, dtype),
    )


def expansions(exp, device, dtype) -> dict:
    """A batch-last expansion dict (A, B, lxx, lxu, luu, lx, lu, and costs
    where present), as `riccati_pallas` and `riccati_scan` take it."""
    return {key: tensor(val, device, dtype).contiguous() for key, val in exp.items()}


def instance_al_state(al, device, dtype) -> tuple:
    """A per-instance AL state: a tuple of `ConState` (lam [nk, p], rho [nk])."""
    return tuple(ConState(lam=tensor(st.lam, device, dtype), rho=tensor(st.rho, device, dtype)) for st in al)


def instance_trajectory(Z, device, dtype) -> Trajectory:
    """A per-instance trajectory (X [N+1, n], U [N, m], t, h)."""
    return Trajectory(X=tensor(Z.X, device, dtype), U=tensor(Z.U, device, dtype),
                      t=tensor(Z.t, device, dtype), h=tensor(Z.h, device, dtype))


def mpc_state(state, device, dtype) -> MPCState:
    """An `MPCState`: a per-instance one (X [N+1, n], `ConState` duals) or a
    batch-last one (X [N+1, n, B], dict duals), told apart by X's rank."""
    if np.ndim(state.Z.X) == 3:
        Z, al = trajectory(state.Z, device, dtype), al_state(state.al, device, dtype)
        iterations = tensor(state.iterations, device, dtype)
    else:
        Z, al = instance_trajectory(state.Z, device, dtype), instance_al_state(state.al, device, dtype)
        iterations = int(state.iterations)
    return MPCState(Z=Z, al=al, status=tensor(state.status, device, dtype).to(torch.int32),
                    iterations=iterations)

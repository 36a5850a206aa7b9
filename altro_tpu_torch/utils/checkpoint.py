"""Checkpoint and resume of solver state (`altro_tpu/utils/checkpoint.py`).

The reference has no serialization; a warm start is in-memory state
(`ilqr.hpp:222-235`, `al_solver.hpp:288-302`).  Every piece of the port's
solver state is an explicit structure of tensors (`Trajectory`,
`BatchedTrajectory`, the AL state tuples, `MPCState`, the stats), so a
checkpoint is generic: flatten to arrays in `jax.tree_util`'s order
(`utils/tree.py`), save them as `.npz`, restore them into the structure of
a `like`.  The file holds what the JAX package's `save_pytree` writes
(`leaf_0`, `leaf_1`, ... and `__treedef__`, a description that loading
ignores), so a file saved by either package loads into the other's `like`.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .tree import tree_flatten, tree_unflatten


def save_pytree(path, tree: Any) -> None:
    """Save a structure of tensor (or number) leaves to `path` (.npz).  A
    host int, such as `MPCState.iterations`, is saved as a 0-d array."""
    leaves, treedef = tree_flatten(tree)
    arrays = {
        f"leaf_{i}": leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        for i, leaf in enumerate(leaves)
    }
    arrays["__treedef__"] = np.frombuffer(str(treedef).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def _restore(saved: np.ndarray, ref):
    if torch.is_tensor(ref):
        return torch.as_tensor(saved, device=ref.device).to(ref.dtype)
    if isinstance(ref, bool):
        return bool(saved)
    if isinstance(ref, int):
        return int(saved)
    if isinstance(ref, float):
        return float(saved)
    return np.asarray(saved, getattr(ref, "dtype", None))


def load_pytree(path, like: Any) -> Any:
    """Load arrays saved by `save_pytree` into the structure of `like`.

    Each leaf takes the dtype and device of `like`'s leaf in its place; a
    host int or float leaf comes back as a Python number.  A file with
    another number of leaves raises ValueError."""
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    like_leaves, treedef = tree_flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(f"Checkpoint has {len(leaves)} leaves; structure expects {len(like_leaves)}")
    return tree_unflatten(treedef, [_restore(leaf, ref) for leaf, ref in zip(leaves, like_leaves)])

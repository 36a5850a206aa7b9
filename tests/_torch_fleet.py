"""Shared set-up of the port's tests: one unicycle fleet built with the JAX
package and handed to `altro_tpu_torch` through `convert`, so that both
packages compute on the same data."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from altro_tpu import SolverOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import convert
from altro_tpu_torch.models.problems import UnicycleProblem as TUnicycle

F64 = torch.float64


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@dataclasses.dataclass
class Fleet:
    """A JAX-side fleet (`*_j`) and the same data in the port (`*_t`)."""

    prob_j: object
    prob_t: object
    solver_j: object
    params_j: object
    params_t: object
    Z_j: object
    Z_t: object
    al_j: tuple
    al_t: tuple


def make_fleet(N, B, *, seed=0, spread=0.3, warm_al=True, rollout=True, opts=None):
    """The set-up of tests/test_backward_fused.py:22-54: x0 uniform in
    ±spread, the initial trajectory rolled out, and (warm_al) a random AL
    state with λ in [-0.5, 0] and ρ in [1, 10]."""
    defn = JUnicycle(dtype=jnp.float64)
    defn.N = N
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    prob_t = TUnicycle(dtype=F64, N=N).make_problem().compile()
    solver_j = JSolver(prob_j, opts or SolverOptions())
    rng = np.random.default_rng(seed)
    params_j = prob_j.params.replace(x0=jnp.asarray(rng.uniform(-spread, spread, (3, B))))
    Z0 = defn.initial_trajectory()
    Z_j = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0))
    if rollout:
        Z_j = solver_j.rollout(params_j, Z_j)
    al_j = solver_j.al_state_init(B, jnp.float64)
    if warm_al:
        al_j = tuple(
            dict(
                lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape)),
                rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)),
            )
            for st in al_j
        )
    return Fleet(
        prob_j=prob_j, prob_t=prob_t, solver_j=solver_j,
        params_j=params_j, params_t=convert.problem_params(numpy_tree(params_j), "cpu", F64),
        Z_j=Z_j, Z_t=convert.trajectory(numpy_tree(Z_j), "cpu", F64),
        al_j=al_j, al_t=convert.al_state(numpy_tree(al_j), "cpu", F64),
    )


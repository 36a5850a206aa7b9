"""Shared set-up of the port's tests: a unicycle fleet, and the model zoo's
quadrotor and cartpole fleets, built with the JAX package and handed to
`altro_tpu_torch` through `convert`, so that both packages compute on the
same data."""
import concurrent.futures
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import Problem, SolverOptions, control_bound, lqr_cost
from altro_tpu.models.cartpole import cartpole_rk4
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.models.quadrotor import hover_controls, hover_state, quadrotor_rk4
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.types import initial_trajectory
from altro_tpu_torch import convert
from altro_tpu_torch.models.problems import UnicycleProblem as TUnicycle

F64 = torch.float64


@contextlib.contextmanager
def torch_threads(n):
    """`n` torch threads inside the block (for a module-scoped fixture,
    which `one_torch_thread` does not cover)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def one_torch_thread():
    """One torch thread for a test of small eager ops: faster there, and
    the test workers share the cores (each worker's default is all of
    them)."""
    with torch_threads(1):
        yield


def alongside(port_fn, jax_fn):
    """(jax_fn(), port_fn()) with the port's call in a second thread, so
    that the JAX package's compile, native code that releases the GIL,
    overlaps the port's solve."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_fn)
        return jax_fn(), port.result()


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
    prob_t = TUnicycle(dtype=F64, N=N, device="cpu").make_problem().compile()
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


def zoo_problem_jax(model, N, h=0.05):
    """The zoo's quadrotor or cartpole (perf/benchmark_zoo.py:54-97) in the
    JAX package, float64, at the zoo's step h=0.05 over N knots.  Returns
    (compiled problem, initial trajectory, x0)."""
    if model == "quadrotor":
        n, m = 13, 4
        x0, xf, u0 = hover_state((0.0, 0.0, 1.0)), hover_state((1.5, 1.0, 2.0)), hover_controls()
        dyn, lb, ub = quadrotor_rk4(), [0.0] * m, [4.0] * m
    else:
        n, m = 4, 1
        x0, xf, u0 = jnp.zeros(n), jnp.array([0.0, np.pi, 0.0, 0.0]), jnp.full((m,), 0.01)
        dyn, lb, ub = cartpole_rk4(), [-10.0], [10.0]
    uref = u0 if model == "quadrotor" else jnp.zeros(m)
    prob = Problem(N)
    prob.set_initial_state(x0)
    prob.set_dynamics(dyn, range(N))
    prob.set_cost(lqr_cost(jnp.eye(n) * 1e-2 * h, jnp.eye(m) * 1e-1 * h, xf, uref), range(N))
    prob.set_cost(lqr_cost(jnp.eye(n) * 100.0, jnp.zeros((m, m)), xf, uref, terminal=True), N)
    prob.set_constraint(control_bound(lb, ub), range(N))
    return prob.compile(), initial_trajectory(n, m, N, h, u0=u0), np.asarray(x0)


def zoo_fleet_jax(model, N, B, seed=0):
    """A fleet of the zoo problem: x0 spread 0.05, rolled out from the
    initial trajectory, warm random AL state (λ in [-0.5, 0], ρ in [1, 10])."""
    prob, Z0, x0 = zoo_problem_jax(model, N)
    solver = JSolver(prob, SolverOptions(backward_pass="pallas"))
    rng = np.random.default_rng(seed)
    params = prob.params.replace(x0=jnp.asarray(x0[:, None] + 0.05 * rng.standard_normal((prob.n, B))))
    Zb = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), Z0))
    Zb = solver.rollout(params, Zb)
    al = tuple(
        dict(
            lam=jnp.asarray(rng.uniform(-0.5, 0.0, st["lam"].shape)),
            rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)),
        )
        for st in solver.al_state_init(B, jnp.float64)
    )
    return prob, solver, params, Zb, al

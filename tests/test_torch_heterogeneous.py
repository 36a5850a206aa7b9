"""Heterogeneous dynamics in the port against the JAX package, float64 on the
CPU.

The reference takes a model per knot point (`problem.hpp:159-183`); the JAX
package's batched solver runs several dynamics families and per-knot
(stacked) dynamics params through a per-segment dispatch
(tests/test_batched_heterogeneous.py).  Held here at dof=1, B=8: the
hybrid triple-integrator / damped system (N=20), the damping schedule of
per-knot params (N=16), and the same schedule per instance ([N, B]): the
port's `ALSolverBatched` gives the JAX package's statuses and iterations,
and U within rtol 1e-8; the batched rollout follows each segment's own
model; `CompiledProblem.dynamics_step` and the Jacobians equal the JAX
package's; the fused kernels refuse both forms, so `backward_pass="fused"`
takes the fallback (the Riccati wrapper at dof=2, the eager sweep at
dof=1, which has no Riccati instance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import ContinuousModel as JContinuous
from altro_tpu import Problem as JProblem
from altro_tpu import SolverOptions as JOptions
from altro_tpu import goal_constraint as jgoal
from altro_tpu import initial_trajectory as jinitial
from altro_tpu import lqr_cost as jlqr
from altro_tpu.problem.dynamics import discretize as jdiscretize
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import damping_schedule, hybrid_triple_integrator
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel, Ineligible
from altro_tpu_torch.ops.forward import ForwardKernel
from altro_tpu_torch.solver.batched import ALSolverBatched, per_instance

from _torch_fleet import F64, numpy_tree, one_torch_thread  # noqa: F401
from test_batched_heterogeneous import _hybrid_problem

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 8
H = 0.1


def _damped_fn(params, x, u, t):
    return jnp.concatenate([x[1:2], x[2:3] - params["c"] * x[1:2], u])


def _jax_schedule(N):
    """tests/test_batched_heterogeneous.py:92-113: one damped family with
    c = 0.2 + 0.05 k on segment k."""
    base = jdiscretize(JContinuous(params={"c": jnp.asarray(0.2)}, fn=_damped_fn, n=3, m=1), "rk4")
    prob = JProblem(N)
    for k in range(N):
        prob.set_dynamics(dataclasses.replace(base, params={"c": jnp.asarray(0.2 + 0.05 * k)}), k)
    xf = jnp.array([1.0, 0.0, 0.0])
    prob.set_cost(jlqr(jnp.eye(3), jnp.eye(1) * 0.01, xf), range(N))
    prob.set_cost(jlqr(jnp.eye(3) * 1e4, jnp.zeros((1, 1)), xf, terminal=True), N)
    prob.set_constraint(jgoal(xf), N)
    prob.set_initial_state(jnp.array([-1.0, 0.0, 0.0]))
    return prob.compile()


def _case(kind, N, seed):
    """(JAX problem, port problem, JAX params, port params, JAX Z, port Z)
    with x0 = (-1, 0, 0) + U(-0.2, 0.2) (tests/test_batched_heterogeneous.py:
    64-75); "per_instance" scales each knot's damping by U(0.8, 1.2) per
    lane."""
    if kind == "hybrid":
        pj, _ = _hybrid_problem(N)
        pt, x0, _ = hybrid_triple_integrator(1, N, device="cpu")
    else:
        pj = _jax_schedule(N)
        pt, x0, _ = damping_schedule(1, N, device="cpu")
    rng = np.random.default_rng(seed)
    x0s = x0[:, None] + rng.uniform(-0.2, 0.2, (3, B))
    params_j = pj.params.replace(x0=jnp.asarray(x0s))
    if kind == "per_instance":
        c = np.asarray(pj.params.dynamics[0]["c"])[:, None] * rng.uniform(0.8, 1.2, (N, B))
        params_j = params_j.replace(dynamics=({"c": jnp.asarray(c)},))
    Z0 = jinitial(3, 1, N, H)
    Zj = to_batch_last(jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), Z0))
    return (pj, pt, params_j, convert.problem_params(numpy_tree(params_j), "cpu", F64), Zj,
            convert.trajectory(numpy_tree(Zj), "cpu", F64))


CASES = [("hybrid", 20, 0), ("schedule", 16, 2), ("per_instance", 16, 3)]


def test_structures_compile_as_in_jax():
    pt, _, _ = hybrid_triple_integrator(1, 20, device="cpu")
    pj, _ = _hybrid_problem(20)
    assert len(pt.dynamics_families) == 2
    np.testing.assert_array_equal(pt.dyn_fam_id, pj.dyn_fam_id)
    np.testing.assert_array_equal(pt.dyn_idx_in_fam, pj.dyn_idx_in_fam)
    st, _, _ = damping_schedule(1, 16, device="cpu")
    assert len(st.dynamics_families) == 1 and not st.dynamics_families[0].shared
    np.testing.assert_array_equal(st.dyn_idx_in_fam, np.arange(16))


@pytest.mark.parametrize("kind,N,seed", CASES, ids=[c[0] for c in CASES])
def test_fused_kernels_refuse_heterogeneous_dynamics(kind, N, seed):
    pj, pt, params_j, params_t, Zj, Zt = _case(kind, N, seed)
    why = "multiple dynamics families" if kind == "hybrid" else "per-knot dynamics params"
    for cls in (BackwardFusedKernel, ForwardKernel):
        with pytest.raises(Ineligible, match=why):
            cls(pt, SolverOptions(), dtype=F64, device="cpu")
    s = ALSolverBatched(pt, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    # the Riccati kernel has no (3, 1) instance: the eager sweep takes it
    assert s._bwd is None and s._fwd is None and s._ric is None
    pt2 = (hybrid_triple_integrator if kind == "hybrid" else damping_schedule)(2, N, device="cpu")[0]
    s2 = ALSolverBatched(pt2, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    assert s2._bwd is None and s2._fwd is None and (s2._ric.n, s2._ric.m) == (6, 2)


@pytest.mark.parametrize("path", ["scan", "fused"])
@pytest.mark.parametrize("kind,N,seed", CASES, ids=[c[0] for c in CASES])
def test_solve_matches_jax(kind, N, seed, path):
    pj, pt, params_j, params_t, Zj, Zt = _case(kind, N, seed)
    rj = numpy_tree(jax.jit(JSolver(pj, JOptions()).solve)(params_j, Zj))
    opts = SolverOptions() if path == "scan" else SolverOptions(backward_pass="fused", forward_pass="cuda")
    rt = ALSolverBatched(pt, opts).solve(params_t, Zt)
    np.testing.assert_array_equal(rt["status"].numpy(), rj["status"])
    assert (rt["status"].numpy() == int(SolverStatus.SOLVED)).all()
    np.testing.assert_array_equal(rt["stats"].iterations_total.numpy(), rj["stats"].iterations_total)
    np.testing.assert_array_equal(rt["stats"].iterations_outer.numpy(), rj["stats"].iterations_outer)
    np.testing.assert_allclose(rt["Z"].U.numpy(), rj["Z"].U, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("kind,N,seed", CASES, ids=[c[0] for c in CASES])
def test_rollout_and_jacobians_follow_each_segment(kind, N, seed):
    """The batched rollout's states satisfy each segment's own model (with
    its own params row, and its own lane's where they are per instance),
    and the Jacobians equal the JAX package's."""
    pj, pt, params_j, params_t, Zj, Zt = _case(kind, N, seed)
    rng = np.random.default_rng(seed + 10)
    U = torch.as_tensor(rng.normal(size=tuple(Zt.U.shape)))
    Zt = Zt.replace(U=U)
    Zj = dataclasses.replace(Zj, U=jnp.asarray(U.numpy()))
    st, sj = ALSolverBatched(pt, SolverOptions()), JSolver(pj, JOptions())
    Xt = st.rollout(params_t, Zt).X
    np.testing.assert_allclose(Xt.numpy(), np.asarray(sj.rollout(params_j, Zj).X), rtol=1e-12, atol=1e-12)
    for k in (0, N // 2 - 1, N // 2, N - 1):
        for b in (0, B - 1):
            dyn = tuple(
                None if dp is None else {key: v[..., b] if per_instance(cp[key], v) else v for key, v in dp.items()}
                for dp, cp in zip(params_t.dynamics, pt.params.dynamics)
            )
            xn = pt.dynamics_step(dyn, k, Xt[k, :, b], U[k, :, b], Zt.t[k], Zt.h[k])
            np.testing.assert_allclose(Xt[k + 1, :, b].numpy(), xn.numpy(), atol=1e-12)
    A, Bd = st.dyn_jacobian_all(params_t, Zt.replace(X=Xt))
    Aj, Bj = sj.dyn_jacobian_all(params_j, dataclasses.replace(Zj, X=jnp.asarray(Xt.numpy())))
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Bd.numpy(), np.asarray(Bj), rtol=1e-12, atol=1e-12)

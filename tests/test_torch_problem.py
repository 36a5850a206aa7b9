"""The port's problem layer against the JAX package on the same inputs.

RK4 discrete Jacobians (`torch.func.jacfwd` and the batched chain rule)
against `altro_tpu`'s `DiscreteModel.jacobian`; quadratic cost values and
expansions; goal and control-bound values and Jacobians; and the knot
families `Problem.compile()` builds.  Inputs come from numpy with a seed;
float64, tolerance 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import altro_tpu as at
import altro_tpu_torch as tt
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.models.unicycle import unicycle_rk4 as j_unicycle_rk4
from altro_tpu_torch import convert
from altro_tpu_torch.models.problems import UnicycleProblem as TUnicycle
from altro_tpu_torch.models.unicycle import unicycle_rk4 as t_unicycle_rk4
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory

TOL = 1e-12
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rk4_jacobian_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, 3)
    u = rng.uniform(-1.5, 1.5, 2)
    h = 0.03
    A_j, B_j = j_unicycle_rk4().jacobian(jnp.asarray(x), jnp.asarray(u), 0.0, h)
    A_t, B_t = t_unicycle_rk4().jacobian(_t(x), _t(u), _t(0.0), _t(h))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=0, atol=TOL)
    x_next_j = j_unicycle_rk4()(jnp.asarray(x), jnp.asarray(u), 0.0, h)
    x_next_t = t_unicycle_rk4()(_t(x), _t(u), _t(0.0), _t(h))
    np.testing.assert_allclose(x_next_t.numpy(), np.asarray(x_next_j), rtol=0, atol=TOL)


def test_batched_chain_rule_jacobian_matches_jax():
    """The solver's batched RK4 chain rule (what the kernels implement)
    equals JAX's AD Jacobian of the step, knot by knot and lane by lane."""
    rng = np.random.default_rng(3)
    N, B = 6, 5
    defn = TUnicycle(N=N, device="cpu")
    prob = defn.make_problem().compile()
    X = rng.uniform(-1, 1, (N + 1, 3, B))
    U = rng.uniform(-1, 1, (N, 2, B))
    Z = BatchedTrajectory(X=_t(X), U=_t(U), t=_t(np.arange(N + 1) * defn.h), h=_t(np.full(N, defn.h)))
    A, Bd = ALSolverBatched(prob).dyn_jacobian_all(prob.params, Z)
    jm = j_unicycle_rk4()
    for k in range(N):
        for b in range(B):
            A_j, B_j = jm.jacobian(jnp.asarray(X[k, :, b]), jnp.asarray(U[k, :, b]), 0.0, defn.h)
            np.testing.assert_allclose(A[k, :, :, b].numpy(), np.asarray(A_j), rtol=0, atol=TOL)
            np.testing.assert_allclose(Bd[k, :, :, b].numpy(), np.asarray(B_j), rtol=0, atol=TOL)


def _quad_params(seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(3, 3))
    Q = M @ M.T
    S = rng.normal(size=(2, 2))
    R = S @ S.T + np.eye(2)
    H = rng.normal(size=(3, 2))
    q, r, c = rng.normal(size=3), rng.normal(size=2), rng.normal()
    x, u = rng.normal(size=3), rng.normal(size=2)
    return Q, R, H, q, r, c, x, u


@pytest.mark.parametrize("seed", [0, 1])
def test_quadratic_cost_value_and_expansion(seed):
    Q, R, H, q, r, c, x, u = _quad_params(seed)
    cj = at.quadratic_cost(jnp.asarray(Q), jnp.asarray(R), jnp.asarray(H), jnp.asarray(q), jnp.asarray(r), c)
    ct = tt.quadratic_cost(_t(Q), _t(R), _t(H), _t(q), _t(r), c)
    ej = cj.expand(jnp.asarray(x), jnp.asarray(u))
    et = ct.expand(_t(x), _t(u))
    for name in ("J", "lx", "lu", "lxx", "lxu", "luu"):
        np.testing.assert_allclose(
            np.asarray(getattr(et, name)), np.asarray(getattr(ej, name)), rtol=TOL, atol=TOL,
            err_msg=name,
        )


def test_ad_expansion_matches_jax():
    """The generic AD expansion (torch.func) on a non-quadratic cost."""
    from altro_tpu.problem.costs import ad_expansion as j_ad
    from altro_tpu_torch.problem.costs import ad_expansion as t_ad

    rng = np.random.default_rng(4)
    x, u = rng.normal(size=3), rng.normal(size=2)
    ej = j_ad(lambda p, x, u: jnp.sum(jnp.sin(x) ** 2) + jnp.dot(x[:2], u) ** 2 + jnp.sum(u**4),
              None, jnp.asarray(x), jnp.asarray(u))
    et = t_ad(lambda p, x, u: torch.sum(torch.sin(x) ** 2) + torch.dot(x[:2], u) ** 2 + torch.sum(u**4),
              None, _t(x), _t(u))
    for name in ("J", "lx", "lu", "lxx", "lxu", "luu"):
        np.testing.assert_allclose(
            np.asarray(getattr(et, name)), np.asarray(getattr(ej, name)), rtol=TOL, atol=TOL,
            err_msg=name,
        )


@pytest.mark.parametrize(
    "lb,ub",
    [([-1.5, -1.5], [1.5, 1.5]), ([-1.0, -np.inf], [np.inf, 2.0])],
    ids=["box", "half-open"],
)
def test_control_bound_values_and_jacobian(lb, ub):
    rng = np.random.default_rng(5)
    x, u = rng.normal(size=3), rng.uniform(-3, 3, 2)
    cj = at.control_bound(jnp.asarray(lb), jnp.asarray(ub))
    ct = tt.control_bound(_t(lb), _t(ub))
    assert ct.dim == cj.dim and ct.structure == cj.structure and ct.cone.value == cj.cone.value
    np.testing.assert_allclose(ct(_t(x), _t(u)).numpy(), np.asarray(cj(jnp.asarray(x), jnp.asarray(u))), atol=TOL)
    for a_t, a_j in zip(ct.jacobian(_t(x), _t(u)), cj.jacobian(jnp.asarray(x), jnp.asarray(u))):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=TOL)


def test_goal_values_and_jacobian():
    rng = np.random.default_rng(6)
    xf, x, u = rng.normal(size=3), rng.normal(size=3), rng.normal(size=2)
    cj = at.goal_constraint(jnp.asarray(xf))
    ct = tt.goal_constraint(_t(xf))
    assert ct.dim == cj.dim and ct.structure == cj.structure and ct.cone.value == cj.cone.value
    np.testing.assert_allclose(ct(_t(x), _t(u)).numpy(), np.asarray(cj(jnp.asarray(x), jnp.asarray(u))), atol=TOL)
    for a_t, a_j in zip(ct.jacobian(_t(x), _t(u)), cj.jacobian(jnp.asarray(x), jnp.asarray(u))):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=TOL)


@pytest.mark.parametrize("constrained", [True, False])
def test_compile_families_match_jax(constrained):
    pj = JUnicycle(dtype=jnp.float64).make_problem(add_constraints=constrained).compile()
    pt = TUnicycle(dtype=F64, device="cpu").make_problem(add_constraints=constrained).compile()
    assert (pt.N, pt.n, pt.m) == (pj.N, pj.n, pj.m)
    assert pt.num_constraint_rows == pj.num_constraint_rows
    for fams_t, fams_j in (
        (pt.cost_families, pj.cost_families),
        (pt.dynamics_families, pj.dynamics_families),
        (pt.constraint_families, pj.constraint_families),
    ):
        assert len(fams_t) == len(fams_j)
        for ft, fj in zip(fams_t, fams_j):
            np.testing.assert_array_equal(ft.knots, fj.knots)
            assert ft.shared == fj.shared
    for ft, fj in zip(pt.constraint_families, pj.constraint_families):
        assert (ft.dim, ft.cone.value, ft.label) == (fj.dim, fj.cone.value, fj.label)
        assert ft.constraint.structure == fj.constraint.structure
    # the port's compiled params equal the JAX package's, leaf by leaf
    pj_t = convert.problem_params(pj.params, "cpu", F64)
    np.testing.assert_allclose(pt.params.x0.numpy(), pj_t.x0.numpy(), atol=TOL)
    for group in ("costs", "constraints"):
        for dt_, dj_ in zip(getattr(pt.params, group), getattr(pj_t, group)):
            assert dt_.keys() == dj_.keys()
            for key in dt_:
                np.testing.assert_allclose(dt_[key].numpy(), dj_[key].numpy(), atol=TOL, err_msg=key)

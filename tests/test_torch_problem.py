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


def test_dynamics_hessian_vector_product_unicycle():
    """`hessian_vp`, twin of tests/test_problem_layer.py:178-224: the
    unicycle's ∂²(bᵀf)/∂(x,u)² against its analytic form (for f = [v cosθ,
    v sinθ, ω]: -b0 v cosθ - b1 v sinθ at (θ,θ), -b0 sinθ + b1 cosθ at
    (θ,v), zero elsewhere) within 1e-12, its RK4 step's against central
    differences of the gradient within 1e-5, and both against the JAX
    methods on the same inputs within 1e-10."""
    from torch.func import grad

    from altro_tpu.models.unicycle import unicycle as j_unicycle
    from altro_tpu.problem.dynamics import discretize as j_discretize
    from altro_tpu_torch.models.unicycle import unicycle as t_unicycle
    from altro_tpu_torch.problem.dynamics import discretize as t_discretize

    x, u, b, h = np.array([0.3, -0.2, 0.7]), np.array([1.1, 0.4]), np.array([0.5, -1.2, 2.0]), 0.05
    model = t_unicycle()
    H = model.hessian_vp(_t(x), _t(u), _t(0.0), _t(b)).numpy()
    assert H.shape == (5, 5)
    expect = np.zeros((5, 5))
    expect[2, 2] = -b[0] * u[0] * np.cos(x[2]) - b[1] * u[0] * np.sin(x[2])
    expect[2, 3] = expect[3, 2] = -b[0] * np.sin(x[2]) + b[1] * np.cos(x[2])
    np.testing.assert_allclose(H, expect, rtol=0, atol=1e-12)
    H_j = j_unicycle().hessian_vp(jnp.asarray(x), jnp.asarray(u), 0.0, jnp.asarray(b))
    np.testing.assert_allclose(H, np.asarray(H_j), rtol=0, atol=1e-10)

    dm = t_discretize(model, "rk4")
    Hd = dm.hessian_vp(_t(x), _t(u), _t(0.0), _t(h), _t(b)).numpy()
    g = grad(lambda z: _t(b) @ dm.fn(dm.params, z[:3], z[3:], _t(0.0), _t(h)))
    z0, eps = np.concatenate([x, u]), 1e-6
    fd = np.stack([(g(_t(z0 + eps * e)) - g(_t(z0 - eps * e))).numpy() / (2 * eps) for e in np.eye(5)])
    np.testing.assert_allclose(Hd, fd, rtol=0, atol=1e-5)
    Hd_j = j_discretize(j_unicycle(), "rk4").hessian_vp(jnp.asarray(x), jnp.asarray(u), 0.0, h, jnp.asarray(b))
    np.testing.assert_allclose(Hd, np.asarray(Hd_j), rtol=0, atol=1e-10)


def test_replace_on_every_dataclass():
    """`replace(**updates)` on the port's dataclasses, as the JAX package
    gives every pytree dataclass (`altro_tpu/_pytree.py:45-48`): a new
    instance with the field changed and the original unchanged."""
    import dataclasses

    from altro_tpu_torch.problem.constraints import Constraint
    from altro_tpu_torch.problem.costs import Cost, CostExpansionTerms
    from altro_tpu_torch.problem.dynamics import ContinuousModel, DiscreteModel
    from altro_tpu_torch.solver.al import ALResult
    from altro_tpu_torch.solver.ilqr import ForwardPassResult, ILQRResult
    from altro_tpu_torch.solver.mpc import MPCState
    from altro_tpu_torch.solver.riccati import BackwardPassResult

    for cls in (Constraint, Cost, CostExpansionTerms, ContinuousModel, DiscreteModel, ALResult, ILQRResult,
                ForwardPassResult, BackwardPassResult, MPCState):
        fields = [f.name for f in dataclasses.fields(cls)]
        obj = cls(**{name: i for i, name in enumerate(fields)})
        new = obj.replace(**{fields[0]: "new"})
        assert type(new) is cls and getattr(new, fields[0]) == "new" and getattr(obj, fields[0]) == 0
        assert all(getattr(new, name) == getattr(obj, name) for name in fields[1:])


def test_from_batch_last_and_dyn_step_match_jax():
    """`from_batch_last` inverts `to_batch_last` and lays the trajectory out
    as the JAX function does (the shared t, h broadcast to [B, ...]); the
    batched solver's `dyn_step` is one step of the first dynamics family on
    x [n, B], u [m, B], as the JAX method's, within 1e-12."""
    from altro_tpu.solver.batched import ALSolverBatched as JSolver
    from altro_tpu.solver.batched import from_batch_last as j_from_batch_last
    from altro_tpu.solver.batched import to_batch_last as j_to_batch_last
    from altro_tpu_torch.solver.batched import from_batch_last, to_batch_last

    rng = np.random.default_rng(4)
    B, N = 5, 7
    X, U = rng.standard_normal((N + 1, 3, B)), rng.standard_normal((N, 2, B))
    t, h = np.arange(N + 1) * 0.1, np.full(N, 0.1)
    Z = from_batch_last(BatchedTrajectory(X=_t(X), U=_t(U), t=_t(t), h=_t(h)))
    Zj = j_from_batch_last(j_to_batch_last(at.Trajectory(X=jnp.asarray(np.moveaxis(X, -1, 0)),
                                                         U=jnp.asarray(np.moveaxis(U, -1, 0)),
                                                         t=jnp.asarray(t), h=jnp.asarray(h))))
    for key in ("X", "U", "t", "h"):
        np.testing.assert_array_equal(getattr(Z, key).numpy(), np.asarray(getattr(Zj, key)), err_msg=key)
    back = to_batch_last(Z)
    assert torch.equal(back.X, _t(X)) and torch.equal(back.U, _t(U)) and torch.equal(back.t, _t(t))

    defn_t = TUnicycle(dtype=F64, N=N, device="cpu")
    prob_t = defn_t.make_problem().compile()
    defn_j = JUnicycle()
    defn_j.N = N
    defn_j.__post_init__()
    prob_j = defn_j.make_problem(add_constraints=True).compile()
    x, u = rng.uniform(-1, 1, (3, B)), rng.uniform(-1, 1, (2, B))
    got = ALSolverBatched(prob_t, tt.SolverOptions()).dyn_step(prob_t.params.dynamics[0], _t(x), _t(u), _t(0.2),
                                                                _t(0.03))
    want = JSolver(prob_j, at.SolverOptions()).dyn_step(prob_j.params.dynamics[0], jnp.asarray(x), jnp.asarray(u),
                                                        0.2, 0.03)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)

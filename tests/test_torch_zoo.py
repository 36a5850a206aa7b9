"""The port's model zoo (quadrotor n=13, cartpole n=4, triple integrator)
and the backward passes that reach the Riccati kernel, against the JAX
package, float64 on the CPU (where the Riccati wrapper runs its plain
version).

Dynamics and discrete Jacobians at random x, u from a numpy seed (1e-12);
one quadrotor iLQR step with `backward_pass="pallas"` in both packages
(1e-9); a constrained triple-integrator solve (statuses and iterations
equal, U to 1e-8); the tests/test_models_zoo.py quadrotor waypoint solve
through the fused path's fallback (the quadrotor's device functor taken
away); which kernels each problem selects; and the card as the default
device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu.models import cartpole as jcart
from altro_tpu.models import quadrotor as jquad
from altro_tpu.models import triple_integrator as jti
from altro_tpu.models.problems import TripleIntegratorProblem as JTriple
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import SolverOptions, SolverStatus, convert
from altro_tpu_torch.models import cartpole as tcart
from altro_tpu_torch.models import quadrotor as tquad
from altro_tpu_torch.models import triple_integrator as tti
from altro_tpu_torch.models.problems import TripleIntegratorProblem, zoo_cartpole, zoo_quadrotor
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory

from _torch_fleet import F64, numpy_tree, zoo_fleet_jax

TOL = 1e-12
MODELS = {
    "quadrotor": (jquad.quadrotor_rk4(), lambda: tquad.quadrotor_rk4(device="cpu"), 13, 4),
    "cartpole": (jcart.cartpole_rk4(), lambda: tcart.cartpole_rk4(device="cpu"), 4, 1),
    "triple_integrator": (jti.triple_integrator_rk4(2), lambda: tti.triple_integrator_rk4(2), 6, 2),
}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dynamics_and_jacobians_match_jax(name):
    jm, make_t, n, m = MODELS[name]
    tm = make_t()
    rng = np.random.default_rng(7)
    h = 0.05
    for _ in range(3):
        x, u = rng.normal(size=n), rng.normal(size=m)
        if name == "quadrotor":
            x[3:7] /= np.linalg.norm(x[3:7])
            u = 1.2 + 0.3 * u
        np.testing.assert_allclose(
            tm.continuous_fn(tm.params, _t(x), _t(u), _t(0.0)).numpy(),
            np.asarray(jm.continuous_fn(jm.params, jnp.asarray(x), jnp.asarray(u), 0.0)), rtol=0, atol=TOL,
        )
        np.testing.assert_allclose(
            tm(_t(x), _t(u), _t(0.0), _t(h)).numpy(), np.asarray(jm(jnp.asarray(x), jnp.asarray(u), 0.0, h)),
            rtol=0, atol=TOL,
        )
        for a_t, a_j in zip(tm.jacobian(_t(x), _t(u), _t(0.0), _t(h)),
                            jm.jacobian(jnp.asarray(x), jnp.asarray(u), 0.0, h)):
            np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("model", ["quadrotor", "cartpole"])
def test_zoo_problem_params_and_batched_jacobians_match_jax(model):
    """The JAX zoo problem's params (the quadrotor's inertia J [3] among
    them) carried across by `convert.problem_params` drive the port's
    batched RK4 chain rule (torch.func.jacfwd) to JAX's A, B."""
    prob_j, solver_j, params_j, Z_j, _ = zoo_fleet_jax(model, N=6, B=5, seed=3)
    A_j, B_j = solver_j.dyn_jacobian_all(params_j, Z_j)
    build = zoo_quadrotor if model == "quadrotor" else zoo_cartpole
    prob_t = build(N=6, tf=0.3, dtype=F64, device="cpu")[0]
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    if model == "quadrotor":
        assert tuple(params_t.dynamics[0]["J"].shape) == (3,)
    A, Bd = ALSolverBatched(prob_t).dyn_jacobian_all(params_t, convert.trajectory(numpy_tree(Z_j), "cpu", F64))
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(Bd.numpy(), np.asarray(B_j), rtol=0, atol=TOL)
    # zoo_quadrotor and zoo_cartpole make the same problem data as the JAX zoo
    for ct, cj in zip(prob_t.params.costs, convert.problem_params(numpy_tree(prob_j.params), "cpu", F64).costs):
        for key in ct:
            np.testing.assert_allclose(ct[key].numpy(), cj[key].numpy(), rtol=0, atol=TOL, err_msg=key)


def test_quadrotor_ilqr_step_matches_jax():
    """One iteration with backward_pass="pallas" in both packages from the
    hover rollout under a warm AL state (N=10, B=4): expansion, the
    regularization retry loop over the Riccati sweep, and the line search.
    Both start at ρ=1 (`bp_reg_initial`): at ρ=0 the hover's Quu is so near
    singular that the summation order alone moves K by ~1e-4."""
    opts = dict(backward_pass="pallas", bp_reg_initial=1.0)
    prob_j, _, params_j, Z_j, al_j = zoo_fleet_jax("quadrotor", N=10, B=4, seed=5)
    sj = JSolver(prob_j, JOptions(**opts))
    prob_t = zoo_quadrotor(N=10, tf=0.5, dtype=F64, device="cpu")[0]
    st = ALSolverBatched(prob_t, SolverOptions(**opts))
    assert st._ric is not None
    params_t = convert.problem_params(numpy_tree(params_j), "cpu", F64)
    Z_t = convert.trajectory(numpy_tree(Z_j), "cpu", F64)
    al_t = convert.al_state(numpy_tree(al_j), "cpu", F64)
    B = 4
    rho0, drho0 = jnp.ones((B,)), jnp.zeros((B,))

    exp_j = sj.expand(params_j, al_j, Z_j)
    bp_j = sj.backward_pass(exp_j, rho0, drho0)
    J0_j = exp_j["costs"].sum(axis=0)
    fp_j = sj.forward_pass(params_j, al_j, Z_j, bp_j, J0_j)

    exp_t = st.expand(params_t, al_t, Z_t)
    bp_t = st.backward_pass(exp_t, torch.ones(B, dtype=F64), torch.zeros(B, dtype=F64))
    J0_t = exp_t["costs"].sum(dim=0)
    fp_t = st.forward_pass(params_t, al_t, Z_t, bp_t, J0_t)
    assert st._ric.launches == 0  # CPU tensors: the plain version

    for key in ("A", "B", "lxx", "lxu", "luu", "lx", "lu", "costs"):
        np.testing.assert_allclose(exp_t[key].numpy(), np.asarray(exp_j[key]), rtol=TOL, atol=TOL, err_msg=key)
    np.testing.assert_array_equal(bp_t["failed"].numpy(), np.asarray(bp_j["failed"]))
    np.testing.assert_array_equal(bp_t["rho"].numpy(), np.asarray(bp_j["rho"]))
    for got, want in ((bp_t["K"], bp_j["K"]), (bp_t["d"], bp_j["d"]),
                      (fp_t["alpha"], fp_j["alpha"]), (fp_t["J"], fp_j["J"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(fp_t["success"].numpy(), np.asarray(fp_j["success"]))


def test_triple_integrator_solve_matches_jax():
    """TripleIntegratorProblem(dof=2) with its control bound and goal,
    backward_pass="pallas", B=4: the same statuses, iterations and U."""
    B = 4
    rng = np.random.default_rng(11)
    x0 = np.zeros((6, B)) + rng.uniform(-0.2, 0.2, (6, B))
    x0[:2] += np.array([-1.0, -2.0])[:, None]

    dj = JTriple(dof=2)
    pj = dj.make_problem(add_constraints=True).compile()
    sj = JSolver(pj, JOptions(backward_pass="pallas"))
    Zj = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), dj.initial_trajectory()))
    rj = numpy_tree(jax.jit(sj.solve)(pj.params.replace(x0=jnp.asarray(x0)), Zj))

    dt = TripleIntegratorProblem(dof=2, device="cpu")
    pt = dt.make_problem(add_constraints=True).compile()
    st = ALSolverBatched(pt, SolverOptions(backward_pass="pallas"))
    assert st._ric is not None and st._ric.n == 6 and st._ric.m == 2
    Z0 = dt.initial_trajectory()
    Zt = BatchedTrajectory(Z0.X[..., None].expand(-1, -1, B).contiguous(),
                           Z0.U[..., None].expand(-1, -1, B).contiguous(), Z0.t, Z0.h)
    rt = st.solve(pt.params.replace(x0=_t(x0)), Zt)
    np.testing.assert_array_equal(rt["status"].numpy(), rj["status"])
    assert (rt["status"].numpy() == int(SolverStatus.SOLVED)).all()
    np.testing.assert_array_equal(rt["stats"].iterations_total.numpy(), rj["stats"].iterations_total)
    np.testing.assert_array_equal(rt["stats"].iterations_outer.numpy(), rj["stats"].iterations_outer)
    np.testing.assert_allclose(rt["Z"].U.numpy(), rj["Z"].U, rtol=0, atol=1e-8)


def _waypoint_problem():
    """tests/test_models_zoo.py:29-48: fly 2 m sideways and 1 m up from
    hover, thrusts bounded to [0, 4], N=60, h=0.05."""
    from altro_tpu_torch import Problem, control_bound, lqr_cost

    N, h = 60, 0.05
    x0 = tquad.hover_state((0.0, 0.0, 1.0), device="cpu")
    xf = tquad.hover_state((2.0, 0.0, 2.0), device="cpu")
    u_hover = tquad.hover_controls(device="cpu")
    Q = torch.eye(13, dtype=F64) * 1e-2 * h
    prob = Problem(N)
    prob.set_dynamics(tquad.quadrotor_rk4(device="cpu"), range(N))
    prob.set_cost(lqr_cost(Q, torch.eye(4, dtype=F64) * 1e-2 * h, xf, u_hover), range(N))
    prob.set_cost(lqr_cost(torch.eye(13, dtype=F64) * 100.0, torch.zeros((4, 4), dtype=F64), xf, terminal=True), N)
    prob.set_constraint(control_bound(torch.zeros(4, dtype=F64), torch.full((4,), 4.0, dtype=F64)), range(N))
    prob.set_initial_state(x0)
    return prob.compile(), x0, u_hover, N, h


def _without_device_functor(monkeypatch, name):
    """Take the model's device functor out of the fused kernels' table, so
    that the fused path meets a model it cannot take."""
    from altro_tpu_torch.ops import backward_fused

    monkeypatch.delitem(backward_fused.CUDA_MODELS, name)


def test_quadrotor_waypoint_through_the_fused_fallback(monkeypatch):
    """backward_pass="fused" on a quadrotor whose device functor the fused
    kernels lack: they refuse the model and the Riccati wrapper takes the
    backward pass.  Asserts what tests/test_models_zoo.py:53-60 asserts; not
    the iteration count, which even in float64 follows codegen
    (perf/quadrotor_path_stability.out)."""
    from altro_tpu_torch import initial_trajectory

    _without_device_functor(monkeypatch, "quadrotor")
    cp, x0, u_hover, N, h = _waypoint_problem()
    solver = ALSolverBatched(cp, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    assert solver._bwd is None and solver._fwd is None and solver._ric is not None
    B = 2
    Z0 = initial_trajectory(13, 4, N, h, u0=u_hover, device="cpu")
    Z = BatchedTrajectory(Z0.X[..., None].expand(-1, -1, B).contiguous(),
                          Z0.U[..., None].expand(-1, -1, B).contiguous(), Z0.t, Z0.h)
    res = solver.solve(cp.params.replace(x0=x0[:, None].expand(13, B).contiguous()), Z)
    assert (res["status"].numpy() == int(SolverStatus.SOLVED)).all()
    X, U = res["Z"].X.numpy(), res["Z"].U.numpy()
    assert np.abs(X[-1, :3] - np.array([2.0, 0.0, 2.0])[:, None]).max() < 0.05
    assert np.abs(np.linalg.norm(X[:, 3:7], axis=1) - 1.0).max() < 0.02
    assert U.min() >= -1e-4 and U.max() <= 4.0 + 1e-4


@pytest.mark.parametrize("build", [zoo_quadrotor, zoo_cartpole], ids=["quadrotor", "cartpole"])
def test_fused_path_falls_back_to_the_riccati_kernel(build, monkeypatch):
    """A zoo model without its device functor: `backward_pass="fused"`
    builds no fused kernel and builds the Riccati wrapper, at the model's
    (n, m)."""
    prob = build(N=8, dtype=F64, device="cpu")[0]
    _without_device_functor(monkeypatch, prob.dynamics_families[0].model.cuda_model)
    solver = ALSolverBatched(prob, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    assert solver._bwd is None and solver._fwd is None
    assert (solver._ric.n, solver._ric.m) == (prob.n, prob.m)
    assert ALSolverBatched(prob, SolverOptions())._ric is None  # "scan" stays eager


@pytest.mark.parametrize("build", [zoo_quadrotor, zoo_cartpole], ids=["quadrotor", "cartpole"])
def test_fused_kernels_take_the_zoo_models(build):
    """The zoo's models have device functors (`csrc/models.cuh`), so
    `backward_pass="fused"` with `forward_pass="cuda"` builds both fused
    kernels and no Riccati wrapper, as the JAX package's fused kernels take
    them (perf/benchmark_zoo.py:113-115); the descriptor carries the
    model's params in the functor's order."""
    from altro_tpu_torch.ops import _build
    from altro_tpu_torch.ops.backward_fused import CUDA_MODELS

    prob = build(N=8, dtype=torch.float32, device="cpu")[0]
    solver = ALSolverBatched(prob, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    assert solver._bwd is not None and solver._fwd is not None and solver._ric is None
    name = prob.dynamics_families[0].model.cuda_model
    assert solver._bwd.model_name == name and CUDA_MODELS[name][:2] == (prob.n, prob.m)
    raw, _ = solver._bwd._problem_desc(prob.params)
    desc = _build.Problem.from_buffer_copy(raw.numpy().tobytes())
    dyn = prob.params.dynamics[0]
    want = np.concatenate([np.atleast_1d(dyn[k].double().numpy()) for k in CUDA_MODELS[name][2]])
    np.testing.assert_array_equal(np.asarray(desc.dyn[: want.size]), want)
    if name == "quadrotor":  # mass, J [3], gravity, kf, km, arm_length
        np.testing.assert_allclose(desc.dyn[:8], [0.5, 0.0023, 0.0023, 0.004, 9.81, 1.0, 0.0245, 0.175], rtol=1e-7)
    goal = [c for c in desc.con[: desc.n_con] if c.kind == _build.GOAL]
    assert not goal  # the zoo's fleets hold the goal by cost alone


def test_entry_points_default_to_the_card():
    """Without CUDA, an entry point given no device raises instead of
    making CPU tensors."""
    from altro_tpu_torch import initial_trajectory
    from altro_tpu_torch.models.problems import UnicycleProblem

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    for make in (UnicycleProblem, TripleIntegratorProblem, lambda: initial_trajectory(3, 2, 10, 0.1),
                 lambda: zoo_quadrotor(), lambda: tquad.quadrotor()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert UnicycleProblem(device="cpu").initial_trajectory().X.device.type == "cpu"

"""Second-order cones in the port against the JAX package, float64 on the
CPU.

The batch-last Lorentz-cone projection and its Jacobian
(`solver/batched.py:soc_project_bl`, `soc_jacobian_bl`) and the per-instance
cone functions (`problem/constraints.py`) against the JAX package's on rows
in all three regions of the cone (inside, polar, boundary; the rows of
tests/test_batched_soc.py:25-51), atol 1e-12; the AL cost under warm SOC
duals; and the velocity-cone unicycle (tests/test_batched_soc.py:54-75,
N=40, B=8) solved by both packages' `ALSolverBatched`: statuses and
iterations equal, U within rtol 1e-8.  The fused kernels refuse the cone,
so `backward_pass="fused"` takes the Riccati wrapper (its plain version
here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu.problem import constraints as jcons
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import soc_jacobian_bl as jsoc_jac
from altro_tpu.solver.batched import soc_project_bl as jsoc_proj
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import Cone, SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import soc_unicycle
from altro_tpu_torch.problem import constraints as tcons
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory, soc_jacobian_bl, soc_project_bl

from _torch_fleet import F64, numpy_tree, one_torch_thread  # noqa: F401
from test_batched_soc import _soc_problem as jax_soc_problem

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 8
N = 40


def _rows(seed, nk=5, p=4, Bz=16):
    """Rows [nk, p, B] with row 0 inside the cone, row 1 in its polar, the
    rest mostly on the boundary's branch (tests/test_batched_soc.py:25-32)."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(nk, p, Bz))
    s[0, -1, :] = np.abs(s[0, :-1, :]).sum(axis=0) + 1.0
    s[1, -1, :] = -(np.abs(s[1, :-1, :]).sum(axis=0) + 1.0)
    return s


def test_soc_projection_matches_jax_in_all_three_regions():
    s = _rows(0)
    got = soc_project_bl(torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsoc_proj(jnp.asarray(s))), rtol=0, atol=1e-12)
    for k in range(s.shape[0]):
        for b in range(s.shape[2]):
            want = np.asarray(jcons.cone_project(jcons.Cone.SECOND_ORDER, jnp.asarray(s[k, :, b])))
            np.testing.assert_allclose(
                tcons.cone_project(Cone.SECOND_ORDER, torch.as_tensor(s[k, :, b])).numpy(), want, atol=1e-12)
    np.testing.assert_allclose(tcons.cone_project_rows(Cone.SECOND_ORDER, torch.as_tensor(s[:, :, 0])).numpy(),
                               np.asarray(jcons.cone_project_rows(jcons.Cone.SECOND_ORDER, jnp.asarray(s[:, :, 0]))),
                               atol=1e-12)
    np.testing.assert_allclose(tcons.cone_violation(Cone.SECOND_ORDER, torch.as_tensor(s[:, :, 1])).numpy(),
                               np.asarray(jcons.cone_violation(jcons.Cone.SECOND_ORDER, jnp.asarray(s[:, :, 1]))),
                               atol=1e-12)


def test_soc_jacobian_matches_jax_in_all_three_regions():
    s = _rows(1)
    got = soc_jacobian_bl(torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsoc_jac(jnp.asarray(s))), rtol=0, atol=1e-12)
    for k in range(s.shape[0]):
        for b in range(0, s.shape[2], 3):
            want = np.asarray(jcons.cone_jacobian(jcons.Cone.SECOND_ORDER, jnp.asarray(s[k, :, b])))
            np.testing.assert_allclose(
                tcons.cone_jacobian(Cone.SECOND_ORDER, torch.as_tensor(s[k, :, b])).numpy(), want, atol=1e-12)
    assert not tcons.cone_is_diagonal(Cone.SECOND_ORDER) and tcons.cone_is_diagonal(Cone.NEGATIVE_ORTHANT)
    with pytest.raises(ValueError):
        tcons.cone_jacobian_diag(Cone.SECOND_ORDER, torch.zeros(2, dtype=F64))
    assert tcons.dual_cone(Cone.SECOND_ORDER) is Cone.SECOND_ORDER


def _pair(N_h):
    defn_j, prob_j = jax_soc_problem(N_h)
    defn_t, prob_t = soc_unicycle(N_h, device="cpu")
    assert [f.cone for f in prob_t.constraint_families] == [Cone.SECOND_ORDER]
    return defn_j, prob_j, defn_t, prob_t


def test_soc_al_cost_under_warm_duals_matches_jax():
    """The AL cost with random duals in all three regions of the cone: the
    SOC branch of `_al_terms` (tests/test_batched_soc.py:124-158)."""
    defn_j, prob_j, defn_t, prob_t = _pair(12)
    rng = np.random.default_rng(9)
    Z0 = defn_j.initial_trajectory()
    Zj = to_batch_last(jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), Z0))
    sj = JSolver(prob_j, JOptions())
    al_j = tuple(
        dict(lam=jnp.asarray(rng.normal(size=st["lam"].shape)), rho=jnp.asarray(rng.uniform(1.0, 10.0, st["rho"].shape)))
        for st in sj.al_state_init(B, jnp.float64)
    )
    st = ALSolverBatched(prob_t, SolverOptions())
    Zt = convert.trajectory(numpy_tree(Zj), "cpu", F64)
    al_t = convert.al_state(numpy_tree(al_j), "cpu", F64)
    np.testing.assert_allclose(st.total_cost(prob_t.params, al_t, Zt).numpy(),
                               np.asarray(sj.total_cost(prob_j.params, al_j, Zj)), rtol=1e-12)
    exp_t = st.expand(prob_t.params, al_t, Zt)
    exp_j = sj.expand(prob_j.params, al_j, Zj)
    for key in ("lx", "lu", "lxx", "lxu", "luu"):
        np.testing.assert_allclose(exp_t[key].numpy(), np.asarray(exp_j[key]), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("path", ["scan", "fused"])
def test_soc_solve_matches_jax(path):
    """The velocity-cone unicycle, N=40, B=8, x0 uniform in ±0.2 (seed 5):
    the same statuses and iterations as the JAX package's batched solve,
    U within rtol 1e-8, every lane SOLVED with the cone binding.  With
    `backward_pass="fused"` the fused kernels refuse the cone and the
    Riccati wrapper takes the backward pass."""
    defn_j, prob_j, defn_t, prob_t = _pair(N)
    rng = np.random.default_rng(5)
    x0s = rng.uniform(-0.2, 0.2, size=(3, B))
    Z0 = defn_j.initial_trajectory()
    Zj = to_batch_last(jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), Z0))
    rj = numpy_tree(jax.jit(JSolver(prob_j, JOptions()).solve)(prob_j.params.replace(x0=jnp.asarray(x0s)), Zj))

    opts = SolverOptions() if path == "scan" else SolverOptions(backward_pass="fused", forward_pass="cuda")
    st = ALSolverBatched(prob_t, opts)
    if path == "fused":
        assert st._bwd is None and st._fwd is None and st._ric is not None
    Zt0 = defn_t.initial_trajectory()
    Zt = BatchedTrajectory(Zt0.X[..., None].expand(-1, -1, B).contiguous(),
                           Zt0.U[..., None].expand(-1, -1, B).contiguous(), Zt0.t, Zt0.h)
    rt = st.solve(prob_t.params.replace(x0=torch.as_tensor(x0s)), Zt)
    np.testing.assert_array_equal(rt["status"].numpy(), rj["status"])
    assert (rt["status"].numpy() == int(SolverStatus.SOLVED)).all()
    np.testing.assert_array_equal(rt["stats"].iterations_total.numpy(), rj["stats"].iterations_total)
    np.testing.assert_array_equal(rt["stats"].iterations_outer.numpy(), rj["stats"].iterations_outer)
    np.testing.assert_allclose(rt["Z"].U.numpy(), rj["Z"].U, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rt["stats"].violations.numpy(), rj["stats"].violations, rtol=1e-8, atol=1e-12)
    assert np.abs(rt["Z"].U.numpy()[:, 0]).max() <= 0.8 + 1e-3

"""The port's fused backward pass against the JAX package.

The plain PyTorch version of `altro_tpu_torch.ops.backward_fused.
BackwardFusedKernel` (what the wrapper runs for CPU tensors) against the
JAX `BackwardFusedKernel` in interpret mode, with the set-up and
tolerances of tests/test_backward_fused.py (N=12, B=1024, random AL state,
float64), and against JAX `expand` + `riccati_scan` at N=100, B=8.  The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions
from altro_tpu.ops.backward_fused_pallas import build_backward_fused_kernel
from altro_tpu_torch import SolverOptions as TOptions
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel

from _torch_fleet import F64, make_fleet

B = 1024


@pytest.fixture(scope="module")
def fleet():
    return make_fleet(12, B)


@pytest.fixture(scope="module")
def jax_kernel(fleet):
    """The JAX kernel in interpret mode, jitted once for every ρ."""
    kern_j = build_backward_fused_kernel(
        fleet.prob_j, SolverOptions(), interpret=True, dtype=jnp.float64
    )
    return kern_j, jax.jit(kern_j)


def _port(fl, rho):
    kern = BackwardFusedKernel(fl.prob_t, TOptions(), dtype=F64, device="cpu")
    out = kern(fl.params_t, kern.pad_al(fl.al_t), fl.Z_t, torch.full((fl.Z_t.X.shape[-1],), rho, dtype=F64))
    assert kern.launches == 0  # CPU tensors run the plain version
    return [o.numpy() for o in out]


def _assert_close(port, ref):
    K, d, dV1, dV2, failed, J0 = port
    K0, d0, dV10, dV20, f0, J00 = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(K, K0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(d, d0, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(dV1, dV10, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(dV2, dV20, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(J0, J00, rtol=1e-10)
    np.testing.assert_array_equal(failed, f0)


@pytest.mark.parametrize("rho", [0.0, 0.37])
def test_plain_matches_jax_fused_kernel_interpret(fleet, jax_kernel, rho):
    kern_j, call = jax_kernel
    ref = call(fleet.params_j, kern_j.pad_al(fleet.al_j), fleet.Z_j, jnp.full((B,), rho))
    _assert_close(_port(fleet, rho), ref)


def test_plain_matches_jax_expand_riccati_n100():
    fl = make_fleet(100, 8, seed=2, spread=0.1)
    sj = fl.solver_j
    exp = jax.jit(sj.expand)(fl.params_j, fl.al_j, fl.Z_j)
    K, d, dV1, dV2, failed = jax.jit(sj.riccati_scan)(exp, jnp.zeros((8,)))
    J0 = jax.jit(sj.total_cost)(fl.params_j, fl.al_j, fl.Z_j)
    _assert_close(_port(fl, 0.0), (K, d, dV1, dV2, failed, J0))


def test_pad_al_matches_jax(fleet, jax_kernel):
    """The packed AL buffers hold the JAX package's per-family padding."""
    kern_j, _ = jax_kernel
    pad_j = kern_j.pad_al(fleet.al_j)
    kern = BackwardFusedKernel(fleet.prob_t, TOptions(), dtype=F64, device="cpu")
    pad = kern.pad_al(fleet.al_t)
    bound, goal = kern._con_fams
    np.testing.assert_array_equal(pad.lam[:, bound["stage_row"]: bound["stage_row"] + 4].numpy(), np.asarray(pad_j[0]["lam"]))
    np.testing.assert_array_equal(pad.rho[:, bound["stage_fam"]].numpy(), np.asarray(pad_j[0]["rho"]))
    np.testing.assert_array_equal(pad.lamT[goal["term_row"]: goal["term_row"] + 3].numpy(), np.asarray(pad_j[1]["lamT"]))
    np.testing.assert_array_equal(pad.rhoT[goal["term_fam"]].numpy(), np.asarray(pad_j[1]["rhoT"]))


def _unicycle_builder():
    from altro_tpu_torch.models.problems import UnicycleProblem as TUnicycle

    return TUnicycle(dtype=F64, N=10, device="cpu").make_problem()


def _opaque_constraint(builder):
    from altro_tpu_torch import Cone, Constraint

    con = Constraint(params={}, fn=lambda p, x, u: u[:1] - 1.0, cone=Cone.NEGATIVE_ORTHANT, dim=1)
    builder.set_constraint(con, range(10))
    return builder


def _model_without_functor(builder):
    from altro_tpu_torch import ContinuousModel, discretize

    model = ContinuousModel(params=None, fn=lambda p, x, u, t: x * 0 + u[0], n=3, m=2)
    builder.set_dynamics(discretize(model, "rk4"), range(10))
    return builder


@pytest.mark.parametrize(
    "make,dtype",
    [(_opaque_constraint, F64), (_model_without_functor, F64), (lambda b: b, torch.float16)],
    ids=["opaque-constraint", "no-device-functor", "float16"],
)
def test_ineligible_structures_raise(make, dtype):
    """Structures the kernels do not take raise Ineligible when the wrapper
    is built (`build_backward_fused_kernel` and `build_forward_kernel`
    return None), and the solver then runs the eager passes."""
    from altro_tpu_torch.ops.backward_fused import Ineligible
    from altro_tpu_torch.ops.forward import ForwardKernel
    from altro_tpu_torch.solver.batched import ALSolverBatched

    from altro_tpu_torch.ops.backward_fused import build_backward_fused_kernel as build_bwd
    from altro_tpu_torch.ops.forward import build_forward_kernel as build_fwd

    prob = make(_unicycle_builder()).compile()
    for cls in (BackwardFusedKernel, ForwardKernel):
        with pytest.raises(Ineligible):
            cls(prob, TOptions(), dtype=dtype, device="cpu")
    # the function forms return None instead, as the JAX package's do
    assert build_bwd(prob, TOptions(), dtype=dtype, device="cpu") is None
    assert build_fwd(prob, TOptions(), dtype=dtype, device="cpu") is None
    if dtype == F64:
        solver = ALSolverBatched(prob, TOptions(backward_pass="fused", forward_pass="cuda"))
        assert solver._bwd is None and solver._fwd is None


def test_wrapper_refuses_devices_without_kernel(fleet):
    """Neither kernel nor plain version exists for other devices: raise."""
    kern = BackwardFusedKernel(fleet.prob_t, TOptions(), dtype=F64, device="cpu")
    Z = fleet.Z_t.replace(X=fleet.Z_t.X.to("meta"), U=fleet.Z_t.U.to("meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kern(fleet.params_t, kern.pad_al(fleet.al_t), Z, torch.zeros(B, dtype=F64))


def test_build_functions_give_the_kernels(fleet):
    """`build_backward_fused_kernel` and `build_forward_kernel` on an
    eligible problem: the kernels, whose outputs on the fleet (CPU
    tensors: the plain versions) equal those of the classes built
    directly, bit for bit."""
    from altro_tpu_torch.ops.backward_fused import build_backward_fused_kernel as build_bwd
    from altro_tpu_torch.ops.forward import ForwardKernel
    from altro_tpu_torch.ops.forward import build_forward_kernel as build_fwd

    kb = build_bwd(fleet.prob_t, TOptions(), dtype=F64, device="cpu")
    kf = build_fwd(fleet.prob_t, TOptions(), dtype=F64, device="cpu")
    assert isinstance(kb, BackwardFusedKernel) and isinstance(kf, ForwardKernel)
    Bsz = fleet.Z_t.X.shape[-1]
    out = kb(fleet.params_t, kb.pad_al(fleet.al_t), fleet.Z_t, torch.zeros(Bsz, dtype=F64))
    for got, want in zip(out, _port(fleet, 0.0)):
        np.testing.assert_array_equal(got.numpy(), want)
    N, m, n = fleet.prob_t.N, fleet.prob_t.m, fleet.prob_t.n
    K, d, alpha = torch.zeros((N, m, n, Bsz), dtype=F64), torch.zeros((N, m, Bsz), dtype=F64), torch.ones(Bsz, dtype=F64)
    direct = ForwardKernel(fleet.prob_t, TOptions(), dtype=F64, device="cpu")
    for got, want in zip(kf(fleet.params_t, kf.pad_al(fleet.al_t), fleet.Z_t, K, d, alpha),
                         direct(fleet.params_t, direct.pad_al(fleet.al_t), fleet.Z_t, K, d, alpha)):
        assert torch.equal(got, want)
    assert kb.launches == kf.launches == 0

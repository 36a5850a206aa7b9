"""The port's fused forward pass against the JAX package.

The plain PyTorch version of `altro_tpu_torch.ops.forward.ForwardKernel`
(what the wrapper runs for CPU tensors) against the JAX `ForwardKernel` in
interpret mode at N=12, B=1024, float64, tolerance 1e-10: guarded tries at
α = 1 and 0.5 with one lane pushed past `state_max` (so STATE_LIMIT and
`valid` are compared), and the unguarded α = 0, K = d = 0 open-loop
rollout.  The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions, SolverStatus
from altro_tpu.ops.forward_pallas import build_forward_kernel
from altro_tpu_torch import SolverOptions as TOptions
from altro_tpu_torch import convert
from altro_tpu_torch.ops.forward import ForwardKernel

from _torch_fleet import F64, make_fleet

B = 1024
N = 12
STATE_MAX = 5.0  # the pushed lane 0 passes it; most lanes stay below


@pytest.fixture(scope="module")
def case():
    fl = make_fleet(N, B, opts=SolverOptions(state_max=STATE_MAX))
    sj = fl.solver_j
    exp = jax.jit(sj.expand)(fl.params_j, fl.al_j, fl.Z_j)
    K, d, *_ = jax.jit(sj.riccati_scan)(exp, jnp.full((B,), 0.37))
    d = d.at[:, 0, 0].add(20.0)  # lane 0 speeds off past state_max
    kern_j = build_forward_kernel(
        fl.prob_j, SolverOptions(state_max=STATE_MAX), interpret=True, dtype=jnp.float64
    )
    call = jax.jit(kern_j, static_argnames=("check_bounds",))
    return fl, K, d, kern_j, call


def _tries(K, d):
    zK, zd = jnp.zeros_like(K), jnp.zeros_like(d)
    return {
        "guarded_alpha1": (K, d, 1.0, True),
        "guarded_alpha0.5": (K, d, 0.5, True),
        "open_loop_alpha0": (zK, zd, 0.0, False),
    }


def _assert_close(port, ref):
    Xn, Ubar, J, valid, status = port
    Xn0, U0, J0, valid0, status0 = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(Xn, Xn0, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Ubar, U0, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(J, J0, rtol=1e-10)
    np.testing.assert_array_equal(valid, valid0)
    np.testing.assert_array_equal(status, status0)


@pytest.mark.parametrize("name", ["guarded_alpha1", "guarded_alpha0.5", "open_loop_alpha0"])
def test_plain_matches_jax_forward_kernel_interpret(case, name):
    fl, K, d, kern_j, call = case
    Kc, dc, alpha, guarded = _tries(K, d)[name]
    a = jnp.full((B,), alpha)
    ref = call(fl.params_j, kern_j.pad_al(fl.al_j), fl.Z_j, Kc, dc, a, check_bounds=guarded)
    kern = ForwardKernel(fl.prob_t, TOptions(state_max=STATE_MAX), dtype=F64, device="cpu")
    out = kern(
        fl.params_t, kern.pad_al(fl.al_t), fl.Z_t,
        convert.tensor(Kc, "cpu", F64), convert.tensor(dc, "cpu", F64),
        torch.full((B,), alpha, dtype=F64), check_bounds=guarded,
    )
    assert kern.launches == 0  # CPU tensors run the plain version
    _assert_close([o.numpy() for o in out], ref)
    status = np.asarray(ref[4])
    if guarded:
        assert status[0] == SolverStatus.STATE_LIMIT and not bool(ref[3][0])
        assert np.asarray(ref[3]).any()  # and lanes that stay valid


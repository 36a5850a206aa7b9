"""The fused backward kernel's Jacobian arithmetic against the JAX package.

The kernel builds each column of the discrete step's [A Bd] as one tangent
of the whole RK4 (or Euler) step (`csrc/fused_common.cuh:dyn_tangent`);
`ops/backward_fused.py:step_jacobian_by_tangents` is that arithmetic in
torch.  Held here against `jax.jacfwd` of the JAX package's discrete step
for the three models with a device functor, float64, at random states and
controls from a numpy seed: within 1e-12 of the largest entry.  The CUDA
functors themselves are held against the plain version on the card
(tests/test_torch_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu.models import cartpole as jcart
from altro_tpu.models import quadrotor as jquad
from altro_tpu.models import unicycle as juni
from altro_tpu.problem.dynamics import discretize as jdiscretize
from altro_tpu_torch.models import cartpole as tcart
from altro_tpu_torch.models import quadrotor as tquad
from altro_tpu_torch.models import unicycle as tuni
from altro_tpu_torch.ops.backward_fused import step_jacobian_by_tangents
from altro_tpu_torch.problem.dynamics import discretize as tdiscretize

F64 = torch.float64
MODELS = {
    "unicycle": (lambda: juni.unicycle_rk4(), lambda: tuni.unicycle_rk4(), 3, 2),
    "unicycle-euler": (lambda: jdiscretize(juni.unicycle(), "euler"),
                       lambda: tdiscretize(tuni.unicycle(), "euler"), 3, 2),
    "cartpole": (lambda: jcart.cartpole_rk4(), lambda: tcart.cartpole_rk4(device="cpu"), 4, 1),
    "quadrotor": (lambda: jquad.quadrotor_rk4(), lambda: tquad.quadrotor_rk4(device="cpu"), 13, 4),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_jacobian_by_tangents_matches_jax_jacfwd(name):
    make_j, make_t, n, m = MODELS[name]
    jm, tm = make_j(), make_t()
    rng = np.random.default_rng(11)
    h, t = 0.05, 0.3
    for _ in range(3):
        x, u = rng.normal(size=n), rng.normal(size=m)
        if name == "quadrotor":
            x[3:7] /= np.linalg.norm(x[3:7])
            u = 1.2 + 0.3 * u
        A, Bd = step_jacobian_by_tangents(
            tm, torch.as_tensor(x, dtype=F64), torch.as_tensor(u, dtype=F64),
            torch.tensor(t, dtype=F64), torch.tensor(h, dtype=F64),
        )
        Aj, Bj = jax.jacfwd(lambda xx, uu: jm(xx, uu, t, h), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(u))
        ref = np.concatenate([np.asarray(Aj), np.asarray(Bj)], axis=1)
        got = torch.cat([A, Bd], dim=1).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0), name

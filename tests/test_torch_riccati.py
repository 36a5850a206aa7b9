"""The port's Riccati sweep (`altro_tpu_torch.ops.riccati`) against the JAX
package, float64 on the CPU, where the wrapper runs its plain version.

At the unicycle's (3, 2) it is held against JAX `riccati_pallas` in
interpret mode on the expansion tests/test_pallas.py builds (N=12, B=1024);
at the quadrotor's (13, 4) and the cartpole's (4, 1) against JAX
`ALSolverBatched.riccati_scan` at N=6, B=16 (interpret mode would unroll
13×13 products for minutes; tests/test_pallas.py shows that
`riccati_pallas` equals `riccati_scan`).  Tolerance rtol = atol = 1e-9 on
K and d of the lanes that did not fail; failure flags equal.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions
from altro_tpu.models.problems import UnicycleProblem
from altro_tpu.ops.riccati_pallas import TILE, riccati_pallas
from altro_tpu.solver.batched import ALSolverBatched, to_batch_last
from altro_tpu_torch import SolverOptions as TOptions
from altro_tpu_torch import convert
from altro_tpu_torch.ops import tolerances as tol
from altro_tpu_torch.ops.riccati import Ineligible, RiccatiKernel, riccati_cuda, riccati_plain

from _torch_fleet import F64, numpy_tree, zoo_fleet_jax

TOL = 1e-9


def _poison(exp):
    """luu negative definite at knot 3: every lane must fail."""
    m = exp["luu"].shape[1]
    bad = dict(exp)
    bad["luu"] = exp["luu"].at[3].set(
        jnp.broadcast_to(-jnp.eye(m, dtype=exp["luu"].dtype)[:, :, None], exp["luu"].shape[1:])
    )
    return bad


def _port(exp, rho):
    """The port's wrapper on CPU tensors: the plain version, no launch."""
    N, n, _, B = exp["A"].shape
    kern = RiccatiKernel(n, exp["B"].shape[2], dtype=F64)
    out = kern(convert.expansions(numpy_tree(exp), "cpu", F64), torch.full((B,), rho, dtype=F64))
    assert kern.launches == 0
    return [o.numpy() for o in out]


def _assert_matches(port, ref, all_fail=False):
    K, d, dV1, dV2, failed = port
    K0, d0, dV10, dV20, f0 = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(failed, f0)
    if all_fail:
        assert f0.all()
    ok = ~f0
    np.testing.assert_allclose(K[..., ok], K0[..., ok], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(d[..., ok], d0[..., ok], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dV1[ok], dV10[ok], rtol=1e-8, atol=TOL)
    np.testing.assert_allclose(dV2[ok], dV20[ok], rtol=1e-8, atol=TOL)


@pytest.fixture(scope="module")
def unicycle_exp():
    """tests/test_pallas.py:13-33: N=12, B=1024, rolled out from x0 in
    ±0.3, cold AL state."""
    B = TILE
    defn = UnicycleProblem(dtype=jnp.float64)
    defn.N = 12
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    fast = ALSolverBatched(prob, SolverOptions())
    rng = np.random.default_rng(0)
    params = prob.params.replace(x0=jnp.asarray(rng.uniform(-0.3, 0.3, (3, B))))
    Zb = to_batch_last(
        jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), defn.initial_trajectory())
    )
    Zb = fast.rollout(params, Zb)
    return fast.expand(params, fast.al_state_init(B, jnp.float64), Zb)


@pytest.mark.parametrize("case", ["rho=0", "rho=0.37", "poisoned"])
def test_matches_jax_riccati_pallas_interpret(unicycle_exp, case):
    exp = _poison(unicycle_exp) if case == "poisoned" else unicycle_exp
    rho = 0.37 if case == "rho=0.37" else 0.0
    B = exp["A"].shape[-1]
    ref = riccati_pallas(exp, jnp.full((B,), rho), interpret=True)
    _assert_matches(_port(exp, rho), ref, all_fail=case == "poisoned")


def test_riccati_cuda_is_the_kernel_function(unicycle_exp):
    """`riccati_cuda`, the function form of `riccati_pallas`: on CPU
    tensors the kernel's plain version, bit for bit the wrapper's, no
    launch; a shape without a kernel raises Ineligible (no fallback)."""
    exp = convert.expansions(numpy_tree(unicycle_exp), "cpu", F64)
    rho = torch.full((exp["A"].shape[-1],), 0.37, dtype=F64)
    got = riccati_cuda(exp, rho, gain_limit=1e8)
    want = RiccatiKernel(3, 2, dtype=F64)(exp, rho)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(Ineligible):
        riccati_cuda({"A": torch.zeros((2, 5, 5, 4), dtype=F64), "B": torch.zeros((2, 5, 2, 4), dtype=F64)},
                     torch.zeros(4, dtype=F64))


@pytest.fixture(scope="module", params=["quadrotor", "cartpole"])
def zoo_exp(request):
    _, solver, params, Zb, al = zoo_fleet_jax(request.param, N=6, B=16)
    return solver, solver.expand(params, al, Zb)


# ρ=0 is left out: at the quadrotor's hover the unregularized Quu is so
# near singular (|K| ~ 25) that the summation order alone moves K by ~1e-7
@pytest.mark.parametrize("case", ["rho=0.37", "rho=10", "poisoned"])
def test_zoo_shapes_match_jax_riccati_scan(zoo_exp, case):
    solver, exp = zoo_exp
    if case == "poisoned":
        exp, rho = _poison(exp), 0.0
    else:
        rho = float(case.split("=")[1])
    B = exp["A"].shape[-1]
    ref = jax.jit(solver.riccati_scan)(exp, jnp.full((B,), rho))
    _assert_matches(_port(exp, rho), ref, all_fail=case == "poisoned")


@pytest.mark.parametrize("rho", [10.0, 1e3])
def test_quadrotor_rounding_order_within_the_sensitivity_bound(rho):
    """The rule chip_smoke.py holds the n=13 kernel to where the sweep is
    ill-conditioned (ops/tolerances.py): two float64 sweeps that differ only
    in rounding order, JAX `riccati_scan` and the port's plain sweep, at the
    zoo's full horizon (N=50, B=64), stay on every lane within SENS_FACTOR
    times the lane's sensitivity to a one-ulp move of the inputs.  At ρ=10
    that sensitivity is far above the flat 1e-9 bound; at ρ=1e3 below it."""
    _, solver, params, Zb, al = zoo_fleet_jax("quadrotor", N=50, B=64)
    exp_j = solver.expand(params, al, Zb)
    ref = jax.jit(solver.riccati_scan)(exp_j, jnp.full((64,), rho))
    exp = convert.expansions(numpy_tree(exp_j), "cpu", F64)
    r = torch.full((64,), rho, dtype=F64)
    want = riccati_plain(exp, r)
    rng = np.random.default_rng(0)
    moved = [riccati_plain({k: tol.ulp_moved(v, rng) for k, v in exp.items()}, r) for _ in range(tol.SENS_DRAWS)]
    sens, flips = tol.sensitivity(want, moved)
    assert not bool(flips.any()) and not bool(want[4].any())
    K0 = torch.as_tensor(np.array(ref[0]))
    err = ((want[0] - K0).abs() / (1.0 + K0.abs())).flatten(0, -2).amax(dim=0)
    assert bool((err <= tol.F64_ATOL + tol.F64_RTOL["K"] + tol.SENS_FACTOR * sens).all())
    if rho == 10.0:
        assert float(sens.min()) > 1e-8  # the flat bound alone would not hold here


@pytest.mark.parametrize("n,m,dtype", [(5, 2, F64), (3, 2, torch.float16)], ids=["shape", "dtype"])
def test_uninstantiated_shapes_are_ineligible(n, m, dtype):
    """Only the (n, m) and scalar types with an instantiation in
    csrc/riccati.cu build a wrapper; a solver then runs riccati_scan."""
    with pytest.raises(Ineligible):
        RiccatiKernel(n, m, dtype=dtype)


def test_wrapper_refuses_devices_without_kernel(unicycle_exp):
    exp = convert.expansions(numpy_tree(unicycle_exp), "cpu", F64)
    exp = {k: v.to("meta") for k, v in exp.items()}
    with pytest.raises(ValueError, match="no kernel or plain version"):
        RiccatiKernel(3, 2, dtype=F64)(exp, torch.zeros(TILE, dtype=F64, device="meta"))


def test_options_map_the_jax_name():
    assert TOptions(backward_pass="pallas").backward_pass == "riccati"
    with pytest.raises(ValueError):
        TOptions(backward_pass="pscan")


def _sweep_flags(exp, rho, symmetrize):
    """Failure flags [B] of the Riccati sweep of `exp` at regularization ρ
    [B], as `riccati_scan` computes them (Cholesky of Quu + ρI, the gain
    guard, the freeze at a lane's first failure), and the largest
    |P − Pᵀ| / max|P| each lane's cost-to-go reaches before it fails.
    `symmetrize` replaces P by (P + Pᵀ)/2 after every knot."""
    from altro_tpu_torch.solver.batched import chol_failed, chol_solve_mat, chol_unrolled, mm, mT

    N, m = exp["A"].shape[0], exp["B"].shape[2]
    glim = TOptions().bp_gain_limit
    eye_m = torch.eye(m, dtype=exp["A"].dtype)[:, :, None]
    P = exp["lxx"][N]
    failed = torch.zeros(P.shape[-1], dtype=torch.bool)
    asym = torch.zeros(P.shape[-1], dtype=P.dtype)
    for k in reversed(range(N)):
        A, Bd = exp["A"][k], exp["B"][k]
        AtP = mm(mT(A), P)
        Qxx, Qxu = exp["lxx"][k] + mm(AtP, A), exp["lxu"][k] + mm(AtP, Bd)
        Quu = exp["luu"][k] + mm(mT(Bd), mm(P, Bd))
        L = chol_unrolled(Quu + eye_m * rho)
        safe = [[None if e is None else torch.where(torch.isfinite(e), e, 1.0) for e in row] for row in L]
        K = -chol_solve_mat(safe, mT(Qxu))
        failed = failed | chol_failed(L) | ~(K.abs().amax(dim=(0, 1)) <= glim)
        P_new = Qxx + mm(mm(mT(K), Quu), K) + mm(mT(K), mT(Qxu)) + mm(Qxu, K)
        if symmetrize:
            P_new = 0.5 * (P_new + mT(P_new))
        P = torch.where(failed, P, P_new)
        rel = (P - mT(P)).abs().amax(dim=(0, 1)) / P.abs().amax(dim=(0, 1))
        asym = torch.where(failed, asym, torch.maximum(asym, rel))
    return failed, asym


def test_quadrotor_flags_at_n24_are_decided_by_rounding():
    """The quadrotor Riccati case at N=24 in float64 (ROADMAP §3): the zoo's
    quadrotor at 24 knots (h = 2.5/24), x0 spread 0.05 and a warm random AL
    state drawn from seed 0 for 1001 lanes, of which the first 160 are
    rolled out and swept.  At ρ=1 the port's plain sweep and
    JAX `riccati_scan` both flag lanes that do not fail: the reference's P
    update (`ilqr.hpp`) keeps P symmetric only up to rounding, and its
    antisymmetric part grows about 3x a knot (1e-12 at knot 23, 0.1–1
    relative at knot 0), until the Cholesky of Quu + ρI, which reads one
    triangle, fails on it.  A sweep that symmetrizes P flags none (so does
    a 40-digit sweep of the flagged lanes, whose Quu + ρI keeps eigenvalues
    above 1); which f64 lanes fail is rounding, in both packages.  A fault
    of the algorithm in float64, not of the port."""
    import altro_tpu
    from altro_tpu_torch.models.problems import zoo_quadrotor
    from altro_tpu_torch.solver.batched import ALSolverBatched as TSolver
    from altro_tpu_torch.solver.batched import BatchedTrajectory

    from _torch_fleet import zoo_problem_jax

    Bz, Nh, lanes = 1001, 24, 160  # drawn for 1001 lanes, the first 160 swept
    rng = np.random.default_rng(0)
    prob, Z0, x0, _ = zoo_quadrotor(N=Nh, dtype=F64, device="cpu")
    ev = TSolver(prob, TOptions())
    x0s = x0.numpy()[:, None] + 0.05 * rng.standard_normal((13, Bz))
    params = prob.params.replace(x0=torch.as_tensor(x0s[:, :lanes]))
    al = tuple(dict(lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape)[..., :lanes]),
                    rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape)[..., :lanes]))
               for st in ev.al_state_init(Bz, F64))
    Bz = lanes
    Z = ev.rollout(params, BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, Bz).contiguous(),
                                             U=Z0.U[..., None].expand(-1, -1, Bz).contiguous(), t=Z0.t, h=Z0.h))
    exp = ev.expand(params, al, Z)
    rho = torch.ones(Bz, dtype=F64)
    plain = RiccatiKernel(13, 4, dtype=F64).plain(exp, rho)[4]
    sj = ALSolverBatched(zoo_problem_jax("quadrotor", Nh, h=2.5 / Nh)[0], altro_tpu.SolverOptions())
    jflags = np.asarray(jax.jit(sj.riccati_scan)({k: jnp.asarray(v.numpy()) for k, v in exp.items()},
                                                  jnp.ones(Bz))[4])
    flags, asym = _sweep_flags(exp, rho, symmetrize=False)
    assert torch.equal(flags, plain)  # the replica is the plain sweep
    sym_flags, sym_asym = _sweep_flags(exp, rho, symmetrize=True)
    assert int(plain.sum()) > 0 and int(jflags.sum()) > 0 and not bool(sym_flags.any())
    assert float(asym[plain].min()) > 1e-3 and float(sym_asym.max()) < 1e-12

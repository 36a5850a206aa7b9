"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips at run time when no CUDA device is present.
This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)  Inputs are
made from a numpy seed; B=1001 and B=1 leave the last block of every
kernel's grid (8 lanes) part-empty and make the kernels that stage their
inputs copy element by element, so the ragged edges are covered.  The bounds and the
regularizations are chip_smoke.py's, from altro_tpu_torch/ops/tolerances.py.
"""
import numpy as np
import pytest
import torch

from altro_tpu_torch import SolverOptions, SolverStatus
from altro_tpu_torch.models.problems import (
    TripleIntegratorProblem, UnicycleProblem, zoo_cartpole, zoo_quadrotor,
)
from altro_tpu_torch.ops import tolerances as tol
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
from altro_tpu_torch.ops.forward import ForwardKernel
from altro_tpu_torch.ops.riccati import RiccatiKernel
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.solver.compaction import CompactedALSolver

N, B = 12, 1000
STATE_MAX = 5.0
DTYPES = [torch.float64, torch.float32]
F32_REL = tol.F32_REL

pytestmark = pytest.mark.gpu


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _fleet_Z(defn, Bsz):
    Z0 = defn.initial_trajectory()
    return BatchedTrajectory(
        X=Z0.X[..., None].expand(-1, -1, Bsz).contiguous(),
        U=Z0.U[..., None].expand(-1, -1, Bsz).contiguous(), t=Z0.t, h=Z0.h,
    )


def _setup(dtype, dev):
    defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
    prob = defn.make_problem().compile()
    ev = ALSolverBatched(prob, SolverOptions())
    rng = np.random.default_rng(0)
    params = prob.params.replace(
        x0=torch.as_tensor(rng.uniform(-0.3, 0.3, (3, B)), device=dev).to(dtype)
    )
    Z = ev.rollout(params, _fleet_Z(defn, B))
    al = tuple(
        dict(
            lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape), device=dev).to(dtype),
            rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape), device=dev).to(dtype),
        )
        for st in ev.al_state_init(B, dtype)
    )
    return prob, params, Z, al


def _close(name, got, want, dtype, rtol64, f32_rel=F32_REL, sens=None):
    """float64: |Δ| <= 1e-10 + rtol·|want|, widened by SENS_FACTOR times a
    lane's sensitivity `sens` [lanes]; float32: relative to max |want|."""
    g, w = got.double().cpu(), want.double().cpu()
    if dtype == torch.float64 and sens is not None:
        bound = tol.F64_ATOL + rtol64 * w.abs() + tol.SENS_FACTOR * sens.double().cpu() * (1.0 + w.abs())
        assert bool(((g - w).abs() <= bound).all()), f"{name}: {float((g - w).abs().max()):.3e}"
    elif dtype == torch.float64:
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol64, atol=1e-10, err_msg=name)
    else:
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1.0) if w.numel() else 0.0
        assert rel <= f32_rel[name], f"{name}: {rel:.3e}"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("rho", [0.0, 0.37])
def test_backward_kernel_matches_plain(dtype, rho):
    dev = _device()
    prob, params, Z, al = _setup(dtype, dev)
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    r = torch.full((B,), rho, dtype=dtype, device=dev)
    ap = kern.pad_al(al)
    got = kern(params, ap, Z, r)
    torch.cuda.synchronize()
    assert kern.launches == 1
    want = kern.plain(params, ap, Z, r)
    assert torch.equal(got[4], want[4])
    for name, g, w, rt in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4], (1e-9, 1e-9, 1e-8, 1e-8)):
        _close(name, g, w, dtype, rt)
    _close("J0", got[5], want[5], dtype, 1e-10)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("alpha,guarded", [(1.0, True), (0.5, True), (0.0, False)])
def test_forward_kernel_matches_plain(dtype, alpha, guarded):
    dev = _device()
    prob, params, Z, al = _setup(dtype, dev)
    opts = SolverOptions(state_max=STATE_MAX)
    bk = BackwardFusedKernel(prob, opts, dtype=dtype, device=dev)
    fk = ForwardKernel(prob, opts, dtype=dtype, device=dev)
    ap = fk.pad_al(al)
    K, d, *_ = bk.plain(params, ap, Z, torch.full((B,), 0.37, dtype=dtype, device=dev))
    d[:, 0, 0] += 20.0  # lane 0 speeds off past state_max
    if not guarded:
        K, d = torch.zeros_like(K), torch.zeros_like(d)
    a = torch.full((B,), alpha, dtype=dtype, device=dev)
    got = fk(params, ap, Z, K, d, a, check_bounds=guarded)
    torch.cuda.synchronize()
    assert fk.launches == 1
    want = fk.plain(params, ap, Z, K, d, a, check_bounds=guarded)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    if guarded:
        assert int(got[4][0]) == int(SolverStatus.STATE_LIMIT)
    for name, g, w in zip(("Xn", "Ubar", "J"), got[:3], want[:3]):
        _close(name, g, w, dtype, 1e-10)


def test_golden_f64_through_kernels():
    """The float64 kernels reproduce the reference golden: SOLVED in 14
    total / 5 outer iterations, J = 0.03893465058924039."""
    dev = _device()
    defn = UnicycleProblem(dtype=torch.float64, device=dev)
    prob = defn.make_problem().compile()
    fb = ALSolverBatched(
        prob, SolverOptions(constraint_tolerance=1e-6, backward_pass="fused", forward_pass="cuda")
    )
    params = prob.params.replace(x0=torch.zeros((3, 3), dtype=torch.float64, device=dev))
    res = fb.solve(params, _fleet_Z(defn, 3))
    assert fb._bwd.launches > 0 and fb._fwd.launches > 0
    assert (res["status"] == int(SolverStatus.SOLVED)).all()
    assert (res["stats"].iterations_total == 14).all() and (res["stats"].iterations_outer == 5).all()
    J = fb.total_cost(params, res["al"], res["Z"]).cpu().numpy()
    np.testing.assert_allclose(J, 0.03893465058924039, rtol=1e-9)


def test_compaction_kernels_match_eager_path_f64():
    """CompactedALSolver on the kernels follows the eager path's iterations
    lane by lane (float64, B=16, two tail rounds)."""
    dev = _device()
    defn = UnicycleProblem(dtype=torch.float64, device=dev, N=30)
    prob = defn.make_problem().compile()
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(rng.uniform(-0.4, 0.4, (3, 16)), device=dev)
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=x0)
    out = {}
    for kind, kw in (("eager", {}), ("kernels", dict(backward_pass="fused", forward_pass="cuda"))):
        comp = CompactedALSolver(prob, SolverOptions(**kw), phase1_iters=5, tail_batch=8, device_tail=True)
        out[kind] = comp.solve(params, _fleet_Z(defn, 16))
    assert torch.equal(out["eager"]["status"], out["kernels"]["status"])
    assert torch.equal(out["eager"]["stats"].iterations_total, out["kernels"]["stats"].iterations_total)
    np.testing.assert_allclose(
        out["kernels"]["Z"].U.cpu().numpy(), out["eager"]["Z"].U.cpu().numpy(), rtol=0, atol=1e-9
    )


def _zoo_fleet(problem, dtype, dev, Bz=B):
    """The zoo's quadrotor (N=50) or cartpole (N=60): a fleet of Bz lanes,
    x0 spread 0.05 about the zoo's start, rolled out from the zoo's
    initial trajectory, under a warm random AL state."""
    rng = np.random.default_rng(0)
    build = zoo_quadrotor if problem == "quadrotor" else zoo_cartpole
    prob, Z0, x0, _ = build(dtype=dtype, device=dev)
    ev = ALSolverBatched(prob, SolverOptions())
    x0s = x0.double().cpu().numpy()[:, None] + 0.05 * rng.standard_normal((prob.n, Bz))
    params = prob.params.replace(x0=torch.as_tensor(x0s, device=dev).to(dtype))
    Z = ev.rollout(params, BatchedTrajectory(
        X=Z0.X[..., None].expand(-1, -1, Bz).contiguous(),
        U=Z0.U[..., None].expand(-1, -1, Bz).contiguous(), t=Z0.t, h=Z0.h,
    ))
    al = tuple(
        dict(
            lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape), device=dev).to(dtype),
            rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape), device=dev).to(dtype),
        )
        for st in ev.al_state_init(Bz, dtype)
    )
    return prob, ev, params, Z, al


def _triple_expansions(dtype, dev, Bz, N=10):
    """Eager expansions of a Bz-lane triple-integrator fleet (n=6, m=2; its
    control bounds and goal; x0 spread 0.05 about its start) rolled out from
    its initial trajectory, under a warm random AL state."""
    rng = np.random.default_rng(0)
    defn = TripleIntegratorProblem(dtype=dtype, device=dev, N=N)
    prob = defn.make_problem(add_constraints=True).compile()
    ev = ALSolverBatched(prob, SolverOptions())
    x0s = defn.x0[:, None] + 0.05 * rng.standard_normal((prob.n, Bz))
    params = prob.params.replace(x0=torch.as_tensor(x0s, device=dev).to(dtype))
    Z = ev.rollout(params, _fleet_Z(defn, Bz))
    al = tuple(
        dict(
            lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape), device=dev).to(dtype),
            rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape), device=dev).to(dtype),
        )
        for st in ev.al_state_init(Bz, dtype)
    )
    return ev.expand(params, al, Z)


def _riccati_expansions(problem, dtype, dev):
    """Eager expansions of a B=1000 fleet of `problem` under a warm random AL
    state: the parking problem at N=12 (x0 in ±0.3), the zoo's fleet, or
    the triple integrator's at N=10."""
    if problem == "parking":
        prob, params, Z, al = _setup(dtype, dev)
        return ALSolverBatched(prob, SolverOptions()).expand(params, al, Z)
    if problem == "triple":
        return _triple_expansions(dtype, dev, B)
    _, ev, params, Z, al = _zoo_fleet(problem, dtype, dev)
    return ev.expand(params, al, Z)


def _hold_riccati_kernel(problem, dtype, exp, seed=0):
    """The Riccati kernel against its plain version on `exp` at each of the
    problem's ρ, and with luu poisoned negative definite at knot 3 (every
    lane fails): flags equal on the lanes whose flag a one-ulp move of the
    inputs does not flip, K, d, ΔV close on those that did not fail, each
    float64 lane within its sensitivity.  Returns the kernel."""
    dev = exp["A"].device
    tag = "f64" if dtype == torch.float64 else "f32"
    Bz, n, m = exp["A"].shape[-1], exp["A"].shape[1], exp["B"].shape[2]
    kern = RiccatiKernel(n, m, dtype=dtype)
    poisoned = dict(exp, luu=exp["luu"].clone())
    poisoned["luu"][3] = -torch.eye(m, dtype=dtype, device=dev)[:, :, None]
    cases = [(exp, r) for r in tol.RHOS[tag][problem]] + [(poisoned, 0.0)]
    for i, (e, r) in enumerate(cases):
        rho = torch.full((Bz,), r, dtype=dtype, device=dev)
        got = kern(e, rho)
        torch.cuda.synchronize()
        assert kern.launches == i + 1
        want = kern.plain(e, rho)
        rng = np.random.default_rng(seed + i)
        moved = [kern.plain({k: tol.ulp_moved(v, rng) for k, v in e.items()}, rho) for _ in range(tol.SENS_DRAWS)]
        sens, flips = tol.sensitivity(want, moved)
        assert torch.equal(got[4][~flips], want[4][~flips])
        if e is poisoned:
            assert bool(got[4].all())
        ok = ~want[4] & ~flips
        for name, g, w, rt in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4], (1e-9, 1e-9, 1e-8, 1e-8)):
            _close(name, g[..., ok], w[..., ok], dtype, rt, tol.RICCATI_F32_REL[problem], sens[ok])
    return kern


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("problem", ["parking", "quadrotor", "cartpole", "triple"])
def test_riccati_kernel_matches_plain(dtype, problem):
    """At each of the problem's ρ, and with luu poisoned negative definite at
    knot 3 (every lane fails): flags equal on the lanes whose flag a one-ulp
    move of the inputs does not flip, K, d, ΔV close on those that did not
    fail, each float64 lane within its sensitivity.  Every instance of the
    kernel: parking (3,2), quadrotor (13,4), cartpole (4,1), triple
    integrator (6,2)."""
    dev = _device()
    _hold_riccati_kernel(problem, dtype, _riccati_expansions(problem, dtype, dev))


@pytest.mark.parametrize("Bz", [1000, 1001, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("problem", ["parking", "cartpole", "quadrotor", "triple"])
def test_riccati_kernel_matches_plain_at_ragged_widths(problem, dtype, Bz):
    """Every Riccati instance at its own horizon (parking N=100, cartpole
    N=60, quadrotor N=50, triple integrator N=10) and at three batch widths:
    B=1000 (whole blocks of 8 lanes, 16-byte copies), B=1001 (a last block
    with one lane, copies element by element) and B=1, held as in
    test_riccati_kernel_matches_plain."""
    dev = _device()
    if problem == "triple":
        exp = _triple_expansions(dtype, dev, Bz)
    else:
        prob, params, Z, al = _own_fleet(problem, dtype, dev, Bz)
        exp = ALSolverBatched(prob, SolverOptions()).expand(params, al, Z)
    kern = _hold_riccati_kernel(problem, dtype, exp, seed=Bz)
    assert kern.geometry(Bz).blocks == -(-Bz // 8)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("problem,Nh", [("parking", 31), ("parking", 37), ("triple", 13)])
def test_riccati_kernel_matches_plain_at_horizons(problem, dtype, Nh):
    """Horizons against the kernel's chunks of knots (the sweep's positions
    N ... 0, N+1 of them): parking N=31 fills whole chunks exactly (two of
    16 knots in f32, four of 8 in f64), N=37 leaves a last chunk of 6; the
    triple integrator at N=13 leaves one of 2 in f32 (chunks of 4) and
    fills seven of 2 in f64.  B=1001, held as in
    test_riccati_kernel_matches_plain.  The quadrotor's partial last chunk
    (N=50, 2 knots in f32) is held by the ragged-width test; at shorter
    horizons its ρ=0 sweep has lanes on the edge of failing that the
    one-ulp witness does not always find (f64, N=24: one of 1001)."""
    dev = _device()
    Bz = 1001
    if problem == "triple":
        exp = _triple_expansions(dtype, dev, Bz, N=Nh)
    else:
        rng = np.random.default_rng(0)
        defn = UnicycleProblem(dtype=dtype, device=dev, N=Nh)
        prob = defn.make_problem().compile()
        ev = ALSolverBatched(prob, SolverOptions())
        params = prob.params.replace(x0=torch.as_tensor(rng.uniform(-0.3, 0.3, (3, Bz)), device=dev).to(dtype))
        Z = ev.rollout(params, _fleet_Z(defn, Bz))
        exp = ev.expand(params, ev.al_state_init(Bz, dtype), Z)
    knots = RiccatiKernel(exp["A"].shape[1], exp["B"].shape[2], dtype=dtype).geometry(Bz).knots
    if problem == "parking":
        assert ((Nh + 1) % knots == 0) == (Nh == 31)
    _hold_riccati_kernel(problem, dtype, exp, seed=Nh)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("problem", ["quadrotor", "cartpole"])
def test_fused_kernels_match_plain_on_the_zoo(dtype, problem):
    """The fused backward kernel at each of the problem's ρ (flags, K, d, ΔV
    within each lane's sensitivity, J0) and the forward kernel rolling out
    the plain gains of the largest ρ, at the zoo's shapes."""
    dev = _device()
    tag = "f64" if dtype == torch.float64 else "f32"
    prob, _, params, Z, al = _zoo_fleet(problem, dtype, dev)
    f32_rel = tol.ZOO_F32_REL[problem]
    bk = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    fk = ForwardKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    ap = bk.pad_al(al)
    rng = np.random.default_rng(1)
    Zms = [Z.replace(X=tol.ulp_moved(Z.X, rng), U=tol.ulp_moved(Z.U, rng)) for _ in range(tol.SENS_DRAWS)]
    for r in tol.RHOS[tag][problem]:
        rho = torch.full((B,), r, dtype=dtype, device=dev)
        got = bk(params, ap, Z, rho)
        want = bk.plain(params, ap, Z, rho)
        sens, flips = tol.sensitivity(want, [bk.plain(params, ap, Zm, rho) for Zm in Zms])
        assert torch.equal(got[4][~flips], want[4][~flips])
        ok = ~want[4] & ~flips
        for name, g, w, rt in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4], (1e-9, 1e-9, 1e-8, 1e-8)):
            _close(name, g[..., ok], w[..., ok], dtype, rt, f32_rel, sens[ok])
        _close("J0", got[5], want[5], dtype, 1e-10, f32_rel)
    assert bk.launches == len(tol.RHOS[tag][problem])
    for alpha in (1.0, 0.5):
        a = torch.full((B,), alpha, dtype=dtype, device=dev)
        got = fk(params, ap, Z, want[0], want[1], a)
        exp_f = fk.plain(params, ap, Z, want[0], want[1], a)
        assert torch.equal(got[3], exp_f[3]) and torch.equal(got[4], exp_f[4])
        for name, g, w in zip(("Xn", "Ubar", "J"), got[:3], exp_f[:3]):
            _close(name, g, w, dtype, 1e-10, f32_rel)
    assert fk.launches == 2


def _own_fleet(problem, dtype, dev, Bz):
    """A fleet of Bz lanes of `problem` at its own horizon: parking N=100
    (x0 in ±0.1), or the zoo's quadrotor N=50 / cartpole N=60 (x0 spread
    0.05), rolled out, under a warm random AL state."""
    if problem != "parking":
        prob, _, params, Z, al = _zoo_fleet(problem, dtype, dev, Bz)
        return prob, params, Z, al
    rng = np.random.default_rng(0)
    defn = UnicycleProblem(dtype=dtype, device=dev)
    prob = defn.make_problem().compile()
    ev = ALSolverBatched(prob, SolverOptions())
    params = prob.params.replace(x0=torch.as_tensor(rng.uniform(-0.1, 0.1, (3, Bz)), device=dev).to(dtype))
    Z = ev.rollout(params, _fleet_Z(defn, Bz))
    al = tuple(
        dict(
            lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape), device=dev).to(dtype),
            rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape), device=dev).to(dtype),
        )
        for st in ev.al_state_init(Bz, dtype)
    )
    return prob, params, Z, al


@pytest.mark.parametrize("Bz", [1000, 1001, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("problem", ["parking", "cartpole", "quadrotor"])
def test_fused_kernels_match_plain_at_ragged_widths(problem, dtype, Bz):
    """Both fused kernels at each instance's own horizon, whose knots are
    no multiple of the kernels' chunks, and at three batch widths: B=1000
    (whole blocks of 8 lanes, the forward kernel's 16-byte copies), B=1001
    (a last block with one lane, copies element by element) and B=1.  The
    backward kernel at each of the problem's ρ (flags, K, d, ΔV within each
    float64 lane's sensitivity, J0), the forward kernel rolling out the
    plain gains of the largest ρ at α = 1 and 0.5."""
    dev = _device()
    prob, params, Z, al = _own_fleet(problem, dtype, dev, Bz)
    _hold_fused_kernels(problem, dtype, dev, prob, params, Z, al)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("problem", ["parking", "quadrotor"])
def test_fused_kernels_match_plain_with_a_cost_per_knot(problem, dtype):
    """A stacked cost family whose stage rows differ (each knot's Q scaled
    by its own factor) stays stacked: the kernels read a cost-table row per
    knot, staged in shared memory where the table fits TABLE_SMEM (parking
    in f32) and from device memory where it does not (parking in f64, the
    quadrotor).  Both kernels held as at the ragged widths, B=1001."""
    dev = _device()
    Bz = 1001
    prob, params, Z, al = _own_fleet(problem, dtype, dev, Bz)
    costs = list(params.costs)
    Q = costs[0]["Q"]
    costs[0] = dict(costs[0], Q=Q * (1.0 + 1e-3 * torch.arange(Q.shape[0], dtype=Q.dtype, device=dev))[:, None, None])
    params = params.replace(costs=tuple(costs))
    staged = problem == "parking" and dtype == torch.float32
    for kind in (BackwardFusedKernel, ForwardKernel):
        g = kind(prob, SolverOptions(), dtype=dtype, device=dev).geometry(Bz, params)
        assert (g.tab_smem > 0) == staged, (kind.KIND, g)
    _hold_fused_kernels(problem, dtype, dev, prob, params, Z, al)


def _obstacle_fleet(dtype, dev, Bz):
    """The three-obstacle problem (N=100, 7 stage multiplier rows) at Bz
    lanes whose positions spread over the obstacle field, so that the
    circle rows are penalized (chip_smoke.py's field_case), under a warm
    random AL state."""
    rng = np.random.default_rng(4)
    defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype, device=dev)
    prob = defn.make_problem().compile()
    t = lambda a: torch.as_tensor(a, device=dev).to(dtype)  # noqa: E731
    Nh = defn.N
    X = np.concatenate([rng.uniform(0.3, 2.7, (Nh + 1, 2, Bz)), rng.uniform(-np.pi, np.pi, (Nh + 1, 1, Bz))], axis=1)
    U = np.stack([rng.uniform(0.0, 1.5, (Nh, Bz)), rng.uniform(-1.0, 1.0, (Nh, Bz))], axis=1)
    x0 = np.concatenate([rng.uniform(0.3, 1.2, (2, Bz)), rng.uniform(-np.pi, np.pi, (1, Bz))])
    Z = _fleet_Z(defn, Bz).replace(X=t(X).contiguous(), U=t(U).contiguous())
    al = tuple(
        dict(lam=t(rng.uniform(-0.5, 0.0, st["lam"].shape)), rho=t(rng.uniform(1.0, 10.0, st["rho"].shape)))
        for st in ALSolverBatched(prob, SolverOptions()).al_state_init(Bz, dtype)
    )
    return prob, prob.params.replace(x0=t(x0)), Z, al


@pytest.mark.parametrize("Bz", [1000, 1001, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_fused_kernels_match_plain_on_the_obstacle_problem(dtype, Bz):
    """Both fused kernels take the three-obstacle problem (circle rows in
    compensated arithmetic, their off-diagonal Gauss-Newton term) and match
    their plain versions as at the ragged widths."""
    dev = _device()
    prob, params, Z, al = _obstacle_fleet(dtype, dev, Bz)
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    assert (kern.Ps, kern.Fs) == (7, 2)
    _hold_fused_kernels("obstacles", dtype, dev, prob, params, Z, al)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_circle_rows_match_comp_circle_bitwise(dtype):
    """The kernels' circle rows (csrc/lane_algebra.cuh:comp_circle, through
    circle_rows_on_card) equal the plain version's bit for bit, near the
    obstacles' edges, where the squares cancel, and away from them."""
    from altro_tpu_torch.ops.backward_fused import circle_rows_on_card, comp_circle

    dev = _device()
    rng = np.random.default_rng(6)
    r = rng.uniform(0.2, 1.0, 1 << 14)
    phi = rng.uniform(0, 2 * np.pi, r.size)
    rad = np.concatenate([r[:8192] * (1 + rng.uniform(-1e-3, 1e-3, 8192)), rng.uniform(0.0, 3.0, r.size - 8192)])
    dx, dy, rr = (torch.as_tensor(a, device=dev).to(dtype) for a in (rad * np.cos(phi), rad * np.sin(phi), r))
    got, want = circle_rows_on_card(dx, dy, rr), comp_circle(dx, dy, rr)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _hold_fused_kernels(problem, dtype, dev, prob, params, Z, al):
    """The backward kernel at each of the problem's ρ (flags, K, d, ΔV
    within each float64 lane's sensitivity, J0), the forward kernel rolling
    out the plain gains of the largest ρ at α = 1 and 0.5, each against its
    plain version."""
    Bz = Z.X.shape[-1]
    tag = "f64" if dtype == torch.float64 else "f32"
    f32_rel = dict(parking=tol.F32_REL, obstacles=tol.OBSTACLE_F32_REL).get(problem) or tol.ZOO_F32_REL[problem]
    bk = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    fk = ForwardKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    ap = bk.pad_al(al)
    rng = np.random.default_rng(3)
    Zms = [Z.replace(X=tol.ulp_moved(Z.X, rng), U=tol.ulp_moved(Z.U, rng)) for _ in range(tol.SENS_DRAWS)]
    for r in tol.RHOS[tag][problem]:
        rho = torch.full((Bz,), r, dtype=dtype, device=dev)
        got = bk(params, ap, Z, rho)
        want = bk.plain(params, ap, Z, rho)
        sens, flips = tol.sensitivity(want, [bk.plain(params, ap, Zm, rho) for Zm in Zms])
        assert torch.equal(got[4][~flips], want[4][~flips])
        ok = ~want[4] & ~flips
        for name, g, w, rt in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4], (1e-9, 1e-9, 1e-8, 1e-8)):
            _close(name, g[..., ok], w[..., ok], dtype, rt, f32_rel, sens[ok])
        _close("J0", got[5], want[5], dtype, 1e-10, f32_rel)
    assert bk.launches == len(tol.RHOS[tag][problem])
    for alpha in (1.0, 0.5):
        a = torch.full((Bz,), alpha, dtype=dtype, device=dev)
        got = fk(params, ap, Z, want[0], want[1], a)
        exp_f = fk.plain(params, ap, Z, want[0], want[1], a)
        assert torch.equal(got[3], exp_f[3]) and torch.equal(got[4], exp_f[4])
        for name, g, w in zip(("Xn", "Ubar", "J"), got[:3], exp_f[:3]):
            _close(name, g, w, dtype, 1e-10, f32_rel)
    assert fk.launches == 2


def test_golden_f64_through_the_riccati_kernel():
    """backward_pass="pallas" (the Riccati kernel over the eager expansions)
    reproduces the reference golden in float64: SOLVED, 14 / 5, J."""
    dev = _device()
    defn = UnicycleProblem(dtype=torch.float64, device=dev)
    prob = defn.make_problem().compile()
    fb = ALSolverBatched(
        prob, SolverOptions(constraint_tolerance=1e-6, backward_pass="pallas", forward_pass="cuda")
    )
    assert fb._bwd is None and fb._ric is not None
    params = prob.params.replace(x0=torch.zeros((3, 3), dtype=torch.float64, device=dev))
    res = fb.solve(params, _fleet_Z(defn, 3))
    assert fb._ric.launches > 0 and fb._fwd.launches > 0
    assert (res["status"] == int(SolverStatus.SOLVED)).all()
    assert (res["stats"].iterations_total == 14).all() and (res["stats"].iterations_outer == 5).all()
    J = fb.total_cost(params, res["al"], res["Z"]).cpu().numpy()
    np.testing.assert_allclose(J, 0.03893465058924039, rtol=1e-9)


def test_fused_kernels_solve_the_quadrotor_as_the_eager_path():
    """backward_pass="fused" with forward_pass="cuda" on the zoo's quadrotor
    (float64, N=20, B=8): both fused kernels are launched, no Riccati
    kernel, and every lane SOLVES at the eager path's cost: median relative
    difference below 1e-3, every lane below 2e-2 (perf/benchmark_zoo.py's
    contract; the quadrotor's iteration path follows rounding, and two
    paths may stop at points of the tolerance region that differ by a few
    1e-3)."""
    dev = _device()
    prob, Z0, x0, _ = zoo_quadrotor(N=20, tf=1.0, dtype=torch.float64, device=dev)
    Bq = 8
    rng = np.random.default_rng(2)
    x0s = x0.cpu().numpy()[:, None] + 0.05 * rng.standard_normal((13, Bq))
    params = prob.params.replace(x0=torch.as_tensor(x0s, device=dev))
    Z = BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, Bq).contiguous(),
                          U=Z0.U[..., None].expand(-1, -1, Bq).contiguous(), t=Z0.t, h=Z0.h)
    J = {}
    for kind, kw in (("eager", {}), ("kernels", dict(backward_pass="fused", forward_pass="cuda"))):
        s = ALSolverBatched(prob, SolverOptions(**kw))
        res = s.solve(params, Z)
        if kind == "kernels":
            assert s._ric is None and s._bwd.launches > 0 and s._fwd.launches > 0
        assert (res["status"] == int(SolverStatus.SOLVED)).all(), kind
        J[kind] = s.total_cost(params, s.al_state_init(Bq, torch.float64), res["Z"]).cpu().numpy()
    rel = np.abs(J["kernels"] - J["eager"]) / np.abs(J["eager"])
    assert np.median(rel) < 1e-3 and rel.max() < 2e-2, rel


def _randomized_fleet(dtype, dev, Bz, seed=4):
    """The randomized three-obstacle fleet (`models.problems.randomized_fleet`:
    per-lane x0, obstacle layouts, goals and the tracking cost's q, c per
    knot and lane) at N=100 and Bz lanes, at an expansion point spread over
    the obstacle field (as `_obstacle_fleet`), under a warm random AL
    state."""
    from altro_tpu_torch.models.problems import randomized_fleet

    rng = np.random.default_rng(seed)
    defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype, device=dev)
    prob = defn.make_problem().compile()
    params, _, _ = randomized_fleet(defn, prob, Bz, seed=seed)
    t = lambda a: torch.as_tensor(a, device=dev).to(dtype)  # noqa: E731
    Nh = defn.N
    X = np.concatenate([rng.uniform(0.3, 2.7, (Nh + 1, 2, Bz)), rng.uniform(-np.pi, np.pi, (Nh + 1, 1, Bz))], axis=1)
    U = np.stack([rng.uniform(0.0, 1.5, (Nh, Bz)), rng.uniform(-1.0, 1.0, (Nh, Bz))], axis=1)
    Z = _fleet_Z(defn, Bz).replace(X=t(X).contiguous(), U=t(U).contiguous())
    al = tuple(
        dict(lam=t(rng.uniform(-0.5, 0.0, st["lam"].shape)), rho=t(rng.uniform(1.0, 10.0, st["rho"].shape)))
        for st in ALSolverBatched(prob, SolverOptions()).al_state_init(Bz, dtype)
    )
    return prob, params, Z, al


@pytest.mark.parametrize("Bz", [4096, 1001, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_fused_kernels_match_plain_on_the_randomized_fleet(dtype, Bz):
    """Both fused kernels' lane-params instantiations on the randomized
    fleet (six per-lane leaves: circle cx, cy, r, goal xf, cost q and c per
    knot) match their plain versions as at the ragged widths, within the
    obstacle problem's bounds."""
    dev = _device()
    prob, params, Z, al = _randomized_fleet(dtype, dev, Bz)
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    assert len(kern.param_sig(params)) == 6
    _hold_fused_kernels("obstacles", dtype, dev, prob, params, Z, al)


def _bitwise(a, b) -> bool:
    return all(x.view(torch.uint8).equal(y.view(torch.uint8)) if x.dtype.is_floating_point else x.equal(y)
               for x, y in zip(a, b))


def _broadcast_lanes(prob, params, Bz):
    """`params` with the randomized fleet's six leaves made per lane again,
    each the problem's own (shared) value broadcast to every lane."""
    canon = prob.params
    kinds = [f.constraint.structure[0] for f in prob.constraint_families]
    cons = list(params.constraints)
    for kind in ("circle", "goal"):
        i = kinds.index(kind)
        cons[i] = {k: v[..., None].expand(*v.shape, Bz).contiguous() for k, v in canon.constraints[i].items()}
    cp = canon.costs[0]
    costs = (dict(params.costs[0], **{k: cp[k][..., None].expand(*cp[k].shape, Bz).contiguous() for k in ("q", "c")}),)
    return params.replace(constraints=tuple(cons), costs=costs)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_lane_params_broadcast_equal_shared_bitwise(dtype):
    """Per-lane leaves that hold the problem's own value in every lane give
    bit for bit the outputs of the shared-param launch: the descriptor holds
    the float64 image of each scalar-type value, the lane table the value."""
    dev = _device()
    Bz = 1001
    prob, _, Z, al = _randomized_fleet(dtype, dev, Bz)
    shared = prob.params.replace(x0=torch.zeros((3, Bz), dtype=dtype, device=dev))
    lanes = _broadcast_lanes(prob, shared, Bz)
    bk = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    fk = ForwardKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    assert bk.param_sig(shared) == frozenset() and len(bk.param_sig(lanes)) == 6
    ap = bk.pad_al(al)
    for r in tol.RHOS["f64" if dtype == torch.float64 else "f32"]["obstacles"]:
        rho = torch.full((Bz,), r, dtype=dtype, device=dev)
        a, b = bk(shared, ap, Z, rho), bk(lanes, ap, Z, rho)
        assert _bitwise(a, b), f"backward rho={r}"
    a1 = torch.full((Bz,), 0.5, dtype=dtype, device=dev)
    assert _bitwise(fk(shared, ap, Z, a[0], a[1], a1), fk(lanes, ap, Z, a[0], a[1], a1))
    assert bk.launches == 2 * len(tol.RHOS["f64" if dtype == torch.float64 else "f32"]["obstacles"])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_lane_permutation_permutes_outputs_bitwise(dtype):
    """Lanes are independent: permuting the lanes of the per-lane params,
    x0, X, U and the AL state permutes every output of both kernels, bit
    for bit (B=4096: whole blocks, 16-byte copies)."""
    from altro_tpu_torch.solver.batched import gather_params

    dev = _device()
    Bz = 4096
    prob, params, Z, al = _randomized_fleet(dtype, dev, Bz)
    perm = torch.as_tensor(np.random.default_rng(8).permutation(Bz), device=dev)
    pp = gather_params(prob.params, params, perm)
    Zp = Z.replace(X=Z.X[..., perm].contiguous(), U=Z.U[..., perm].contiguous())
    alp = tuple(dict(lam=s["lam"][..., perm].contiguous(), rho=s["rho"][..., perm].contiguous()) for s in al)
    bk = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    fk = ForwardKernel(prob, SolverOptions(), dtype=dtype, device=dev)
    rho = torch.full((Bz,), 0.37, dtype=dtype, device=dev)
    a, b = bk(params, bk.pad_al(al), Z, rho), bk(pp, bk.pad_al(alp), Zp, rho)
    assert _bitwise([x[..., perm] for x in a], b)
    a1 = torch.full((Bz,), 0.5, dtype=dtype, device=dev)
    f = fk(params, fk.pad_al(al), Z, a[0], a[1], a1)
    g = fk(pp, fk.pad_al(alp), Zp, a[0][..., perm].contiguous(), a[1][..., perm].contiguous(), a1)
    assert _bitwise([x[..., perm] for x in f], g)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("problem,key", [("cartpole", "mass_pole"), ("quadrotor", "J")])
def test_fused_kernels_match_plain_with_per_lane_dynamics(problem, key, dtype):
    """A per-lane dynamics param (the cartpole's pole mass [B], the
    quadrotor's inertia J [3, B], each lane's scaled by U(0.8, 1.2)) at
    B=2048 on the zoo's fleets: both kernels' lane-params instantiations
    against their plain versions, held as at the ragged widths."""
    dev = _device()
    prob, _, params, Z, al = _zoo_fleet(problem, dtype, dev, 2048)
    leaf = params.dynamics[0][key]
    scale = np.random.default_rng(9).uniform(0.8, 1.2, tuple(leaf.shape) + (2048,))
    lane = leaf[..., None] * torch.as_tensor(scale, device=dev).to(dtype)
    params = params.replace(dynamics=(dict(params.dynamics[0], **{key: lane}),))
    Z = ALSolverBatched(prob, SolverOptions()).rollout(params, Z)
    assert len(BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev).param_sig(params)) == 1
    _hold_fused_kernels(problem, dtype, dev, prob, params, Z, al)


def test_polish_on_the_kernels_matches_the_plain_passes():
    """The compacted solver with the float64 polish on a float64 obstacle
    fleet whose total cap of 20 leaves a residue for both polish stages
    (N=20, B=16, as tests/test_torch_polish.py): on the fused kernels
    (their float64 instantiations in phase 1, the tail and the polish)
    and on the plain passes, on the card.  The polish takes the same lanes
    per stage; statuses and iterations are equal and U within 1e-8."""
    dev = _device()
    Bp = 16
    defn = UnicycleProblem(scenario="three_obstacles", dtype=torch.float64, device=dev, N=20)
    prob = defn.make_problem().compile()
    x0 = np.random.default_rng(1).uniform(-0.3, 0.3, (3, Bp))
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=torch.as_tensor(x0, device=dev))
    opts = dict(initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10,
                max_iterations_total=20)
    out, tel = {}, {}
    for kind, kw in (("plain", {}), ("kernels", dict(backward_pass="fused", forward_pass="cuda"))):
        comp = CompactedALSolver(prob, SolverOptions(**opts, **kw), phase1_iters=8, tail_batch=8,
                                 f64_polish=True, polish_batch=3, device_tail=True)
        out[kind] = comp.solve(params, _fleet_Z(defn, Bp))
        tel[kind] = [(s["stage"], s["instances"]) for s in comp.telemetry["polish"]["stages"]]
        if kind == "kernels":
            assert all(s._bwd is not None and s._bwd.launches > 0 and s._fwd.launches > 0 for s in comp._polish)
    assert tel["kernels"] == tel["plain"] and tel["plain"][0][1] > 3
    assert torch.equal(out["kernels"]["status"], out["plain"]["status"])
    assert torch.equal(out["kernels"]["stats"].iterations_total, out["plain"]["stats"].iterations_total)
    np.testing.assert_allclose(out["kernels"]["Z"].U.cpu().numpy(), out["plain"]["Z"].U.cpu().numpy(),
                               rtol=0, atol=1e-8)


def test_history_on_the_kernels_changes_no_decision():
    """bench.make_solver's program on the kernels (float32 parking fleet,
    B=1001, bench options, float64 polish) with the iteration history at
    capacity 96 and without: statuses, iterations and U bit for bit, the
    same host syncs, and each lane's count of valid rows equal to its
    iterations."""
    dev = _device()
    Bh = 1001
    defn = UnicycleProblem(dtype=torch.float32, device=dev, N=100)
    prob = defn.make_problem().compile()
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.1, 0.1, (3, Bh)), device=dev).float()
    params = prob.params.replace(x0=x0)
    bench = dict(backward_pass="fused", forward_pass="cuda", line_search_max_iterations=6, max_stall_iterations=3)
    res, syncs = {}, {}
    for cap in (0, 96):
        comp = CompactedALSolver(prob, SolverOptions(**bench, iteration_history_capacity=cap),
                                 phase1_iters=14, tail_batch=1024, f64_polish=True, device_tail=True)
        res[cap] = comp.solve(params, _fleet_Z(defn, Bh))
        syncs[cap] = comp.host_syncs
        assert comp._p1._bwd.launches > 0 and comp._p1._fwd.launches > 0
    assert syncs[0] == syncs[96]
    assert torch.equal(res[0]["status"], res[96]["status"])
    assert torch.equal(res[0]["stats"].iterations_total, res[96]["stats"].iterations_total)
    assert torch.equal(res[0]["Z"].U.view(torch.int32), res[96]["Z"].U.view(torch.int32))
    rows = res[96]["stats"].rows
    assert tuple(rows.shape) == (96, 8, Bh)
    valid = (rows != 0).any(dim=1).sum(dim=0)
    assert torch.equal(valid, res[96]["stats"].iterations_total.clamp(max=96).long())


def test_certificates_on_the_card_equal_the_cpu():
    """`goal_obstacle_certificates` on the randomized fleet (B=4096, per-lane
    goals and obstacle layouts, float32) with 16 goals moved into their own
    first obstacle: the mask on the card equals the mask of the same params
    on the CPU, with and without the step bound v_max·h."""
    from altro_tpu_torch.models.problems import randomized_fleet
    from altro_tpu_torch.problem.infeasibility import goal_obstacle_certificates

    dev = _device()
    Bc = 4096
    defn = UnicycleProblem(scenario="three_obstacles", dtype=torch.float32, device=dev)
    prob = defn.make_problem().compile()
    params, (cx, cy, _), xf = randomized_fleet(defn, prob, Bc, seed=2)
    lanes = np.random.default_rng(3).choice(Bc, 16, replace=False)
    xf = xf.copy()
    xf[0, lanes], xf[1, lanes] = cx[0, lanes], cy[0, lanes]
    gi = [f.constraint.structure[0] for f in prob.constraint_families].index("goal")
    cons = list(params.constraints)
    cons[gi] = dict(cons[gi], xf=torch.as_tensor(xf, device=dev).float())
    params = params.replace(constraints=tuple(cons))
    on_cpu = params.replace(
        x0=params.x0.cpu(),
        constraints=tuple({k: v.cpu() for k, v in c.items()} for c in params.constraints),
    )
    for step_bound in (0.0, float(defn.v_bnd * defn.tf / defn.N)):
        card = goal_obstacle_certificates(prob, params, Bc, step_bound)
        cpu = goal_obstacle_certificates(prob, on_cpu, Bc, step_bound)
        assert card.device.type == "cuda" and cpu.device.type == "cpu"
        assert torch.equal(card.cpu(), cpu)
        if step_bound > 0:
            assert sorted(torch.nonzero(cpu).flatten().tolist()) == sorted(lanes.tolist())


def _spec_solution(problem, dtype, dev, Bz, S, lockstep=False):
    """A solve on both fused kernels at line_search_parallel S: the parking
    problem (N=100, x0 in ±0.1 from seed 0) with the bench's line search
    (6 tries), or the randomized fleet (N=100, its per-lane leaves, the
    obstacle fleet's options) capped at 30 total iterations.  `lockstep`:
    at S = 1, the lockstep search over the kernel (one launch and one host
    sync a try) in the place of the kernel's own search."""
    from altro_tpu_torch.models.problems import randomized_fleet

    if problem == "parking":
        defn = UnicycleProblem(dtype=dtype, device=dev)
        prob = defn.make_problem().compile()
        x0 = np.random.default_rng(0).uniform(-0.1, 0.1, (3, Bz))
        params = prob.params.replace(x0=torch.as_tensor(x0, device=dev).to(dtype))
        opts = SolverOptions(backward_pass="fused", forward_pass="cuda", line_search_max_iterations=6)
    else:
        defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype, device=dev)
        prob = defn.make_problem().compile()
        params, _, _ = randomized_fleet(defn, prob, Bz, seed=0)
        opts = SolverOptions(backward_pass="fused", forward_pass="cuda", initial_penalty=1.0,
                             line_search_max_iterations=20, max_stall_iterations=10,
                             outer_constraints_f64=True, max_iterations_total=30)
    solver = ALSolverBatched(prob, opts.replace(line_search_parallel=S))
    assert solver._fwd is not None and solver._bwd is not None
    if lockstep:
        def search(self, fwd, params, al_pad, Z, bp, J0, active):
            return ALSolverBatched._line_search_sequential(self, fwd, params, None, al_pad, Z, bp, J0)

        solver._line_search_device = search.__get__(solver)
    res = solver.solve(params, _fleet_Z(defn, Bz))
    return res, solver


def _equal_solves(a, b):
    assert torch.equal(a["status"], b["status"])
    for key in ("iterations_total", "iterations_outer", "alpha", "cost"):
        assert _bitwise([getattr(a["stats"], key)], [getattr(b["stats"], key)]), key
    assert _bitwise([a["Z"].U, a["Z"].X], [b["Z"].U, b["Z"].X])


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("Bz", [1001, 4096])
def test_speculative_line_search_equals_sequential_on_the_kernels(Bz, dtype, S):
    """S step sizes in one forward launch at S·B lanes accept what the
    sequential (lockstep) search accepts: statuses, iterations, α, cost, U
    and X bit for bit, with fewer forward launches and host syncs; and so
    does the kernel's own search at S = 1, with fewer host syncs than
    either and no more launches."""
    dev = _device()
    base, s1 = _spec_solution("parking", dtype, dev, Bz, 1, lockstep=True)
    res, sS = _spec_solution("parking", dtype, dev, Bz, S)
    own, sd = _spec_solution("parking", dtype, dev, Bz, 1)
    _equal_solves(res, base)
    _equal_solves(own, base)
    assert sS._fwd.launches < s1._fwd.launches and sS.host_syncs < s1.host_syncs
    # at S = 8 over 6 tries a speculative search is one launch too
    assert sd._fwd.launches <= sS._fwd.launches and sd.host_syncs < sS.host_syncs
    assert sS._bwd.launches == s1._bwd.launches == sd._bwd.launches


def test_speculative_line_search_on_the_lane_params_kernels():
    """The randomized fleet (B=1001, per-lane leaves, capped at 30
    iterations) at S=4 against S=1: the lane-params forward kernel at
    4·1001 lanes, one lane table of 4·1001 lanes for the solve, every
    result bit for bit."""
    dev = _device()
    base, _ = _spec_solution("randomized", torch.float32, dev, 1001, 1)
    res, s4 = _spec_solution("randomized", torch.float32, dev, 1001, 4)
    _equal_solves(res, base)
    assert sorted(e[3].shape[1] for e in s4._fwd._prep) == [1001, 4 * 1001]


def _triple_fleet(dtype, dev, Bz):
    """TripleIntegratorProblem (dof 2, N=10, its control bounds and goal)
    at Bz lanes, x0 spread 0.05 about its start, rolled out, under a warm
    random AL state."""
    rng = np.random.default_rng(0)
    defn = TripleIntegratorProblem(dtype=dtype, device=dev)
    prob = defn.make_problem(add_constraints=True).compile()
    ev = ALSolverBatched(prob, SolverOptions())
    x0s = defn.x0[:, None] + 0.05 * rng.standard_normal((prob.n, Bz))
    params = prob.params.replace(x0=torch.as_tensor(x0s, device=dev).to(dtype))
    Z = ev.rollout(params, _fleet_Z(defn, Bz))
    al = tuple(
        dict(
            lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape), device=dev).to(dtype),
            rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape), device=dev).to(dtype),
        )
        for st in ev.al_state_init(Bz, dtype)
    )
    return prob, params, Z, al


@pytest.mark.parametrize("Bz", [2048, 1001, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_fused_kernels_match_plain_on_the_triple_integrator(dtype, Bz):
    """The (6, 2) instantiations (`csrc/models.cuh:TripleIntegrator<2>`)
    against their plain versions, as at the ragged widths."""
    dev = _device()
    prob, params, Z, al = _triple_fleet(dtype, dev, Bz)
    assert BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev).model_name == "triple_integrator2"
    _hold_fused_kernels("triple", dtype, dev, prob, params, Z, al)


@pytest.mark.parametrize("problem", ["soc", "hybrid"])
def test_general_problems_through_the_riccati_kernel_equal_eager(problem):
    """A second-order cone (the velocity-cone unicycle, N=40) and two
    dynamics families (the hybrid triple integrator at dof 2, N=40), B=256,
    float64: backward_pass="fused" falls back to the Riccati kernel (and the
    eager forward pass), whose solve equals the eager passes' in statuses
    and iterations, U within 1e-9 of max(|U|, 1)."""
    from altro_tpu_torch.models.problems import hybrid_triple_integrator, soc_unicycle
    from altro_tpu_torch.types import initial_trajectory

    dev = _device()
    Bz = 256
    rng = np.random.default_rng(0)
    if problem == "soc":
        defn, prob = soc_unicycle(40, device=dev)
        x0, Z0 = rng.uniform(-0.2, 0.2, (3, Bz)), defn.initial_trajectory()
    else:
        prob, x00, _ = hybrid_triple_integrator(2, 40, device=dev)
        x0 = x00[:, None] + rng.uniform(-0.2, 0.2, (6, Bz))
        Z0 = initial_trajectory(6, 2, 40, 0.1, dtype=torch.float64, device=dev)
    params = prob.params.replace(x0=torch.as_tensor(x0, device=dev))
    Z = BatchedTrajectory(Z0.X[..., None].expand(-1, -1, Bz).contiguous(),
                          Z0.U[..., None].expand(-1, -1, Bz).contiguous(), Z0.t, Z0.h)
    sk = ALSolverBatched(prob, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    assert sk._bwd is None and sk._fwd is None and sk._ric is not None
    rk = sk.solve(params, Z)
    re_ = ALSolverBatched(prob, SolverOptions()).solve(params, Z)
    assert sk._ric.launches > 0
    assert torch.equal(rk["status"], re_["status"])
    assert torch.equal(rk["stats"].iterations_total, re_["stats"].iterations_total)
    scale = max(float(re_["Z"].U.abs().max()), 1.0)
    assert float((rk["Z"].U - re_["Z"].U).abs().max()) <= 1e-9 * scale
    assert float((rk["status"] == int(SolverStatus.SOLVED)).float().mean()) >= 0.99


def test_batched_mpc_on_the_kernels_equals_the_eager_passes():
    """`BatchedMPC` at B=64, float64, 5 closed-loop ticks at most 3
    iterations a tick (perf/mpc_device_latency.py's configuration): on the
    fused kernels, with a new params object and the warm AL state every
    tick, against the eager passes: statuses and iterations equal at every
    tick, u0 within 1e-9."""
    from altro_tpu_torch import BatchedMPC
    from altro_tpu_torch.models.unicycle import unicycle_rk4

    dev = _device()
    Bz = 64
    defn = UnicycleProblem(dtype=torch.float64, device=dev)
    prob = defn.make_problem().compile()
    model = unicycle_rk4()
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.1, 0.1, (3, Bz)), device=dev)
    runs = []
    for kw in (dict(backward_pass="fused", forward_pass="cuda"), {}):
        mpc = BatchedMPC(prob, SolverOptions(max_iterations_total=3, max_iterations_inner=3, **kw))
        state, x, ticks = mpc.init(_fleet_Z(defn, Bz)), x0, []
        for _ in range(5):
            u0, state = mpc.step(state, x)
            x = model(x, u0, 0.0, defn.h)
            ticks.append((u0, state.status, state.iterations))
        runs.append((mpc, ticks))
    (mk, tk), (_, te) = runs
    assert mk.solver._bwd.launches > 0 and mk.solver._fwd.launches > 0
    for (uk, sk, ik), (ue, se, ie) in zip(tk, te):
        assert torch.equal(sk, se) and torch.equal(ik, ie)
        assert float((uk - ue).abs().max()) <= 1e-9


def test_al_solver_goldens_on_the_card():
    """The per-instance `ALSolver` on CUDA tensors, float64: SOLVED, 14
    total / 5 outer iterations, J within 1e-9 of 0.03893465058924039
    (`auglag_test.cpp:325-351`)."""
    from altro_tpu_torch import ALSolver

    dev = _device()
    defn = UnicycleProblem(dtype=torch.float64, device=dev)
    prob = defn.make_problem().compile()
    solver = ALSolver(prob, SolverOptions(constraint_tolerance=1e-6))
    res = solver.solve(prob.params, defn.initial_trajectory())
    assert res.Z.U.device.type == "cuda"
    assert int(res.status) == SolverStatus.SOLVED
    assert (res.stats.iterations_total, res.stats.iterations_outer) == (14, 5)
    J = float(solver.fns.total_cost(prob.params, res.al, res.Z))
    assert abs(J - 0.03893465058924039) <= 1e-9


def test_two_gloo_ranks_on_one_card_are_the_unsharded_solve(tmp_path):
    """Two gloo ranks of tests/_torch_dist_worker.py on cuda:0, on the fused
    kernels, float64: each rank's lanes of the lane-major and obstacle
    fleets (B=64, the lane-major one also on the mesh over the ranks in
    reverse order) and of the batch-leading triple-integrator fleet (B=16)
    bit for bit with the unsharded solve on the card, the folds equal to
    its, and three one-element all_reduces each solve's only collectives."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from _torch_dist_worker import KERNELS, instance_case, lane_major_case, obstacles_case
    from altro_tpu_torch.parallel.batch import BatchedALSolver

    dev = _device()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = Path(__file__).parent / "_torch_dist_worker.py"
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), "2", str(port), str(tmp_path), "cuda:0", "kernels"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            log, _ = p.communicate(timeout=600)
            assert p.returncode == 0, log.decode(errors="replace")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, case in (("lane_major", lane_major_case), ("obstacles", obstacles_case), ("instance", instance_case),
                       ("reversed", lane_major_case)):
        ranks = [dict(np.load(tmp_path / f"rank{r}_{name}.npz")) for r in range(2)]
        prob, opts, params, Z = case(dev)
        opts = opts.replace(**KERNELS)
        if name == "instance":
            ref = BatchedALSolver(prob, opts).solve(params, Z)
            status, it, U, viol = ref.status, ref.stats.iterations_total, ref.Z.U, ref.stats.violations
        else:
            solver = ALSolverBatched(prob, opts)
            assert solver._bwd is not None and solver._fwd is not None
            ref = solver.solve(params, Z)
            status, it, U, viol = ref["status"], ref["stats"].iterations_total, ref["Z"].U, ref["stats"].violations
        status, it, U = status.cpu().numpy(), it.cpu().numpy(), U.cpu().numpy()
        W = status.shape[0] // 2
        folds = [float(viol.max()), int((status == int(SolverStatus.SOLVED)).sum()),
                 int((status == int(SolverStatus.SOLVED_STALLED)).sum())]
        for r, out in enumerate(ranks):
            # on the mesh over the ranks in reverse order, rank r takes the other half
            lanes = slice(*(int(v) for v in out["lanes"])) if name == "reversed" else slice(r * W, (r + 1) * W)
            np.testing.assert_array_equal(out[f"{name}_status"], status[lanes])
            np.testing.assert_array_equal(out[f"{name}_iterations"], it[lanes])
            lane_U = U[lanes] if name == "instance" else U[..., lanes]
            np.testing.assert_array_equal(out[f"{name}_U"].view(np.uint64), lane_U.view(np.uint64))
            assert list(out[f"{name}_folds"]) == folds
            assert list(out[f"{name}_collectives"]) == ["all_reduce_max:1:8", "all_reduce_sum:1:4", "all_reduce_sum:1:4"]
            assert list(out[f"{name}_calls"]) == ["all_reduce:3"]

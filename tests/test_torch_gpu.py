"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips at run time when no CUDA device is present.
This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)  Inputs are
made from a numpy seed; B=1000 is not a multiple of the 128-thread block,
so the ragged edge of the grid is covered.  float64 bounds are algorithmic;
float32 bounds are those of chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from altro_tpu_torch import SolverOptions, SolverStatus
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
from altro_tpu_torch.ops.forward import ForwardKernel
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.solver.compaction import CompactedALSolver

N, B = 12, 1000
STATE_MAX = 5.0
DTYPES = [torch.float64, torch.float32]
F32_REL = dict(K=3e-4, d=3e-4, dV1=8e-6, dV2=8e-6, J0=2e-6, Xn=2e-6, Ubar=2e-6, J=5e-6)

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


def _close(name, got, want, dtype, rtol64):
    g, w = got.double().cpu(), want.double().cpu()
    if dtype == torch.float64:
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol64, atol=1e-10, err_msg=name)
    else:
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1.0)
        assert rel <= F32_REL[name], f"{name}: {rel:.3e}"


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
        comp = CompactedALSolver(prob, SolverOptions(**kw), phase1_iters=5, tail_batch=8)
        out[kind] = comp.solve(params, _fleet_Z(defn, 16))
    assert torch.equal(out["eager"]["status"], out["kernels"]["status"])
    assert torch.equal(out["eager"]["stats"].iterations_total, out["kernels"]["stats"].iterations_total)
    np.testing.assert_allclose(
        out["kernels"]["Z"].U.cpu().numpy(), out["eager"]["Z"].U.cpu().numpy(), rtol=0, atol=1e-9
    )

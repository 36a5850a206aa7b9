"""The forward kernel's line search on the card (`ForwardKernel.search`:
one launch per search, no host sync) against the lockstep search over the
same kernel (`ALSolverBatched._line_search_sequential`: one launch and one
host sync a round), bit for bit.

Marked `gpu`, and skips at run time without a CUDA device, as
tests/test_torch_gpu.py does; it imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_search.py -q

Solves on both fused kernels: the parking problem (N=100, x0 in ±0.1, the
benchmark's 6 tries) in float32 at 2,048 and 32,768 lanes and in float64 at
1,024 (the width of the f64 polish), once at a decrease factor that is not a
power of two; and the zoo quadrotor (N=50, x0 hover + 0.05·N(0,1), the
benchmark's options) in float32 at 8,192.  Every status, iteration count,
α, cost, improvement ratio, X and U equals the lockstep solve's; the
device solve makes the lockstep solve's host syncs less its `line_search`
ones; its device-side counts (`ls_counts`) are the lockstep search's
tries on the inner loop's lanes, those lanes and those tries taken for
each block of LANES lanes as its slowest lane's; and each search is one
`launches` and one `forward_kernel` event of the device trace.
"""
import re

import numpy as np
import pytest
import torch

from altro_tpu_torch import SolverOptions, SolverStatus
from altro_tpu_torch.models.problems import UnicycleProblem, zoo_quadrotor
from altro_tpu_torch.ops.backward_fused import LANES
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.utils import timer

pytestmark = pytest.mark.gpu

PARKING = dict(backward_pass="fused", forward_pass="cuda", line_search_max_iterations=6, max_stall_iterations=3)
QUADROTOR = dict(backward_pass="fused", forward_pass="cuda", line_search_max_iterations=20,
                 max_stall_iterations=10, initial_penalty=1.0, outer_constraints_f64=True)
CASES = {
    "parking-f32-2048": ("parking", torch.float32, 2048, {}),
    "parking-f32-32768": ("parking", torch.float32, 32768, {}),
    "parking-f64-1024": ("parking", torch.float64, 1024, {}),
    "parking-f32-2048-factor1.7": ("parking", torch.float32, 2048, dict(line_search_decrease_factor=1.7)),
    "quadrotor-f32-8192": ("quadrotor", torch.float32, 8192, {}),
}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _fleet_Z(Z0, Bz):
    return BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, Bz).contiguous(),
                             U=Z0.U[..., None].expand(-1, -1, Bz).contiguous(), t=Z0.t, h=Z0.h)


def _problem(problem, dtype, dev, Bz, extra):
    if problem == "parking":
        defn = UnicycleProblem(dtype=dtype, device=dev)
        prob = defn.make_problem().compile()
        x0 = np.random.default_rng(0).uniform(-0.1, 0.1, (3, Bz))
        return (prob, SolverOptions(**PARKING, **extra), prob.params.replace(x0=torch.as_tensor(x0, device=dev).to(dtype)),
                _fleet_Z(defn.initial_trajectory(), Bz))
    prob, Z0, x0, _ = zoo_quadrotor(dtype=dtype, device=dev)
    x0s = x0[:, None] + 0.05 * torch.as_tensor(np.random.default_rng(1).normal(size=(13, Bz)), device=dev).to(dtype)
    return prob, SolverOptions(**QUADROTOR, **extra), prob.params.replace(x0=x0s), _fleet_Z(Z0, Bz)


def _lockstep(solver, counted):
    """`solver` with the lockstep search over its kernel in the device
    search's place, adding to `counted` what the device search counts:
    the tries on the inner loop's lanes, those lanes and the lane tries
    the kernel's blocks of LANES lanes would run for them."""
    def search(self, fwd, params, al_pad, Z, bp, J0, active):
        c = ALSolverBatched._line_search_sequential(self, fwd, params, None, al_pad, Z, bp, J0)
        tries = torch.where(active, c["it"], 0).long()
        pad = torch.nn.functional.pad(tries, (0, -tries.numel() % LANES)).view(-1, LANES)
        ends = torch.arange(1, pad.shape[0] + 1, device=tries.device) * LANES
        block = torch.clamp(tries.numel() - (ends - LANES), max=LANES)
        counted.append(torch.stack([tries.sum(), active.sum(), (pad.amax(dim=1) * block).sum()]))
        return c

    solver._line_search_device = search.__get__(solver)
    return solver


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32) if t.is_floating_point() else t


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_on_the_card_equals_the_lockstep_search(case):
    dev = _device()
    problem, dtype, Bz, extra = CASES[case]
    prob, opts, params, Zb = _problem(problem, dtype, dev, Bz, extra)
    out = {}
    for mode in ("lockstep", "device"):
        solver = ALSolverBatched(prob, opts)
        assert solver._fwd is not None and solver._bwd is not None
        counted = []
        if mode == "lockstep":
            _lockstep(solver, counted)
        with timer.tracing() as spans:
            res = solver.solve(params, Zb)
        torch.cuda.synchronize()
        out[mode] = (res, solver, sum(r.name == "sync.line_search" for r in spans), counted)
    (a, sa, ls_a, _), (b, sb, ls_b, counted) = out["device"], out["lockstep"]
    assert torch.equal(a["status"], b["status"])
    for key in ("iterations_inner", "iterations_outer", "iterations_total", "alpha", "cost",
                "improvement_ratio", "cost_decrease", "gradient"):
        assert torch.equal(_bits(getattr(a["stats"], key)), _bits(getattr(b["stats"], key))), key
    assert torch.equal(_bits(a["Z"].X), _bits(b["Z"].X)) and torch.equal(_bits(a["Z"].U), _bits(b["Z"].U))
    assert bool((a["status"] == int(SolverStatus.SOLVED)).any())
    assert ls_a == 0 and ls_b > 0 and sa.host_syncs == sb.host_syncs - ls_b
    assert sa._fwd.launches < sb._fwd.launches and sa._bwd.launches == sb._bwd.launches
    tries, lanes, run = sa.ls_counts.tolist()
    assert [tries, lanes, run] == torch.stack(counted).sum(dim=0).tolist()
    assert lanes > 0 and tries >= lanes and run >= tries


def test_every_search_is_one_launch_and_one_traced_event():
    """A device-search solve under torch.profiler (CUDA activity): the
    forward kernel's `launches` grow by its open-loop rollouts (one per
    inner solve) plus its searches (one per inner iteration), and the
    trace holds one `forward_kernel` event per launch."""
    from torch.profiler import ProfilerActivity, profile

    dev = _device()
    prob, opts, params, Zb = _problem("parking", torch.float32, dev, 2048, {})
    solver = ALSolverBatched(prob, opts)
    solver.solve(params, Zb)  # warm
    before = solver._fwd.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with timer.tracing() as spans:
            solver.solve(params, Zb)
        torch.cuda.synchronize()
    launched = solver._fwd.launches - before
    rollouts = sum(r.name == "ilqr.rollout" for r in spans)
    iters = sum(r.name == "ilqr.iter" for r in spans)
    assert launched == rollouts + iters and iters > rollouts > 0
    word = re.compile(r"\bforward_kernel\b")
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and word.search(e.name)]
    assert len(events) == launched, (len(events), launched)
    searches = [e for e in events if re.search(r"forward_kernel<\s*float\s*,[^,>]*,\s*true\s*>", e.name)]
    assert len(searches) == iters, [e.name for e in events[:3]]

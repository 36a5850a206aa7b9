"""The forward kernel's line search (`ForwardKernel.search`, one launch per
search with no host sync) against the lockstep search it replaces
(`ALSolverBatched._line_search_sequential` over the kernel, one try a
round and one host sync a round), float64 on the CPU, where the kernel's
wrapper runs its plain version.

Three problems: the parking problem of tests/test_torch_speculative.py
(N=12, B=256, x0 uniform in ±0.2, seeds 11 and 3); the zoo quadrotor at a
small fleet with the benchmark's options; and the three-obstacle fleet with
per-lane circle centres and x0 (the lane-params instantiation).  In each,
every status, iteration count, α, cost, improvement ratio, X and U is the
lockstep solve's bit for bit; the solve makes exactly the lockstep solve's
host syncs less its `line_search` ones; and its device-side counts
(`ls_counts`, `ls_tries`, `ls_block_tries`) are the lockstep search's
tries on the inner loop's active lanes, and those tries taken for each
block of the kernel's LANES lanes as its slowest lane's.  A lane with
budget 0 runs no try.
"""
import functools

import numpy as np
import pytest
import torch

from altro_tpu_torch import SolverOptions, SolverStatus
from altro_tpu_torch.models.problems import UnicycleProblem, zoo_quadrotor
from altro_tpu_torch.ops.backward_fused import LANES
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.utils import timer

from _torch_fleet import F64, one_torch_thread  # noqa: F401

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 12
PARKING_B = 256
QUAD_B, QUAD_N = 16, 25
OBST_B = 64
CASES = ["parking-11", "parking-3", "quadrotor", "obstacles"]


def _fleet_Z(Z0, Bz):
    return BatchedTrajectory(Z0.X[..., None].expand(-1, -1, Bz).contiguous(),
                             Z0.U[..., None].expand(-1, -1, Bz).contiguous(), Z0.t, Z0.h)


def _problem(case):
    """(compiled problem, options, params, initial trajectory) of a case."""
    if case.startswith("parking"):
        defn = UnicycleProblem(dtype=F64, N=N, device="cpu")
        prob = defn.make_problem().compile()
        x0 = torch.as_tensor(np.random.default_rng(int(case.split("-")[1])).uniform(-0.2, 0.2, (3, PARKING_B)))
        return prob, SolverOptions(forward_pass="cuda"), prob.params.replace(x0=x0), _fleet_Z(
            defn.initial_trajectory(), PARKING_B)
    if case == "quadrotor":
        prob, Z0, x0, _ = zoo_quadrotor(N=QUAD_N, tf=QUAD_N * 0.05, dtype=F64, device="cpu")
        x0s = x0[:, None] + 0.05 * torch.as_tensor(np.random.default_rng(5).normal(size=(13, QUAD_B)))
        opts = SolverOptions(backward_pass="fused", forward_pass="cuda", line_search_max_iterations=20,
                             max_stall_iterations=10, initial_penalty=1.0)
        return prob, opts, prob.params.replace(x0=x0s), _fleet_Z(Z0, QUAD_B)
    defn = UnicycleProblem(scenario="three_obstacles", dtype=F64, N=N, device="cpu")
    prob = defn.make_problem().compile()
    rng = np.random.default_rng(3)
    ci = next(i for i, f in enumerate(prob.constraint_families) if f.constraint.structure[0] == "circle")
    cons = list(prob.params.constraints)
    cons[ci] = dict(cons[ci],
                    cx=cons[ci]["cx"][:, None] + torch.as_tensor(rng.uniform(-0.1, 0.1, (3, OBST_B))),
                    cy=cons[ci]["cy"][:, None] + torch.as_tensor(rng.uniform(-0.1, 0.1, (3, OBST_B))))
    params = prob.params.replace(x0=torch.as_tensor(rng.uniform(-0.1, 0.1, (3, OBST_B))), constraints=tuple(cons))
    opts = SolverOptions(backward_pass="fused", forward_pass="cuda", initial_penalty=10.0)
    return prob, opts, params, _fleet_Z(defn.initial_trajectory(), OBST_B)


def _run(tries) -> int:
    """The lane tries the kernel's blocks run for per-lane `tries`: each
    block of LANES lanes runs every lane of it as long as its slowest."""
    t = tries.tolist()
    return sum(max(t[i:i + LANES]) * len(t[i:i + LANES]) for i in range(0, len(t), LANES))


@functools.lru_cache(maxsize=None)
def _solves(case):
    """The case solved with the device search, and with the lockstep search
    over the kernel in its place: (result, host syncs, line_search syncs,
    (tries, lanes, lane tries run) on the inner loop's active lanes) each."""
    prob, opts, params, Zb = _problem(case)
    out = {}
    for mode in ("device", "lockstep"):
        solver = ALSolverBatched(prob, opts)
        assert solver._fwd is not None and solver._fwd.takes(params)
        counted = [0, 0, 0]
        if mode == "lockstep":
            def lockstep(self, fwd, params, al_pad, Z, bp, J0, active):
                c = ALSolverBatched._line_search_sequential(self, fwd, params, None, al_pad, Z, bp, J0)
                counted[0] += int(c["it"][active].sum())
                counted[1] += int(active.sum())
                counted[2] += _run(torch.where(active, c["it"], 0))
                return c

            solver._line_search_device = lockstep.__get__(solver)
        with timer.tracing() as spans:
            res = solver.solve(params, Zb)
        ls = sum(r.name == "sync.line_search" for r in spans)
        if mode == "device":
            counted = solver.ls_counts.tolist()
        out[mode] = (res, solver.host_syncs, ls, tuple(counted), solver)
    return out


def _bits(t):
    return t.view(torch.int64) if t.dtype == F64 else t


@pytest.mark.parametrize("case", CASES)
def test_device_search_equals_lockstep_bitwise(case):
    out = _solves(case)
    a, b = out["device"][0], out["lockstep"][0]
    assert torch.equal(a["status"], b["status"])
    for key in ("iterations_inner", "iterations_outer", "iterations_total", "alpha", "cost",
                "improvement_ratio", "cost_decrease", "gradient"):
        assert torch.equal(_bits(getattr(a["stats"], key)), _bits(getattr(b["stats"], key))), key
    assert torch.equal(_bits(a["Z"].X), _bits(b["Z"].X))
    assert torch.equal(_bits(a["Z"].U), _bits(b["Z"].U))
    assert (a["status"] == int(SolverStatus.SOLVED)).any()


@pytest.mark.parametrize("case", CASES)
def test_host_syncs_fall_by_the_line_search_syncs(case):
    out = _solves(case)
    (_, syncs, ls, _, _), (_, syncs_lock, ls_lock, _, _) = out["device"], out["lockstep"]
    assert ls == 0 and ls_lock > 0
    assert syncs == syncs_lock - ls_lock


@pytest.mark.parametrize("case", CASES)
def test_ls_tries_counts_the_lockstep_tries_on_active_lanes(case):
    out = _solves(case)
    tries, lanes, run = out["device"][3]
    assert (tries, lanes, run) == out["lockstep"][3] and lanes > 0 and run >= tries
    assert out["device"][4].ls_tries == tries / lanes
    assert out["device"][4].ls_block_tries == run / lanes
    assert out["lockstep"][4].ls_counts.tolist() == [0, 0, 0]  # the lockstep search adds nothing


def _one_search(budget_of):
    """One search of the parking fleet's first inner iteration through the
    kernel's wrapper, with per-lane budgets `budget_of(B)`."""
    prob, opts, params, Zb = _problem("parking-11")
    solver = ALSolverBatched(prob, opts)
    fwd = solver._fwd
    al = solver.al_state_init(PARKING_B, F64, "cpu")
    al_pad = fwd.pad_al(al)
    exp = solver.expand(params, al, Zb)
    bp = solver.backward_pass(exp, torch.zeros(PARKING_B, dtype=F64), torch.zeros(PARKING_B, dtype=F64))
    J0 = exp["costs"].sum(dim=0)
    alpha = torch.full((PARKING_B,), 0.75, dtype=F64)
    before = timer.search_counts("cpu").clone()
    out = fwd.search(params, al_pad, Zb, bp["K"], bp["d"], J0, bp["dV1"], bp["dV2"], alpha, budget_of(PARKING_B))
    return out, J0, (timer.search_counts("cpu") - before).tolist()


@pytest.mark.parametrize("budget", [0, 3])
def test_lane_with_budget_zero_runs_no_try(budget):
    """Every other lane gets `budget` tries (0: none searches): the lanes
    with budget 0 keep the search's starting values and add nothing to the
    counts, and the others are the search at full width's."""
    full, _, full_counts = _one_search(lambda B: torch.full((B,), 3, dtype=torch.int32))
    zero = torch.arange(PARKING_B) % 2 == 1
    out, J0, counts = _one_search(lambda B: torch.where(zero, 0, budget).to(torch.int32))
    assert torch.equal(out["tries"][zero], torch.zeros(int(zero.sum()), dtype=torch.int32))
    assert torch.equal(out["alpha"][zero], torch.full((int(zero.sum()),), 0.75, dtype=F64))
    assert torch.equal(out["J"][zero], J0[zero])
    assert bool((out["z"][zero] == -1).all()) and not bool(out["success"][zero].any())
    assert bool((out["status"][zero] == int(SolverStatus.UNSOLVED)).all())
    live = ~zero
    assert counts == [int(out["tries"][live].sum()), int(live.sum()) if budget else 0, _run(out["tries"])]
    if budget:
        assert int(out["tries"][live].max()) > 1  # some lane backtracked
        for key in ("tries", "alpha", "J", "z", "success", "status"):
            assert torch.equal(_bits(out[key][live]), _bits(full[key][live])), key
        assert torch.equal(_bits(out["Xn"][..., live]), _bits(full["Xn"][..., live]))
        assert full_counts[1] == PARKING_B

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`altro_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `altro_tpu_torch/csrc/`, then:
  1. checks each kernel against its plain PyTorch version at the main
     path's shapes (turn-90 parking problem, N=100, B=4096, warm random AL
     state) in float64 and float32, and times both;
  2. drives the main path — `CompactedALSolver` with the fused backward and
     forward kernels over a B=4096 perturbed parking fleet in float32 — and
     checks that both kernels ran, lane 0 and >= 99% of lanes SOLVED;
  3. checks parity: float32 control parity against the f64 reference solve
     at constraint tolerance 1e-6 (<= 1e-3), and the float64 kernels
     against the reference golden (14 total / 5 outer iterations,
     J = 0.03893465058924039).
Each phase prints one JSON line.  The last lines are the card's name and
power limit (nvidia-smi), the kernel summary, and
`{"ok": true, "device": {...}}`.  Without a CUDA device, or when any check
fails, it exits non-zero and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B_FLEET = 4096
N = 100
# the options of the timed program (bench.py:_BENCH_OPT_KW); scan_unroll
# has no effect in the port
BENCH_OPT_KW = dict(
    backward_pass="fused",
    forward_pass="cuda",
    scan_unroll=4,
    line_search_max_iterations=6,
    max_stall_iterations=3,
)
PHASE1_ITERS = 14
TAIL_BATCH = 1024
PARITY_BATCH = 1024
GOLDEN_J = 0.03893465058924039  # auglag_test.cpp:346-349 (tol 1e-6 solve)
# kernel-vs-plain bounds.  float64: algorithmic (the two differ only in
# rounding order): elementwise |Δ| <= 1e-10 + rtol·|plain| for gains, cost
# and ΔV; for the rolled-out trajectories, whose diverging lanes amplify
# rounding along the horizon, max |Δ| <= rtol · max(max |plain|, 1).
# float32: about 5-10x above what was observed on the card, relative to
# each output's largest magnitude (floored at 1).
F64_RTOL = dict(K=1e-9, d=1e-9, dV1=1e-8, dV2=1e-8, J0=1e-10, Xn=1e-10, Ubar=1e-10, J=1e-10)
F64_ATOL = 1e-10
F64_SCALED = ("Xn", "Ubar")
# observed on an H100 (700 W): K 5.9e-5, d 4.3e-5, dV1 9.4e-7, dV2 1.0e-6,
# J0 3.8e-7, Xn 3.8e-7, Ubar 4.0e-7, J 6.3e-7
F32_REL = dict(K=3e-4, d=3e-4, dV1=8e-6, dV2=8e-6, J0=2e-6, Xn=2e-6, Ubar=2e-6, J=5e-6)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _sync():
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn()` over `reps` calls, each timed with CUDA
    events after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def fleet_trajectory(defn, B):
    from altro_tpu_torch.solver.batched import BatchedTrajectory

    Z0 = defn.initial_trajectory()
    return BatchedTrajectory(
        X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
        U=Z0.U[..., None].expand(-1, -1, B).contiguous(),
        t=Z0.t, h=Z0.h,
    )


def compare(name, got, want, dtype, mask=None) -> dict:
    """Assert kernel output `got` against plain output `want`; returns the
    observed max abs and relative error."""
    import torch

    g, w = got.double(), want.double()
    if mask is not None:  # lanes the comparison covers (batch last)
        g, w = g[..., mask], w[..., mask]
    err = (g - w).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
    rel = max_abs / scale
    assert bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output"
    if dtype == torch.float64 and name in F64_SCALED:
        assert rel <= F64_RTOL[name], f"{name} f64: rel err {rel:.3e} > {F64_RTOL[name]}"
    elif dtype == torch.float64:
        ok = bool((err <= F64_ATOL + F64_RTOL[name] * w.abs()).all())
        assert ok, f"{name} f64: max abs err {max_abs:.3e} beyond rtol {F64_RTOL[name]}"
    else:
        assert rel <= F32_REL[name], f"{name} f32: rel err {rel:.3e} > {F32_REL[name]}"
    return dict(max_abs=max_abs, rel=rel)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version, N=100, B=4096, warm AL state
    (as perf/verify_kernels.py builds it)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
    from altro_tpu_torch.ops.forward import ForwardKernel
    from altro_tpu_torch.solver.batched import ALSolverBatched

    summary = {"backward_fused": {}, "forward": {}}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
        prob = defn.make_problem().compile()
        opts = SolverOptions()
        ev = ALSolverBatched(prob, opts)
        rng = np.random.default_rng(42)
        B = B_FLEET
        params = prob.params.replace(
            x0=torch.as_tensor(rng.uniform(-0.1, 0.1, (3, B)), device=dev).to(dtype)
        )
        Zb = ev.rollout(params, fleet_trajectory(defn, B))
        al = tuple(
            dict(
                lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape), device=dev).to(dtype),
                rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape), device=dev).to(dtype),
            )
            for st in ev.al_state_init(B, dtype)
        )
        bk = BackwardFusedKernel(prob, opts, dtype=dtype, device=dev)
        fk = ForwardKernel(prob, opts, dtype=dtype, device=dev)
        ap = bk.pad_al(al)
        errs_b, errs_f = {}, {}
        for r in (0.0, 0.37):
            rho = torch.full((B,), r, dtype=dtype, device=dev)
            out_k = bk(params, ap, Zb, rho)
            out_p = bk.plain(params, ap, Zb, rho)
            _sync()
            assert torch.equal(out_k[4], out_p[4]), "backward: failed flags differ"
            ok = ~out_p[4]
            case = {}
            for name, gk, gp in zip(("K", "d", "dV1", "dV2", "J0"), out_k[:4] + out_k[5:], out_p[:4] + out_p[5:]):
                case[name] = compare(name, gk, gp, dtype, mask=None if name == "J0" else ok)
            case["n_failed"] = int(out_p[4].sum())
            errs_b[f"rho={r}"] = case
            # the forward checks roll out the regularized gains: the ρ=0
            # gains of this random AL state make every lane's closed loop
            # unstable (|x| in the thousands), where rounding differences
            # grow without bound and no comparison is meaningful
            K, d = out_p[0], out_p[1]
        for alpha, cb, KK, dd in (
            (1.0, True, K, d), (0.5, True, K, d),
            (0.0, False, torch.zeros_like(K), torch.zeros_like(d)),
        ):
            a = torch.full((B,), alpha, dtype=dtype, device=dev)
            out_k = fk(params, ap, Zb, KK, dd, a, check_bounds=cb)
            out_p = fk.plain(params, ap, Zb, KK, dd, a, check_bounds=cb)
            _sync()
            assert torch.equal(out_k[3], out_p[3]), "forward: valid flags differ"
            assert torch.equal(out_k[4], out_p[4]), "forward: status differs"
            errs_f[f"alpha={alpha},guarded={cb}"] = {
                name: compare(name, gk, gp, dtype)
                for name, gk, gp in zip(("Xn", "Ubar", "J"), out_k[:3], out_p[:3])
            }
        rho0 = torch.zeros((B,), dtype=dtype, device=dev)
        a1 = torch.ones((B,), dtype=dtype, device=dev)
        times = dict(
            backward_ms=cuda_ms(lambda: bk(params, ap, Zb, rho0), 20),
            backward_plain_ms=cuda_ms(lambda: bk.plain(params, ap, Zb, rho0), 3),
            forward_ms=cuda_ms(lambda: fk(params, ap, Zb, K, d, a1), 20),
            forward_plain_ms=cuda_ms(lambda: fk.plain(params, ap, Zb, K, d, a1), 3),
        )
        emit({"phase": "kernel_vs_plain", "dtype": tag, "N": N, "B": B,
              "backward_fused": errs_b, "forward": errs_f, **times})
        summary["backward_fused"][tag] = dict(
            max_abs_err=max(c[k]["max_abs"] for c in errs_b.values() for k in ("K", "d")),
            ms=times["backward_ms"], plain_ms=times["backward_plain_ms"],
        )
        summary["forward"][tag] = dict(
            max_abs_err=max(c[k]["max_abs"] for c in errs_f.values() for k in ("Xn", "Ubar")),
            ms=times["forward_ms"], plain_ms=times["forward_plain_ms"],
        )
    return summary


def phase_main_path(dev) -> dict:
    """CompactedALSolver with the bench options over the B=4096 fleet, f32."""
    import torch

    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.solver.compaction import CompactedALSolver

    dtype = torch.float32
    defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
    prob = defn.make_problem().compile()
    solver = CompactedALSolver(
        prob, SolverOptions(**BENCH_OPT_KW), phase1_iters=PHASE1_ITERS, tail_batch=TAIL_BATCH
    )
    # bench.make_batch: x0 uniform in ±0.1 from default_rng(0), lane 0 canonical
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, size=(3, B_FLEET)), device=dev).to(dtype)
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=x0)
    Zb = fleet_trajectory(defn, B_FLEET)
    kernels = [solver._p1._bwd, solver._p1._fwd, solver._tail._bwd, solver._tail._fwd]
    assert all(k is not None for k in kernels), "the main path did not select the CUDA kernels"

    t0 = time.perf_counter()
    res = solver.solve(params, Zb)  # warm-up: builds nothing further, fills caches
    _sync()
    warm_s = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    walls, syncs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        _sync()
        walls.append(time.perf_counter() - t0)
        syncs.append(solver.host_syncs)
    launches = dict(
        backward_fused=solver._p1._bwd.launches + solver._tail._bwd.launches,
        forward=solver._p1._fwd.launches + solver._tail._fwd.launches,
    )
    status = res["status"].cpu().numpy()
    hist = {SolverStatus(int(c)).name: int((status == c).sum()) for c in sorted(set(status.tolist()))}
    it = res["stats"].iterations_total.cpu().numpy()
    solved = hist.get("SOLVED", 0)
    U, X = res["Z"].U, res["Z"].X
    wall = float(np.median(walls))
    out = dict(
        phase="main_path", B=B_FLEET, N=N, dtype="f32", status_hist=hist,
        solved_frac=solved / B_FLEET,
        iters_p50=float(np.percentile(it, 50)), iters_p99=float(np.percentile(it, 99)),
        iters_max=int(it.max()), host_syncs_per_solve=syncs, tail_rounds=solver.telemetry["tail_rounds"],
        warmup_s=warm_s, wall_s_reps=walls, wall_s_median=wall,
        solves_per_s=B_FLEET / wall, launches_5_solves=launches,
        lane0_cost=float(res["stats"].cost[0]),
    )
    emit(out)
    assert tuple(U.shape) == (N, 2, B_FLEET) and tuple(X.shape) == (N + 1, 3, B_FLEET)
    assert bool(torch.isfinite(U).all()) and bool(torch.isfinite(X).all()), "non-finite result"
    assert launches["backward_fused"] > 0 and launches["forward"] > 0, launches
    assert int(status[0]) == int(SolverStatus.SOLVED), "lane 0 not SOLVED"
    assert solved >= 0.99 * B_FLEET, f"only {solved}/{B_FLEET} SOLVED"
    return launches


def phase_parity(dev) -> None:
    """f32 control parity at ctol 1e-6 (bench.parity_solve's configuration)
    and the f64 golden through the kernels' double instantiation."""
    import torch

    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.solver.batched import ALSolverBatched

    g = np.load(os.path.join(ROOT, "tests", "goldens", "unicycle_turn90_refsolve_f64_tol6.npz"))
    # float32, shipped kernels, reference test tolerances
    defn = UnicycleProblem(dtype=torch.float32, device=dev, N=N)
    prob = defn.make_problem().compile()
    opts = SolverOptions(**BENCH_OPT_KW).replace(
        constraint_tolerance=1e-6, line_search_max_iterations=20, max_stall_iterations=0,
    )
    fb = ALSolverBatched(prob, opts)
    params = prob.params.replace(x0=torch.zeros((3, PARITY_BATCH), dtype=torch.float32, device=dev))
    Zb = fleet_trajectory(defn, PARITY_BATCH)
    t0 = time.perf_counter()
    res = fb.solve(params, Zb)
    _sync()
    wall = time.perf_counter() - t0
    U0 = res["Z"].U[..., 0].double().cpu().numpy()
    X0 = res["Z"].X[..., 0].double().cpu().numpy()
    control_parity = float(np.abs(U0 - g["U"]).max())
    f32 = dict(
        status=SolverStatus(int(res["status"][0])).name,
        iterations_total=int(res["stats"].iterations_total[0]),
        control_parity=control_parity, state_parity=float(np.abs(X0 - g["X"]).max()),
        cost_err_vs_f64=float(res["stats"].cost[0]) - float(g["cost"]), wall_s=wall,
        launches=dict(backward_fused=fb._bwd.launches, forward=fb._fwd.launches),
    )
    emit(dict(phase="parity_f32", B=PARITY_BATCH, **f32))
    assert control_parity <= 1e-3, f"control parity {control_parity:.3e} > 1e-3"
    assert fb._bwd.launches > 0 and fb._fwd.launches > 0

    # float64: the reference golden through the double kernels
    defn = UnicycleProblem(dtype=torch.float64, device=dev, N=N)
    prob = defn.make_problem().compile()
    fb = ALSolverBatched(
        prob, SolverOptions(constraint_tolerance=1e-6, backward_pass="fused", forward_pass="cuda")
    )
    B = 8
    params = prob.params.replace(x0=torch.zeros((3, B), dtype=torch.float64, device=dev))
    res = fb.solve(params, fleet_trajectory(defn, B))
    J = float(fb.total_cost(params, res["al"], res["Z"])[0])
    f64 = dict(
        status=SolverStatus(int(res["status"][0])).name,
        iterations_total=int(res["stats"].iterations_total[0]),
        iterations_outer=int(res["stats"].iterations_outer[0]),
        J=J, J_rel_err=abs(J - GOLDEN_J) / GOLDEN_J,
        launches=dict(backward_fused=fb._bwd.launches, forward=fb._fwd.launches),
    )
    emit(dict(phase="golden_f64", B=B, **f64))
    assert f64["status"] == "SOLVED" and f64["iterations_total"] == 14 and f64["iterations_outer"] == 5, f64
    assert f64["J_rel_err"] <= 1e-9, f64
    assert fb._bwd.launches > 0 and fb._fwd.launches > 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from altro_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the altro_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        card = smi.stdout.strip().splitlines()[0]
        t0 = time.perf_counter()
        lib = _build.load()
        load_s = time.perf_counter() - t0
        ptxas = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln]
        emit(dict(
            phase="env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
            device=torch.cuda.get_device_name(0), build_s=lib.build_seconds, load_s=load_s,
            ptxas=ptxas,
        ))
        kern = phase_kernels(dev)
        launches = phase_main_path(dev)
        phase_parity(dev)
    except Exception:  # noqa: BLE001 - report any failed phase and exit non-zero
        traceback.print_exc()
        return 1
    print(card)
    sources = dict(
        backward_fused=("altro_tpu_torch/csrc/backward_fused.cu",
                        "altro_tpu/ops/backward_fused_pallas.py:546"),
        forward=("altro_tpu_torch/csrc/forward.cu", "altro_tpu/ops/forward_pallas.py:699"),
    )
    emit({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             max_abs_err=kern[name]["f32"]["max_abs_err"], ms=kern[name]["f32"]["ms"],
             plain_ms=kern[name]["f32"]["plain_ms"])
        for name, (src, rep) in sources.items()
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

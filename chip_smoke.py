#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`altro_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `altro_tpu_torch/csrc/` (one nvcc per source,
in parallel), then:
  1. checks the fused backward and forward kernels against their plain
     PyTorch versions at the main path's shapes (turn-90 parking problem,
     N=100, B=4096, warm random AL state) in float64 and float32, and times
     both; then the forward kernel's search mode (each lane's whole line
     search in one launch) on the fused backward's gains and terms, with
     budgets 0 to 6 mixed within each block, against the lockstep search
     over the kernel's tries (bit for bit) and against its plain version,
     timed with a bound scaled by the lane tries its blocks ran;
  2. drives the main path, `bench.make_solver`'s program — `CompactedALSolver`
     with the fused backward and forward kernels and the float64 polish over
     a B=4096 perturbed parking fleet in float32 — after one instrumented
     solve with the iteration history on (statuses and U bit for bit with
     the production solve, iteration quantiles from its rows), and checks
     that both kernels ran, lane 0 and >= 99% of lanes SOLVED;
  3. checks parity: float32 control parity against the f64 reference solve
     at constraint tolerance 1e-6, through the fused kernels (<= 1e-3) and
     through the Riccati kernel, and the float64 kernels against the
     reference golden (14 total / 5 outer iterations,
     J = 0.03893465058924039);
  4. checks the Riccati kernel against its plain version on the parking
     expansions (N=100, B=4096 and B=1000), at the model zoo's shapes
     (quadrotor n=13 N=50, cartpole n=4 N=60, B=2048) and on the triple
     integrator's (n=6, N=10, B=2048), float64 and float32, and the
     associative-scan sweep (`solver/pscan_batched.py`) against the kernel
     on the B=4096 parking expansions at ρ=0, both timed;
  5. drives `backward_pass="pallas"` (the Riccati kernel over the eager
     expansions) through `CompactedALSolver` on the B=4096 parking fleet,
     and the float64 golden through the Riccati kernel;
  6. checks the fused kernels against their plain versions at the zoo's
     shapes;
  7. times each kernel instance in f32 against the batch width
     (kernel_scaling, B = 1024, 2048, 4096 and 16384): the fused kernels at
     parking, cartpole and quadrotor, with the forward kernel's chain alone
     beside them, and the Riccati kernel at its four instances;
  8. traces one solve of each parking path with torch.profiler: device
     time, busy share, the largest device events;
  9. drives the model zoo (perf/benchmark_zoo.py) through the fused
     kernels: quadrotor and cartpole fleets (B=2048);
 10. drives the three-obstacle fleet (perf/benchmark_obstacles.py, B=4096,
     f32) through the fused kernels' circle rows: the rows against the
     plain version bit for bit, both kernels against their plain versions
     at the obstacle problem's shapes, the fleet in both of the script's
     modes (f32_throughput, and complete with its restart cascade) and in
     f32_throughput mode with the float64 polish on the fused kernels'
     float64 instantiations (every polished lane ending as the JAX
     package's polish ends it, lanes SOLVED before the polish untouched bit
     for bit), every SOLVED lane clear of every obstacle;
 11. drives the randomized three-obstacle fleet (perf/benchmark_randomized.py,
     B=4096, f32_throughput: per-lane x0, obstacle layouts, goals and
     tracking costs) through the fused kernels' lane-params
     instantiations: both kernels against their plain versions at its
     shapes, per-lane leaves broadcast from the shared values bit for bit
     with the shared launch, a permutation of the lanes bit for bit, the
     cartpole's and the quadrotor's per-lane dynamics params against
     plain, and the fleet's solve in f32_throughput mode and in the
     script's complete mode (restart cascade, infeasibility certificates:
     none certified, >= 95% SOLVED), every SOLVED lane clear of its own
     obstacles and at its own goal; the certificates on the card flag
     exactly the lanes whose goal was moved into an obstacle;
 12. runs the main path with the speculative line search (S = 2 and 8:
     S step sizes in one forward launch at S·B lanes) against its S=1
     solve bit for bit, and the randomized fleet's first 1,024 lanes at
     S=4 against S=1 (capped at 30 iterations; the lane-params forward
     kernel at 4,096 lanes);
 13. checks the fused kernels' triple-integrator instantiations ((6, 2),
     N=10) against their plain versions (B = 2048, 1001, 1; f64, f32) and
     solves a B=2048 float64 fleet on them against the Riccati fallback;
 14. prints the main path's live fleet rows (verbose=OUTER): one host
     sync per row and nothing else changed;
 15. drives the 4,096-controller MPC fleet (perf/mpc_device_latency.py:
     fleet: `BatchedMPC` on the fused kernels, f32, at most 3 iterations
     a tick, 100 closed-loop ticks of `rollout_ticks`): both kernels
     launch on every tick, `rollout_ticks` equals `step` plus the plant
     bit for bit, the closed loop agrees with the JAX package's
     (tests/goldens/mpc_fleet_jax_f32.npz), and its first 256 lanes in
     f64, 30 ticks, lane for lane with the JAX package's
     (mpc_fleet_jax_f64.npz);
 16. splits the main path's fleet (B=4096, f32, bench options, fused
     kernels, `ALSolverBatched` with no compaction) over ranks
     (`altro_tpu_torch/parallel/mesh.py`): a world of one over NCCL in
     this process (on `make_mesh()` and on `make_mesh([0])`) and two gloo
     ranks sharing the card in processes of their own, each rank's lanes
     bit for bit with the unsharded solve's, its folds equal to the
     solve's and three one-element all_reduces its only collectives; `BatchedALSolver` bit for bit with the unsharded
     solve, and bench.make_solver's program with the host-driven tail
     (`device_tail=False`) bit for bit with its device program;
 17. solves the zoo's and the obstacle fleet's first 512 lanes on the
     plain path (on the host's CPU, one thread each), all in processes of
     their own at once, and holds steps 9
     and 10 against them; meanwhile, in this process, solves the problems
     no fused kernel takes (a second-order cone, two dynamics families,
     per-knot dynamics params; B=1024, f64) through the Riccati kernel
     and through the eager passes, and holds one against the other, and
     runs the per-instance solver and controllers on the card
     (`ALSolver`'s f64 golden, the same solve printing its rows,
     `ILQRSolver`'s goldens, `MPC` against `BatchedMPC`'s lane 0); the
     single controller's 100 ticks, held against the JAX package's, run
     in a process of their own beside the plain solves.
Each phase prints one JSON line.  `--phase NAME` (repeatable) runs only the
named phases after the build, for measuring, and then prints the card but
no kernel summary or result line.  With `--package-root DIR` those phases
run on the package of another checkout (a parent commit unpacked into
`_work/`), so that two versions are measured in one call;
`--phase fused_digest` (not part of the full run) hashes the fused
backward kernel's outputs and compares them with another run's (`--dump`,
`--against`).  The last lines are the card's name and
power limit (nvidia-smi), the kernel summary, and
`{"ok": true, "device": {...}}`.  Without a CUDA device, or when any check
fails, it exits non-zero and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
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
HISTORY_CAPACITY = 96  # bench.py's instrumented solve
PARITY_BATCH = 1024
ZOO_BATCH = 2048
ZOO_PLAIN_LANES = 512  # lanes are independent; the plain path solves these
ZOO_N = dict(quadrotor=50, cartpole=60)  # the zoo's horizons (perf/benchmark_zoo.py)
PLAIN_TIMEOUT_S = 700  # the plain solves run in their own processes (run_plain); none may take longer
# where the plain solves of the zoo and the obstacle fleet run: on the host's
# CPU, one thread a process.  They are lockstep loops of small eager ops and
# thousands of host reads; on the card the seven processes of the plain
# stage took 143-483 s beside each other, time-sharing the card with the
# single controller and this process (H100 700 W).  The plain path is the
# same code on either device, and the card is left to the work it times.
PLAIN_DEVICE = "cpu"
# the zoo's overrides of the bench options (perf/benchmark_zoo.py:108-111)
ZOO_OPT_KW = dict(
    initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10,
    outer_constraints_f64=True,
)
# the three-obstacle fleet (perf/benchmark_obstacles.py): its overrides of
# the bench options (:83-86), and the restart cascade of its complete mode
# (:63-71)
OBST_OPT_KW = dict(
    initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10,
    outer_constraints_f64=True,
)
OBST_RESTART = dict(
    restart_portfolio=(
        dict(),
        dict(penalty_scaling=4.0, max_iterations_outer=60, max_iterations_total=900),
        dict(penalty_scaling=1.5, max_iterations_outer=120, max_iterations_total=1100),
    ),
    restart_width=1024,
    restart_rounds=1,
)
OBST_RAGGED_B = 1001  # a width whose last block of 8 lanes is part-empty
# timed solves of each obstacle-fleet mode after its warm-up: 1, to keep the
# whole script well inside its time limit on a slower host (3 before the
# polish step came, 2 until the MPC controllers came; PERF.md)
OBST_REPS = 1
# the JAX package's float64 polish of every lane of the fleet, each stage
# from a fresh start (tests/_torch_polish_check.py writes it on the CPU)
OBST_POLISH_GOLDEN = os.path.join(ROOT, "tests", "goldens", "obstacle_fleet_polish_jax_f64.npz")
# the plain path's comparison: the first 512 lanes in f32_throughput mode,
# in 4 processes of 128 lanes.  On 512 lanes in one process on the card
# that solve took 440 s (177 lockstep iterations of eager ops, up to 20
# rollouts a line search; H100 700 W); the complete mode's cascade adds
# variants capped at 300, 900 and 1,100 iterations, more than this
# script's time limit.  A process's time is set by its slowest lane's
# lockstep iterations, each a few thousand small ops, more than by its lane
# count: 8 processes of 64 on the card beside the zoo's split into 4 (13
# processes on the host's 8 cores) finished no solve within PLAIN_TIMEOUT_S
# (H100 700 W; PERF.md section 6)
OBST_PLAIN_MODE = "f32_throughput"
OBST_PLAIN_LANES = 512
OBST_PLAIN_PROCS = 4
CLEARANCE_MIN = -1e-3  # metres (example_unicycle_test.cpp:76-83)
# the randomized three-obstacle fleet (perf/benchmark_randomized.py,
# f32_throughput mode: the obstacle fleet's solver and options, :138-145),
# per-lane leaves drawn from seed 0 (models.problems.randomized_fleet)
RAND_SEED = 0
# timed solves after one warm-up, median reported: 1, not the script's 5,
# to keep chip_smoke well inside its time limit (a solve takes 20-44 s on
# an H100's host, and the complete mode's one solve 69-90 s; PERF.md)
RAND_REPS = 1
RAND_SOLVED_MIN = 0.65  # the JAX package's record on this data: 2913/4096 (perf/benchmark_randomized.out)
RAND_DYN_SEED = 9  # the per-lane dynamics params' scales (part 2)
# the script's complete mode (perf/benchmark_randomized.py:110-137): the
# restart cascade of four variants, certificates with the unicycle's
# one-step travel v_max·h as the step bound, the total cap 120; its solver
# has no polish (:141)
RAND_COMPLETE = dict(
    restart_portfolio=(
        dict(),
        dict(penalty_scaling=4.0, max_iterations_outer=60, max_iterations_total=900),
        dict(penalty_scaling=2.0, max_iterations_outer=100, max_iterations_total=1000),
        dict(penalty_scaling=1.5, max_iterations_outer=150, max_iterations_total=1600),
    ),
    restart_width=1024,
    restart_rounds=1,
    detect_infeasible=True,
)
RAND_COMPLETE_MAX_TOTAL = 120
RAND_COMPLETE_SOLVED_MIN = 0.95  # JAX on a TPU on the same draws: 98.02% (perf/benchmark_randomized.out)
RAND_CERT_LANES = 16  # lanes whose goal the certificate check moves into an obstacle
SCALING_B = (1024, 2048, 4096, 16384)  # batch widths of the kernel_scaling phase
SCALING_REPS = 10
GOLDEN_J = 0.03893465058924039  # auglag_test.cpp:346-349 (tol 1e-6 solve)
# H100 SXM peaks (NVIDIA data sheet): memory, and non-tensor-core FP rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


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


def dev_us(e) -> float:
    """Device microseconds of a torch.profiler key_averages() entry."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def device_ms(fn, reps: int, kernel: str):
    """Mean device milliseconds per launch of the kernel whose name holds
    `kernel` over `reps` calls of `fn()`, traced by torch.profiler after one
    warm-up call: the kernel's own time.  CUDA events around `fn()`
    (cuda_ms) also count the host's work before the launch while the card
    waits, about 0.1 ms for these wrappers.  The trace may hold fewer
    launches than were made (an H100 trace once kept 3 of 10); the mean is
    over those it holds, None when it holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync()
    rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU and kernel in e.key]
    count = sum(e.count for e in rows)
    return sum(dev_us(e) for e in rows) / count / 1e3 if count else None


def fleet_trajectory(defn, B):
    return replicate(defn.initial_trajectory(), B)


def replicate(Z0, B):
    """A trajectory replicated over B lanes, batch last."""
    from altro_tpu_torch.solver.batched import BatchedTrajectory

    return BatchedTrajectory(
        X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
        U=Z0.U[..., None].expand(-1, -1, B).contiguous(),
        t=Z0.t, h=Z0.h,
    )


def warm_al(ev, B, dtype, dev, rng):
    """A random AL state: λ in [-0.5, 0], ρ in [1, 10] (as
    perf/verify_kernels.py draws it)."""
    import torch

    return tuple(
        dict(
            lam=torch.as_tensor(rng.uniform(-0.5, 0.0, st["lam"].shape), device=dev).to(dtype),
            rho=torch.as_tensor(rng.uniform(1.0, 10.0, st["rho"].shape), device=dev).to(dtype),
        )
        for st in ev.al_state_init(B, dtype)
    )


def bound(nbytes: float, flops: float, tag: str) -> tuple[float, str]:
    """(ms, what sets it): the least time the card could take to move
    `nbytes` and do `flops` in the scalar type `tag`."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[tag] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _mm_flops(i, j, k):
    return i * k * (2 * j - 1)


def riccati_step_flops(n, m) -> int:
    """Floating-point operations of one knot of the Riccati step
    (csrc/sweep_group.cuh:sweep_knot_group), per lane, each counted once
    (every thread of a lane's group repeats the m×m Cholesky)."""
    f = 2 * _mm_flops(n, n, n) + n * n  # AᵀP, AᵀP·A, + lxx
    f += 2 * _mm_flops(n, n, m) + n * m  # AᵀP·B, P·B, + lxu
    f += _mm_flops(m, n, m) + m * m  # Bᵀ(PB) + luu
    f += _mm_flops(n, n, 1) + n + _mm_flops(m, n, 1) + m  # Qx, Qu
    f += sum(3 + 2 * j + (m - 1 - j) * (2 * j + 1) for j in range(m))  # Cholesky of Quu + ρI
    f += 2 * m * m * (n + 1) + m * (n + 1)  # the solves for K and d, negated
    f += _mm_flops(n, m, m) + 3 * _mm_flops(n, m, 1) + 3 * n  # KᵀQuu, p update
    f += 2 * _mm_flops(n, m, n) + 3 * n * n  # Qxu·K, KᵀQuu·K, P update
    f += 2 * (2 * m - 1) + _mm_flops(m, m, 1) + 4  # ΔV1, ΔV2
    return f


def riccati_work(N, n, m, B, itemsize) -> tuple[float, float]:
    """(bytes, flops) of one Riccati sweep: per knot and lane it reads A, B,
    lxx, lxu, luu, lx, lu and writes K, d; P_N, p_N and ρ once, ΔV1, ΔV2 and
    the int32 flags once."""
    read = N * (2 * n * n + 2 * n * m + m * m + n + m) + n * n + n + 1
    write = N * (m * n + m) + 2
    return B * ((read + write) * itemsize + 4), float(N * B * riccati_step_flops(n, m))


def model_ops(kern) -> tuple[int, int]:
    """(operations of one f, of one tangent of f at a point whose value is
    known) of the kernel's model, as csrc/models.cuh counts them (read from
    the built library)."""
    from altro_tpu_torch.ops import _build

    return _build.load().model_ops()[kern.model_name]


def step_ops(kern) -> tuple[int, int]:
    """(model evaluations, operations per state entry) of one step of the
    kernel's integrator, for its value or for one tangent alike: RK4's four
    stages (x + h/2·k, acc + 2k, ..., x + h·(acc + k)/6: 14 operations per
    entry, h/2 and h/6 once a step), or Euler's x + h·k."""
    return (4, 14) if kern.method == 0 else (1, 2)


# operations of one circle row (csrc/fused_common.cuh:al_family): dx and
# dy (2), the compensated row (csrc/lane_algebra.cuh:comp_circle, 53), its
# AL value (6; 8 with the weights w, hw) and, in the backward kernel, its
# gradient and Gauss-Newton terms (18)
CIRCLE_ROW_OPS = dict(forward=2 + 53 + 6, backward=2 + 53 + 8 + 18)


def al_ops(kern, per_row: int, circle_row: int) -> int:
    """Operations of one knot's stage constraint rows: `per_row` for each
    goal or control-bound row, `circle_row` for each circle row."""
    return sum(f["p"] * (circle_row if f["structure"][0] == "circle" else per_row)
               for f in kern._con_fams if f["stage_row"] >= 0)


def lane_words(kern, params) -> int:
    """Words per lane of the lane table that a launch with `params` reads
    (ops/backward_fused.py:LaneLayout): N+1 knots' per-knot rows and the
    static rows; 0 when every param is shared."""
    if params is None or not kern.param_sig(params):
        return 0
    lay = kern._lane_layout(kern.param_sig(params))
    return (kern.N + 1) * lay.knot_rows + lay.static_rows


def fused_work(kern, B, itemsize, params=None) -> tuple[float, float]:
    """(bytes, flops) of one fused backward launch: per lane it reads X, U,
    the packed AL state and ρ and writes K, d, ΔV1, ΔV2, J0 and the flags;
    per knot the quadratic cost's value and gradient, its Hessian from the
    cost rows, the AL rows (al_ops), the step's value once (the model's evaluations,
    csrc/models.cuh's kFOps, and the step's own arithmetic), the n+m
    columns of [A Bd] as tangents of the step at that value (kTangentOps
    per evaluation, and the step's arithmetic again), and one Riccati
    step.  With per-lane `params`, each lane reads its lane table too
    (lane_words)."""
    N, n, m = kern.N, kern.n, kern.m
    Ps, Fs, Pt, Ft = kern.Ps, kern.Fs, kern.Pt, kern.Ft
    f, tangent = model_ops(kern)
    evals, per_entry = step_ops(kern)
    read = (N + 1) * n + N * m + N * (Ps + Fs) + Pt + Ft + 1 + lane_words(kern, params)
    write = N * (m * n + m) + 3
    quad = 2 * _mm_flops(n, n, 1) + 2 * _mm_flops(n, m, 1) + 2 * _mm_flops(m, m, 1) + 6 * (n + m)
    hess = n * n + n * m + m * m
    al = al_ops(kern, 8, CIRCLE_ROW_OPS["backward"])
    value = evals * f + per_entry * n
    tangents = (n + m) * (evals * tangent + per_entry * n)
    per_knot = quad + hess + al + value + tangents + riccati_step_flops(n, m)
    return B * ((read + write) * itemsize + 4), float(N * B * per_knot)


def forward_work(kern, B, itemsize, params=None) -> tuple[float, float]:
    """(bytes, flops) of one forward launch: per lane it reads x0, α, X, U,
    K, d and the packed AL state and writes X̄, Ū, J and two int32 flags;
    per knot the feedback law, the step (the model's evaluations,
    csrc/models.cuh's kFOps, and the step's own arithmetic), the cost and AL
    value (al_ops) and the guard.  With per-lane `params`, each lane reads
    its lane table too (lane_words)."""
    N, n, m = kern.N, kern.n, kern.m
    Ps, Fs, Pt, Ft = kern.Ps, kern.Fs, kern.Pt, kern.Ft
    f = model_ops(kern)[0]
    evals, per_entry = step_ops(kern)
    read = (n + 1 + (N + 1) * n + N * m + N * (m * n + m) + N * (Ps + Fs) + Pt + Ft
            + lane_words(kern, params))
    write = N * (n + m) + 1
    per_knot = (_mm_flops(m, n, 1) + n + 3 * m + evals * f + per_entry * n
                + 2 * (n * n + n * m + m * m) + 4 * (n + m) + al_ops(kern, 6, CIRCLE_ROW_OPS["forward"])
                + 2 * (n + m))
    return B * ((read + write) * itemsize + 8), float(N * B * per_knot)


def compare(name, got, want, dtype, mask=None, f32_rel=None, sens=None) -> dict:
    """Assert kernel output `got` against plain output `want`
    (altro_tpu_torch/ops/tolerances.py); returns the observed max abs and
    relative error.  `f32_rel` overrides F32_REL; `sens` [lanes] widens a
    float64 lane's bound by SENS_FACTOR times its sensitivity."""
    import torch

    from altro_tpu_torch.ops import tolerances as tol

    g, w = got.double(), want.double()
    if mask is not None:  # lanes the comparison covers (batch last)
        g, w = g[..., mask], w[..., mask]
    err = (g - w).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
    rel = max_abs / scale
    assert bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output"
    if dtype == torch.float64 and name in tol.F64_SCALED:
        assert rel <= tol.F64_RTOL[name], f"{name} f64: rel err {rel:.3e} > {tol.F64_RTOL[name]}"
    elif dtype == torch.float64:
        bound = tol.F64_ATOL + tol.F64_RTOL[name] * w.abs()
        if sens is not None:
            bound = bound + tol.SENS_FACTOR * sens.double() * (1.0 + w.abs())
        ok = bool((err <= bound).all())
        assert ok, f"{name} f64: max abs err {max_abs:.3e} beyond rtol {tol.F64_RTOL[name]}"
    else:
        bound = (f32_rel or tol.F32_REL)[name]
        assert rel <= bound, f"{name} f32: rel err {rel:.3e} > {bound}"
    return dict(max_abs=max_abs, rel=rel)


def witness(sens, flips, held) -> dict:
    """The sensitivity reported beside a case."""
    s = sens[held].cpu().numpy()
    return dict(
        edge_lanes=int(flips.sum()),
        sensitivity_p50=float(np.median(s)) if s.size else None,
        sensitivity_max=float(s.max()) if s.size else None,
    )


def f32_vs_f64(name, got, want, truth, mask) -> dict:
    """A float32 output `got` of the kernel and `want` of its plain version,
    both against the float64 plain output `truth` of the same inputs, on
    the lanes `mask`: the kernel's error relative to max(|truth|, 1) stays
    within F32_VS_F64_RATIO times the plain version's."""
    from altro_tpu_torch.ops import tolerances as tol

    t = truth.double()[..., mask]
    scale = max(float(t.abs().max()) if t.numel() else 0.0, 1.0)
    ek = float((got.double()[..., mask] - t).abs().max()) / scale if t.numel() else 0.0
    ep = float((want.double()[..., mask] - t).abs().max()) / scale if t.numel() else 0.0
    assert ek <= tol.F32_VS_F64_RATIO * ep + 1e-7, f"{name} f32 vs f64: kernel {ek:.3e}, plain {ep:.3e}"
    return dict(kernel=ek, plain=ep, max_abs_truth=float(t.abs().max()) if t.numel() else 0.0)


def search_vs_lockstep_and_plain(fk, ev, params, ap, Zb, bw, dtype) -> dict:
    """The forward kernel's search mode (`ForwardKernel.search`, each
    lane's whole line search in one launch) from α = 1 with per-lane
    budgets 0 to the main path's 6 tries, mixed within every block of 8
    lanes so that its lanes stop at different tries (0 also for lanes
    whose backward pass failed), on the gains,
    J0, ΔV1 and ΔV2 of the fused backward `bw`, held
      1. against the lockstep search over the kernel's single tries (the
         rounds of `solver/batched.py:search_round`): tries, success, α,
         J, z and status equal, and X̄, Ū bit for bit on every lane that
         tried;
      2. against its plain version (`plain_search`: the same rounds over
         eager tries): tries, success, α and status equal on every lane,
         but where the two searches part because a try's kernel and eager
         values straddle one of the search's tests (valid, a bound of z,
         J < J0), which the two tries at the parting α show; J, X̄, Ū to
         the forward kernel's tolerances and z beside them (reported) on
         the lanes that did not part.
    Returns the counts, the largest differences and the launch's ms (CUDA
    events), device ms (torch.profiler) and bound, the last scaled by the
    lane tries the launch's blocks ran."""
    import torch

    from altro_tpu_torch.solver.batched import search_round
    from altro_tpu_torch.utils.timer import search_counts

    o = fk.opts
    B = Zb.X.shape[-1]
    dev = Zb.X.device
    K, d, dV1, dV2, failed, J0 = bw
    budget = (torch.arange(B, device=dev) * 5 % (o.line_search_max_iterations + 1)).to(torch.int32)
    budget = torch.where(failed, 0, budget).to(torch.int32)
    a1 = torch.ones((B,), dtype=dtype, device=dev)
    search = lambda: fk.search(params, ap, Zb, K, d, J0, dV1, dV2, a1, budget)  # noqa: E731
    before = search_counts(dev).clone()
    got = search()
    tries, lanes, run = (search_counts(dev) - before).tolist()
    x0 = params.x0.to(dtype)

    def try_at(alpha, plain=False):
        out = (fk.plain if plain else fk)(params, ap, Zb, K, d, alpha, check_bounds=o.check_forwardpass_bounds)
        return Zb.replace(X=torch.cat([x0[None], out[0]], dim=0), U=out[1]), out[3], out[4], out[2]

    c = dict(ev._search_init(Zb, J0), alpha=a1)
    while True:
        active = (~c["success"]) & (c["it"] < budget)
        if not bool(active.any()):
            break
        c = search_round(o, c, active, J0, dV1, dV2, *try_at(c["alpha"]))
    tried = got["tries"] > 0
    same = {key: bitwise([got[key]], [c[want]]) for key, want in (
        ("tries", "it"), ("success", "success"), ("alpha", "alpha"), ("J", "J"), ("z", "z"), ("status", "status"))}
    same["Xn"] = bitwise([got["Xn"][..., tried]], [c["Zbar"].X[1:, :, tried]])
    same["Ubar"] = bitwise([got["Ubar"][..., tried]], [c["Zbar"].U[..., tried]])
    assert all(same.values()), f"search against the lockstep search over the kernel: {same}"

    p = fk.plain_search(params, ap, Zb, K, d, J0, dV1, dV2, a1, budget)
    parted = (got["tries"] != p["tries"]) | (got["success"] != p["success"])
    straddle = []
    if bool(parted.any()):
        # both sides try α, α/f, ... rounded alike: they part at the first
        # try at which one stops
        t0 = torch.minimum(got["tries"], p["tries"])
        alpha = a1.clone()
        for _ in range(int(t0.max()) - 1):
            alpha = torch.where(t0 > 1, alpha / o.line_search_decrease_factor, alpha)
            t0 = t0 - 1
        tests = []
        for plain in (False, True):
            _, valid, _, Jt = try_at(alpha, plain)
            expected = -alpha * (dV1 + alpha * dV2)
            z = torch.where(expected > 0.0, (J0 - Jt) / expected, -torch.ones_like(J0))
            tests.append((valid, z, Jt))
        (vk, zk, Jk), (vp, zp, Jp) = tests
        lo, hi = o.line_search_lower_bound, o.line_search_upper_bound
        sides = ((vk != vp) | ((zk - lo) * (zp - lo) <= 0) | ((zk - hi) * (zp - hi) <= 0)
                 | ((Jk - J0) * (Jp - J0) <= 0))
        straddle = sides[parted]
        assert bool(straddle.all()), f"{int((~straddle).sum())} lanes part with no test between their tries"
    keep = ~parted
    for key in ("tries", "success", "alpha", "status"):
        assert torch.equal(got[key][keep], p[key][keep]), f"search against its plain version: {key} differs"
    live = keep & tried
    errs = {name: compare(name, g, w, dtype, mask=live)
            for name, g, w in (("J", got["J"], p["J"]), ("Xn", got["Xn"], p["Xn"]), ("Ubar", got["Ubar"], p["Ubar"]))}
    errs["z"] = dict(max_abs=float((got["z"][live] - p["z"][live]).abs().max()) if bool(live.any()) else 0.0)
    item = torch.finfo(dtype).bits // 8
    nbytes, flops = forward_work(fk, B, item)
    tag = "f64" if dtype == torch.float64 else "f32"
    bound_ms, bound_by = bound(nbytes * run / B, flops * run / B, tag)
    return dict(lanes=B, searched=int(lanes), tries=int(tries), lane_tries_run=int(run),
                tries_hist={int(t): int((got["tries"] == t).sum()) for t in range(o.line_search_max_iterations + 1)},
                success=int(got["success"].sum()), lockstep_bitwise=same, lanes_parted=int(parted.sum()),
                vs_plain=errs, ms=cuda_ms(search, 20), device_ms=device_ms(search, 20, "forward_kernel"),
                plain_ms=cuda_ms(lambda: fk.plain_search(params, ap, Zb, K, d, J0, dV1, dV2, a1, budget), 3),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version, N=100, B=4096, warm AL state
    (as perf/verify_kernels.py builds it)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
    from altro_tpu_torch.ops.forward import ForwardKernel
    from altro_tpu_torch.solver.batched import ALSolverBatched

    summary = {"backward_fused": {}, "forward": {}, "search": {}}
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
        al = warm_al(ev, B, dtype, dev, rng)
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
            bw = out_k
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
            backward_device_ms=device_ms(lambda: bk(params, ap, Zb, rho0), 20, "backward_fused_kernel"),
            backward_plain_ms=cuda_ms(lambda: bk.plain(params, ap, Zb, rho0), 3),
            forward_ms=cuda_ms(lambda: fk(params, ap, Zb, K, d, a1), 20),
            forward_device_ms=device_ms(lambda: fk(params, ap, Zb, K, d, a1), 20, "forward_kernel"),
            forward_plain_ms=cuda_ms(lambda: fk.plain(params, ap, Zb, K, d, a1), 3),
        )
        emit({"phase": "kernel_vs_plain", "dtype": tag, "N": N, "B": B,
              "backward_fused": errs_b, "forward": errs_f, **times})
        fks = ForwardKernel(prob, SolverOptions(line_search_max_iterations=BENCH_OPT_KW["line_search_max_iterations"]),
                            dtype=dtype, device=dev)
        summary["search"][tag] = search_vs_lockstep_and_plain(fks, ev, params, ap, Zb, bw, dtype)
        emit({"phase": "search_vs_plain", "dtype": tag, "N": N, **summary["search"][tag]})
        item = torch.finfo(dtype).bits // 8
        summary["backward_fused"][tag] = dict(
            max_abs_err=max(c[k]["max_abs"] for c in errs_b.values() for k in ("K", "d")),
            ms=times["backward_ms"], device_ms=times["backward_device_ms"],
            plain_ms=times["backward_plain_ms"], work=fused_work(bk, B, item),
        )
        summary["forward"][tag] = dict(
            max_abs_err=max(c[k]["max_abs"] for c in errs_f.values() for k in ("Xn", "Ubar")),
            ms=times["forward_ms"], device_ms=times["forward_device_ms"],
            plain_ms=times["forward_plain_ms"], work=forward_work(fk, B, item),
        )
    return summary


def bench_solver(prob, **opt_kw):
    """bench.make_solver's program on the port: `CompactedALSolver` with
    the bench options (and `opt_kw` over them), phase 1 capped at
    PHASE1_ITERS, tail rounds of TAIL_BATCH lanes and the float64 polish
    (`bench.py:100-129`), with its tail as the device program
    (`device_tail=True`, as `bench.make_solver` sets); `device_tail=False`
    in `opt_kw` runs the host-driven tail rounds instead."""
    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.solver.compaction import CompactedALSolver

    device_tail = opt_kw.pop("device_tail", True)
    opts = SolverOptions(**BENCH_OPT_KW).replace(**opt_kw)
    return CompactedALSolver(prob, opts, phase1_iters=PHASE1_ITERS, tail_batch=TAIL_BATCH, f64_polish=True,
                             device_tail=device_tail)


def polish_kernels(solver) -> list:
    """The float64 kernels of a CompactedALSolver's polish stages."""
    return [k for s in solver._polish for k in (s._bwd, s._fwd)]


def polish_launches(solver) -> dict:
    """Each fused kernel's launches in a CompactedALSolver's polish stages."""
    return dict(backward_fused=sum(s._bwd.launches for s in solver._polish),
                forward=sum(s._fwd.launches for s in solver._polish))


def phase_main_path(dev) -> dict:
    """bench.py's program over the B=4096 parking fleet, f32
    (`bench.py:main`): first one instrumented solve with the iteration
    history on (HISTORY_CAPACITY rows), then the production solve as the
    warm-up, whose statuses and U the instrumented solve must equal bit for
    bit (`bench.py:241-251`, U added here), then 5 timed solves with every
    kernel's count set to 0 before them.  The iteration quantiles come from
    the history rows, each lane's count of valid rows equal to its
    iterations (capped at the capacity).  The float64 polish is on, as in
    bench.make_solver; its lanes and kernel launches are reported (the
    parking fleet solves 4096/4096 before it, PERF.md)."""
    import torch

    from altro_tpu_torch import SolverStatus

    _, prob, params, Zb = _main_fleet(dev)
    solver = bench_solver(prob)
    instrumented = bench_solver(prob, iteration_history_capacity=HISTORY_CAPACITY)
    kernels = [solver._p1._bwd, solver._p1._fwd, solver._tail._bwd, solver._tail._fwd]
    assert all(k is not None for k in kernels), "the main path did not select the CUDA kernels"
    polish = polish_kernels(solver)
    assert all(k is not None and k.dtype == torch.float64 for k in polish), "the polish has no float64 kernels"

    t0 = time.perf_counter()
    res_hist = instrumented.solve(params, Zb)
    _sync()
    hist_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve(params, Zb)  # warm-up: builds nothing further, fills caches
    _sync()
    warm_s = time.perf_counter() - t0
    # a solver's first solve also reads the params' shared leaves for its
    # kernels' preparation (`sync.kernel_prep`), which a later solve of the
    # same params object does not: the history solve is held to this one
    first_syncs = solver.host_syncs
    same_status = bool(torch.equal(res_hist["status"], res["status"]))
    same_U = bitwise([res_hist["Z"].U], [res["Z"].U])
    rows = res_hist["stats"].rows  # [HISTORY_CAPACITY, 8, B]
    valid = (rows != 0).any(dim=1).sum(dim=0)
    rows_ok = bool(torch.equal(valid, res_hist["stats"].iterations_total.clamp(max=HISTORY_CAPACITY).long()))
    it_rows = valid.cpu().numpy()
    for k in kernels + polish:
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
        polish=polish_launches(solver),
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
        polish=solver.telemetry.get("polish"),
        first_solve_host_syncs=first_syncs,
        history=dict(capacity=HISTORY_CAPACITY, wall_s=hist_s, host_syncs=instrumented.host_syncs,
                     statuses_equal=same_status, U_bitwise=same_U, rows_equal_iterations=rows_ok,
                     iters_p50=float(np.percentile(it_rows, 50)), iters_p95=float(np.percentile(it_rows, 95)),
                     iters_p99=float(np.percentile(it_rows, 99))),
        warmup_s=warm_s, wall_s_reps=walls, wall_s_median=wall,
        solves_per_s=B_FLEET / wall, launches_5_solves=launches,
        lane0_cost=float(res["stats"].cost[0]),
    )
    emit(out)
    assert tuple(U.shape) == (N, 2, B_FLEET) and tuple(X.shape) == (N + 1, 3, B_FLEET)
    assert bool(torch.isfinite(U).all()) and bool(torch.isfinite(X).all()), "non-finite result"
    assert launches["backward_fused"] > 0 and launches["forward"] > 0, launches
    assert same_status and same_U, "the instrumented solve diverged from the production solve"
    assert rows_ok, "a lane's history rows differ from its iteration count"
    assert instrumented.host_syncs == first_syncs, "the history added host syncs"
    assert int(status[0]) == int(SolverStatus.SOLVED), "lane 0 not SOLVED"
    assert solved >= 0.99 * B_FLEET, f"only {solved}/{B_FLEET} SOLVED"
    _MAIN_REF.update(res=res, wall_s=wall, host_syncs=syncs[-1], first_host_syncs=first_syncs,
                     forward_launches=launches["forward"] / 5)
    return launches


def phase_parity(dev) -> None:
    """f32 control parity at ctol 1e-6 (bench.parity_solve's configuration)
    through the fused kernels and through the Riccati kernel, and the f64
    golden through the fused kernels' double instantiation.

    Lane 0 starts at the canonical x0 = 0; the other lanes at x0 moved by at
    most PARITY_SPREAD, which shows the spread of the float32 solve under
    rounding-sized changes of its input.  Limits (ops/tolerances.py): lane 0
    within 1e-3 on the fused path, within RICCATI_PARITY_LIMIT on the
    Riccati path; the median over the lanes within 1e-3 on both."""
    import torch

    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.ops.tolerances import PARITY_SPREAD, RICCATI_PARITY_LIMIT
    from altro_tpu_torch.solver.batched import ALSolverBatched

    g = np.load(os.path.join(ROOT, "tests", "goldens", "unicycle_turn90_refsolve_f64_tol6.npz"))
    # float32, shipped kernels, reference test tolerances
    defn = UnicycleProblem(dtype=torch.float32, device=dev, N=N)
    prob = defn.make_problem().compile()
    x0 = np.random.default_rng(0).uniform(-PARITY_SPREAD, PARITY_SPREAD, (3, PARITY_BATCH))
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=torch.as_tensor(x0, device=dev).float())
    Zb = fleet_trajectory(defn, PARITY_BATCH)
    for path, backward, lane0_limit in (("fused", "fused", 1e-3), ("riccati", "pallas", RICCATI_PARITY_LIMIT)):
        opts = SolverOptions(**BENCH_OPT_KW).replace(
            backward_pass=backward, constraint_tolerance=1e-6, line_search_max_iterations=20,
            max_stall_iterations=0,
        )
        fb = ALSolverBatched(prob, opts)
        kerns = dict(backward_fused=fb._bwd, riccati=fb._ric, forward=fb._fwd)
        t0 = time.perf_counter()
        res = fb.solve(params, Zb)
        _sync()
        wall = time.perf_counter() - t0
        U = res["Z"].U.double().cpu().numpy()
        parity = np.abs(U - g["U"][..., None]).max(axis=(0, 1))
        status = res["status"].cpu().numpy()
        X0 = res["Z"].X[..., 0].double().cpu().numpy()
        control_parity = float(parity[0])
        f32 = dict(
            status=SolverStatus(int(status[0])).name,
            iterations_total=int(res["stats"].iterations_total[0]),
            control_parity=control_parity, state_parity=float(np.abs(X0 - g["X"]).max()),
            cost_err_vs_f64=float(res["stats"].cost[0]) - float(g["cost"]), wall_s=wall,
            spread=PARITY_SPREAD, parity_quantiles=dict(zip(
                ("min", "p10", "p50", "p90", "max"),
                (float(np.quantile(parity, q)) for q in (0.0, 0.1, 0.5, 0.9, 1.0)))),
            solved_frac=float((status == int(SolverStatus.SOLVED)).mean()),
            launches={name: k.launches for name, k in kerns.items() if k is not None},
        )
        emit(dict(phase="parity_f32", path=path, B=PARITY_BATCH, **f32))
        assert control_parity <= lane0_limit, f"{path}: control parity {control_parity:.3e} > {lane0_limit}"
        assert f32["parity_quantiles"]["p50"] <= 1e-3, (path, f32["parity_quantiles"])
        assert all(n > 0 for n in f32["launches"].values()) and len(f32["launches"]) == 2, f32["launches"]

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


def zoo_x0s(x0, B, rng):
    """The zoo's fleet (perf/benchmark_zoo.py:116-119): x0 spread by 0.05
    standard normal draws from `rng`, float64, on x0's device."""
    import torch

    spread = 0.05 * rng.standard_normal((x0.shape[0], B))
    return torch.as_tensor(x0.double().cpu().numpy()[:, None] + spread, device=x0.device)


def riccati_inputs(prob, Z0, x0s, dtype, dev, rng):
    """Eager expansions of a fleet (x0s [n, B]) rolled out from Z0, under a
    warm random AL state."""
    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.solver.batched import ALSolverBatched

    ev = ALSolverBatched(prob, SolverOptions())
    B = x0s.shape[-1]
    params = prob.params.replace(x0=x0s)
    Zb = ev.rollout(params, replicate(Z0, B))
    return ev.expand(params, warm_al(ev, B, dtype, dev, rng), Zb)


def riccati_check(kern, exp, dtype, name, rng) -> dict:
    """The Riccati kernel against its plain version at each of the
    problem's ρ (tolerances.RHOS), and with luu poisoned negative definite
    at knot 3 (ρ=0), which must fail every lane.  Beside each case, the
    plain version on inputs moved by one ulp gives every lane's sensitivity
    (the witness of ill-conditioning); flags must be equal on every lane
    whose flag does not flip under that move, and K, d, ΔV are compared on
    those lanes that did not fail.  In float32 K and d are also held, with
    the plain float32 sweep, against the float64 plain sweep."""
    import torch

    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.riccati import riccati_plain
    from altro_tpu_torch.ops.tolerances import sensitivity, ulp_moved

    tag = "f64" if dtype == torch.float64 else "f32"
    dev = exp["A"].device
    B, m = exp["A"].shape[-1], exp["B"].shape[2]
    keys = ("A", "B", "lxx", "lxu", "luu", "lx", "lu")
    poisoned = dict(exp, luu=exp["luu"].clone())
    poisoned["luu"][3] = -torch.eye(m, dtype=dtype, device=dev)[:, :, None]
    cases = [(f"rho={r}", exp, r) for r in tol.RHOS[tag][name]] + [("poisoned", poisoned, 0.0)]
    f32_rel = tol.RICCATI_F32_REL[name]
    out = {}
    for case, e, r in cases:
        rho = torch.full((B,), r, dtype=dtype, device=dev)
        got = kern(e, rho)
        want = kern.plain(e, rho)
        moved = [kern.plain({k: ulp_moved(e[k], rng) if k in keys else e[k] for k in e}, rho)
                 for _ in range(tol.SENS_DRAWS)]
        _sync()
        sens, flips = sensitivity(want, moved)
        steady = ~flips
        assert torch.equal(got[4][steady], want[4][steady]), f"riccati {case}: failed flags differ"
        if case == "poisoned":
            assert bool(want[4].all()), "riccati: the poisoned luu did not fail every lane"
        ok = ~want[4] & steady
        res = {
            key: compare(key, g, w, dtype, mask=ok, f32_rel=f32_rel, sens=sens[ok])
            for key, g, w in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4])
        }
        res.update(n_failed=int(want[4].sum()), **witness(sens, flips, ok),
                   max_abs_K=float(want[0][..., ok].abs().max()) if bool(ok.any()) else None)
        if dtype == torch.float32 and bool(ok.any()):
            truth = riccati_plain({k: e[k].double() for k in keys}, rho.double(), kern.gain_limit)
            both = ok & ~truth[4]
            res["vs_f64"] = {key: f32_vs_f64(key, got[i], want[i], truth[i], both)
                             for i, key in enumerate(("K", "d"))}
        out[case] = res
    return out


def riccati_fleet(name, B, dtype, dev, rng):
    """(problem, Z0, x0s [n, B]) of one Riccati-kernel instance at B lanes,
    x0s drawn from `rng`: parking (3,2) N=100 (x0 in ±0.1), the zoo's
    cartpole (4,1) N=60 and quadrotor (13,4) N=50 (x0 spread 0.05), or the
    triple integrator (6,2) at its own N=10 with its control bounds and
    goal (x0 spread 0.05; the model without a device functor, which takes
    the fused path's fallback).  `riccati_inputs` gives the expansions."""
    import torch

    from altro_tpu_torch.models.problems import (
        TripleIntegratorProblem, UnicycleProblem, zoo_cartpole, zoo_quadrotor,
    )

    if name == "parking":
        defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
        prob, Z0 = defn.make_problem().compile(), defn.initial_trajectory()
        return prob, Z0, torch.as_tensor(rng.uniform(-0.1, 0.1, (3, B)), device=dev).to(dtype)
    if name == "triple":
        defn = TripleIntegratorProblem(dtype=dtype, device=dev)
        prob, Z0 = defn.make_problem(add_constraints=True).compile(), defn.initial_trajectory()
        return prob, Z0, zoo_x0s(torch.as_tensor(defn.x0, device=dev), B, rng).to(dtype)
    prob, Z0, x0, _ = (zoo_quadrotor if name == "quadrotor" else zoo_cartpole)(dtype=dtype, device=dev)
    return prob, Z0, zoo_x0s(x0, B, rng).to(dtype)


def pscan_vs_kernel(kern, exp, dtype) -> dict:
    """The associative-scan sweep `riccati_pscan_batched` (plain tensor
    code, as the JAX package's is plain jax.numpy) against the Riccati
    kernel through its function form `riccati_cuda`, at ρ=0 on the same
    expansions: the failure flags, and the largest |Δ| of K, d, dV1 and
    dV2 over the lanes that did not fail relative to max(max |kernel|, 1)
    (tolerances.PSCAN_REL).  The sweep and `kern`, a `RiccatiKernel` built
    once as the other rows time it, each timed with cuda_ms, median of 5."""
    import torch

    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.riccati import riccati_cuda
    from altro_tpu_torch.solver.pscan_batched import riccati_pscan_batched

    tag = "f64" if dtype == torch.float64 else "f32"
    rho = torch.zeros((exp["A"].shape[-1],), dtype=dtype, device=exp["A"].device)
    got = riccati_pscan_batched(exp, rho)
    want = riccati_cuda(exp, rho)
    _sync()
    ok = ~want[4]
    rel = {}
    for key, g, w in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4]):
        g, w = g[..., ok].double(), w[..., ok].double()
        rel[key] = float((g - w).abs().max() / w.abs().max().clamp(min=1.0)) if bool(ok.any()) else 0.0
    return dict(flags_equal=bool(torch.equal(got[4], want[4])), n_failed=int(want[4].sum()), rel_err=rel,
                limit=tol.PSCAN_REL[tag], ms=cuda_ms(lambda: riccati_pscan_batched(exp, rho), 5),
                kernel_ms=cuda_ms(lambda: kern(exp, rho), 5))


def phase_riccati_vs_plain(dev) -> dict:
    """The Riccati kernel against its plain version: parking expansions
    (N=100, B=4096 and B=1000, as phase_kernels builds them), the zoo's
    quadrotor (N=50) and cartpole (N=60) and the triple integrator (N=10)
    at B=2048; f64 and f32.  At the parking B=4096 expansions, also the
    associative-scan sweep against the kernel (`pscan_vs_kernel`)."""
    import torch

    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.riccati import RiccatiKernel

    summary = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        item = torch.finfo(dtype).bits // 8
        setups = []
        for B in (B_FLEET, 1000):
            rng = np.random.default_rng(42)
            setups.append(("parking", *riccati_fleet("parking", B, dtype, dev, rng), rng))
        rng = np.random.default_rng(0)  # the B=2048 fleets' x0 first, then their AL states
        for name in ("quadrotor", "cartpole", "triple"):
            setups.append((name, *riccati_fleet(name, ZOO_BATCH, dtype, dev, rng), rng))
        for name, prob, Z0, x0s, rng_s in setups:
            exp = riccati_inputs(prob, Z0, x0s, dtype, dev, rng_s)
            Nk, n, m, B = prob.N, prob.n, prob.m, x0s.shape[-1]
            kern = RiccatiKernel(n, m, dtype=dtype)
            errs = riccati_check(kern, exp, dtype, name, rng_s)
            rho = torch.full((B,), tol.RHOS[tag][name][-1], dtype=dtype, device=dev)
            ms = cuda_ms(lambda: kern(exp, rho), 20)
            dms = device_ms(lambda: kern(exp, rho), 20, "riccati_kernel")
            plain_ms = cuda_ms(lambda: kern.plain(exp, rho), 3)
            work = riccati_work(Nk, n, m, B, item)
            bound_ms, bound_by = bound(*work, tag)
            geo = kern.geometry(B)
            pscan = pscan_vs_kernel(kern, exp, dtype) if (name, B) == ("parking", B_FLEET) else None
            emit({"phase": "riccati_vs_plain", "problem": name, "dtype": tag, "n": n, "m": m,
                  "N": Nk, "B": B, "cases": errs, "timed_rho": float(rho[0]), "ms": ms,
                  "device_ms": dms, "plain_ms": plain_ms, "bytes": work[0], "flops": work[1],
                  "bound_ms": bound_ms, "bound_by": bound_by, "blocks": geo.blocks,
                  "threads": geo.threads, "knots": geo.knots, "smem": geo.smem, "pscan": pscan})
            if pscan is not None:
                assert pscan["flags_equal"], f"pscan {tag}: failure flags differ from the kernel's"
                assert all(v <= pscan["limit"][k] for k, v in pscan["rel_err"].items()), f"pscan {tag}: {pscan}"
            if (name, B) == ("parking", B_FLEET):
                summary[tag] = dict(
                    max_abs_err=max(c[k]["max_abs"] for c in errs.values() for k in ("K", "d")),
                    ms=ms, device_ms=dms, plain_ms=plain_ms, work=work,
                )
    return summary


def _launches(kerns) -> int:
    return sum(k.launches for k in kerns if k is not None)


def phase_riccati_path(dev) -> dict:
    """`backward_pass="pallas"` (the JAX name of the Riccati kernel) through
    CompactedALSolver with the bench options, on the main path's B=4096
    parking fleet in f32: eager expansions, the Riccati kernel in the retry
    loop, the forward kernel in the line search."""
    import torch

    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.solver.compaction import CompactedALSolver

    dtype = torch.float32
    defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
    prob = defn.make_problem().compile()
    opts = SolverOptions(**BENCH_OPT_KW).replace(backward_pass="pallas")
    solver = CompactedALSolver(prob, opts, phase1_iters=PHASE1_ITERS, tail_batch=TAIL_BATCH, device_tail=True)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, size=(3, B_FLEET)), device=dev).to(dtype)
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=x0)
    Zb = fleet_trajectory(defn, B_FLEET)
    sub = (solver._p1, solver._tail)
    assert all(s._ric is not None and s._bwd is None for s in sub), "the Riccati kernel was not selected"
    t0 = time.perf_counter()
    res = solver.solve(params, Zb)
    _sync()
    warm_s = time.perf_counter() - t0
    kerns = dict(
        riccati=[s._ric for s in sub], forward=[s._fwd for s in sub], backward_fused=[s._bwd for s in sub],
    )
    for ks in kerns.values():
        for k in ks:
            if k is not None:
                k.launches = 0
    walls, syncs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        _sync()
        walls.append(time.perf_counter() - t0)
        syncs.append(solver.host_syncs)
    launches = {name: _launches(ks) for name, ks in kerns.items()}
    status = res["status"].cpu().numpy()
    hist = {SolverStatus(int(c)).name: int((status == c).sum()) for c in sorted(set(status.tolist()))}
    it = res["stats"].iterations_total.cpu().numpy()
    solved = hist.get("SOLVED", 0)
    wall = float(np.median(walls))
    emit(dict(
        phase="riccati_path", B=B_FLEET, N=N, dtype="f32", backward_pass=opts.backward_pass,
        status_hist=hist, solved_frac=solved / B_FLEET,
        iters_p50=float(np.percentile(it, 50)), iters_p99=float(np.percentile(it, 99)),
        iters_max=int(it.max()), host_syncs_per_solve=syncs, tail_rounds=solver.telemetry["tail_rounds"],
        warmup_s=warm_s, wall_s_reps=walls, wall_s_median=wall, solves_per_s=B_FLEET / wall,
        launches_3_solves=launches,
    ))
    U, X = res["Z"].U, res["Z"].X
    assert bool(torch.isfinite(U).all()) and bool(torch.isfinite(X).all()), "non-finite result"
    assert launches["riccati"] > 0 and launches["forward"] > 0, launches
    assert launches["backward_fused"] == 0, launches
    assert int(status[0]) == int(SolverStatus.SOLVED), "lane 0 not SOLVED"
    assert solved >= 0.99 * B_FLEET, f"only {solved}/{B_FLEET} SOLVED"
    return launches


def phase_golden_f64_riccati(dev) -> None:
    """The float64 reference golden through the Riccati kernel (B=8, ctol
    1e-6): SOLVED, 14 total / 5 outer iterations, J within 1e-9."""
    import torch

    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.solver.batched import ALSolverBatched

    defn = UnicycleProblem(dtype=torch.float64, device=dev, N=N)
    prob = defn.make_problem().compile()
    fb = ALSolverBatched(
        prob, SolverOptions(constraint_tolerance=1e-6, backward_pass="pallas", forward_pass="cuda")
    )
    assert fb._ric is not None and fb._bwd is None
    B = 8
    params = prob.params.replace(x0=torch.zeros((3, B), dtype=torch.float64, device=dev))
    res = fb.solve(params, fleet_trajectory(defn, B))
    J = float(fb.total_cost(params, res["al"], res["Z"])[0])
    out = dict(
        status=SolverStatus(int(res["status"][0])).name,
        iterations_total=int(res["stats"].iterations_total[0]),
        iterations_outer=int(res["stats"].iterations_outer[0]),
        J=J, J_rel_err=abs(J - GOLDEN_J) / GOLDEN_J,
        launches=dict(riccati=fb._ric.launches, forward=fb._fwd.launches),
    )
    emit(dict(phase="golden_f64_riccati", B=B, **out))
    assert out["status"] == "SOLVED" and out["iterations_total"] == 14 and out["iterations_outer"] == 5, out
    assert out["J_rel_err"] <= 1e-9, out
    assert fb._ric.launches > 0 and fb._fwd.launches > 0


def zoo_solver(name, path, dev):
    """The zoo's solver (perf/benchmark_zoo.py:108-112): `ALSolverBatched`
    with the bench options and the zoo's overrides, f32; `path` "kernels"
    keeps `backward_pass="fused"` and `forward_pass="cuda"`, "plain" runs
    the eager passes.  Returns (solver, problem, Z0, xf)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import zoo_cartpole, zoo_quadrotor
    from altro_tpu_torch.solver.batched import ALSolverBatched

    prob, Z0, _, xf = (zoo_quadrotor if name == "quadrotor" else zoo_cartpole)(dtype=torch.float32, device=dev)
    opts = SolverOptions(**BENCH_OPT_KW).replace(**ZOO_OPT_KW)
    if path == "plain":
        opts = opts.replace(backward_pass="scan", forward_pass="scan")
    return ALSolverBatched(prob, opts), prob, Z0, xf


def zoo_outcome(s, params, res, xf, lanes) -> dict:
    """Statuses, iterations, raw trajectory cost of the first `lanes` lanes
    (zero AL state) and terminal errors of a zoo solve, on the host."""
    import torch

    Z = res["Z"]
    first = Z.replace(X=Z.X[..., :lanes].contiguous(), U=Z.U[..., :lanes].contiguous())
    params_l = params.replace(x0=params.x0[:, :lanes].contiguous())
    J = s.total_cost(params_l, s.al_state_init(lanes, torch.float32), first)
    return dict(
        finite=bool(torch.isfinite(Z.X).all() and torch.isfinite(Z.U).all()),
        status=res["status"].cpu().numpy(), iterations=res["stats"].iterations_total.cpu().numpy(),
        J=J.double().cpu().numpy(),
        terminal_err=(Z.X[-1].double() - xf.double()[:, None]).abs().amax(dim=0).cpu().numpy(),
    )


def zoo_plain_solve(name: str, x0s: np.ndarray, lanes: int) -> dict:
    """The plain path's zoo solve on PLAIN_DEVICE (run in its own process
    by run_plain): zoo_outcome's dict, the wall time and the kernels'
    launches."""
    import torch

    s, prob, Z0, xf = zoo_solver(name, "plain", torch.device(PLAIN_DEVICE))
    params = prob.params.replace(x0=torch.as_tensor(x0s, device=prob.params.x0.device).float())
    t0 = time.perf_counter()
    res = s.solve(params, replicate(Z0, x0s.shape[1]))
    wall = time.perf_counter() - t0  # its last host read ended the solve
    launches = sum(k.launches for k in (s._bwd, s._fwd, s._ric) if k is not None)
    return dict(name=name, wall_s=wall, host_syncs=s.host_syncs, launches=launches,
                **zoo_outcome(s, params, res, xf, lanes))


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when the process that started it
    ends, however it ends (Linux prctl PR_SET_PDEATHSIG), so that no plain
    solve outlives this script."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # 1: PR_SET_PDEATHSIG
    if os.getppid() != parent:  # it ended before the call above
        os._exit(1)


def _plain_worker(key, fn, args, out, parent) -> None:
    """One plain solve in a spawned process: sends (key, fn(*args) with
    ok=True) on the pipe `out`, or (key, the traceback with ok=False)."""
    _die_with_parent(parent)
    try:
        sys.path.insert(0, ROOT)
        import torch

        torch.set_num_threads(1)  # several of these share the host's cores
        r = dict(ok=True, **fn(*args))
    except Exception:  # noqa: BLE001 - the parent reports it and fails the phase
        r = dict(ok=False, error=traceback.format_exc())
    try:
        out.send((key, r))
    except BrokenPipeError:  # the parent stopped listening: it has failed already
        pass
    out.close()


def _stop_resource_tracker() -> None:
    """End multiprocessing's resource-tracker process, which the spawn
    start method starts and which would otherwise outlive this script by
    the moment it takes to see the script's end.  It holds nothing here:
    the plain solves talk through pipes, which it does not track."""
    from multiprocessing import resource_tracker

    rt = resource_tracker._resource_tracker
    with rt._lock:
        if rt._fd is not None and rt._pid is not None:
            os.close(rt._fd)  # its end of file ends its loop
            os.waitpid(rt._pid, 0)
            rt._fd = rt._pid = None


def run_plain(parts, during=None) -> dict:
    """Run the plain-path solves of every part together, each in its own
    spawned process (they are independent, host-bound, and together the
    slowest stage of the run), then each part's check on its results.
    A part is (name, jobs, check): jobs a list of (key, fn, args), check a
    function of {key: result} whose return value this returns under the
    part's name.  `during()`, if given, runs in this process once the
    others have started.  A failed solve, or none within PLAIN_TIMEOUT_S,
    fails the run.  However this ends, every process it started has ended
    when it returns or raises."""
    import multiprocessing as mp
    from multiprocessing.connection import wait

    ctx = mp.get_context("spawn")
    jobs = [job for _, part_jobs, _ in parts for job in part_jobs]
    procs, readers, heard = [], [], False
    t0 = time.perf_counter()
    try:
        for key, fn, args in jobs:
            r, w = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_plain_worker, args=(key, fn, args, w, os.getpid()))
            p.start()
            w.close()  # the child's end: a child that dies unheard reads as EOF here
            procs.append(p)
            readers.append(r)
        if during is not None:
            during()
        results, waiting = {}, list(readers)
        while waiting:
            left = PLAIN_TIMEOUT_S - (time.perf_counter() - t0)
            ready = wait(waiting, timeout=max(1.0, left))
            assert ready, f"no plain solve ended within {PLAIN_TIMEOUT_S} s: {len(waiting)} left"
            for r in ready:
                waiting.remove(r)
                try:
                    key, res = r.recv()
                except EOFError:
                    raise AssertionError("a plain solve's process died without a result") from None
                assert res["ok"], f"plain solve {key}:\n{res['error']}"
                results[key] = res
        heard = True
    finally:
        for r in readers:
            r.close()
        for p in procs:
            if not heard:  # failed or interrupted: the solves still running are of no use
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        _stop_resource_tracker()
    wall = time.perf_counter() - t0
    return {name: check({key: results[key] for key, _, _ in jobs}, wall) for name, jobs, check in parts}


def phase_fused_zoo_vs_plain(dev) -> None:
    """The fused backward and forward kernels against their plain versions
    at the zoo's shapes (quadrotor n=13 N=50, cartpole n=4 N=60, B=2048),
    from the rollout of the zoo's fleet under a warm random AL state, f64
    and f32.  The backward kernel is held at each of tolerances.RHOS, with
    the sensitivity witness of riccati_check (X and U moved by one ulp); the
    forward kernel rolls out the plain gains of the largest ρ."""
    import torch

    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(0)
        for name in ("quadrotor", "cartpole"):
            zoo_kernels_vs_plain(dev, name, dtype, rng)


def zoo_kernels_vs_plain(dev, name, dtype, rng, lane_key=None, B=ZOO_BATCH, device_times=False) -> dict:
    """phase_fused_zoo_vs_plain's checks of one zoo problem ("quadrotor",
    "cartpole", or "triple": TripleIntegratorProblem at dof 2, N=10, with
    its control bounds and goal) in one scalar type at B lanes, drawing from
    `rng`.  With `lane_key`, that dynamics param is per lane (each lane's
    scaled by U(0.8, 1.2), RAND_DYN_SEED), so the kernels' lane-params
    instantiations run (the randomized phase's part 2).  `device_times`
    adds each kernel's device ms (torch.profiler).  Emits the line and
    returns it."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import TripleIntegratorProblem, zoo_cartpole, zoo_quadrotor
    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
    from altro_tpu_torch.ops.forward import ForwardKernel
    from altro_tpu_torch.ops.tolerances import sensitivity, ulp_moved
    from altro_tpu_torch.solver.batched import ALSolverBatched

    tag = "f64" if dtype == torch.float64 else "f32"
    item = torch.finfo(dtype).bits // 8
    if name == "triple":
        defn = TripleIntegratorProblem(dtype=dtype, device=dev)
        prob, Z0, x0 = defn.make_problem(add_constraints=True).compile(), defn.initial_trajectory(), defn._t(defn.x0)
    else:
        build = zoo_quadrotor if name == "quadrotor" else zoo_cartpole
        prob, Z0, x0, _ = build(dtype=dtype, device=dev)
    opts = SolverOptions()
    ev = ALSolverBatched(prob, opts)
    params = prob.params.replace(x0=zoo_x0s(x0, B, rng).to(dtype))
    if lane_key is not None:
        leaf = params.dynamics[0][lane_key]
        scale = np.random.default_rng(RAND_DYN_SEED).uniform(0.8, 1.2, tuple(leaf.shape) + (B,))
        lane = leaf[..., None] * torch.as_tensor(scale, device=dev).to(dtype)
        params = params.replace(dynamics=(dict(params.dynamics[0], **{lane_key: lane}),))
    Zb = ev.rollout(params, replicate(Z0, B))
    al = warm_al(ev, B, dtype, dev, rng)
    bk = BackwardFusedKernel(prob, opts, dtype=dtype, device=dev)
    fk = ForwardKernel(prob, opts, dtype=dtype, device=dev)
    ap = bk.pad_al(al)
    Zms = [Zb.replace(X=ulp_moved(Zb.X, rng), U=ulp_moved(Zb.U, rng)) for _ in range(tol.SENS_DRAWS)]
    f32_rel = tol.ZOO_F32_REL[name]
    errs_b, errs_f = {}, {}
    for r in tol.RHOS[tag][name]:
        rho = torch.full((B,), r, dtype=dtype, device=dev)
        got = bk(params, ap, Zb, rho)
        want = bk.plain(params, ap, Zb, rho)
        moved = [bk.plain(params, ap, Zm, rho) for Zm in Zms]
        _sync()
        sens, flips = sensitivity(want, moved)
        steady = ~flips
        assert torch.equal(got[4][steady], want[4][steady]), f"{name} backward rho={r}: flags differ"
        ok = ~want[4] & steady
        case = {
            key: compare(key, g, w, dtype, mask=ok, f32_rel=f32_rel, sens=sens[ok])
            for key, g, w in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4])
        }
        case["J0"] = compare("J0", got[5], want[5], dtype, f32_rel=f32_rel)
        case.update(n_failed=int(want[4].sum()), **witness(sens, flips, ok),
                    max_abs_K=float(want[0][..., ok].abs().max()) if bool(ok.any()) else None)
        errs_b[f"rho={r}"] = case
        K, d = want[0], want[1]
    for alpha, cb, KK, dd in (
        (1.0, True, K, d), (0.5, True, K, d),
        (0.0, False, torch.zeros_like(K), torch.zeros_like(d)),
    ):
        a = torch.full((B,), alpha, dtype=dtype, device=dev)
        got = fk(params, ap, Zb, KK, dd, a, check_bounds=cb)
        want = fk.plain(params, ap, Zb, KK, dd, a, check_bounds=cb)
        _sync()
        assert torch.equal(got[3], want[3]), f"{name} forward: valid flags differ"
        assert torch.equal(got[4], want[4]), f"{name} forward: status differs"
        errs_f[f"alpha={alpha},guarded={cb}"] = {
            key: compare(key, g, w, dtype, f32_rel=f32_rel)
            for key, g, w in zip(("Xn", "Ubar", "J"), got[:3], want[:3])
        }
    rho = torch.full((B,), tol.RHOS[tag][name][-1], dtype=dtype, device=dev)
    a1 = torch.ones((B,), dtype=dtype, device=dev)
    times = dict(
        backward_ms=cuda_ms(lambda: bk(params, ap, Zb, rho), 10),
        backward_plain_ms=cuda_ms(lambda: bk.plain(params, ap, Zb, rho), 3),
        forward_ms=cuda_ms(lambda: fk(params, ap, Zb, K, d, a1), 10),
        forward_plain_ms=cuda_ms(lambda: fk.plain(params, ap, Zb, K, d, a1), 3),
    )
    if device_times:
        times.update(
            backward_device_ms=device_ms(lambda: bk(params, ap, Zb, rho), 20, "backward_fused_kernel"),
            forward_device_ms=device_ms(lambda: fk(params, ap, Zb, K, d, a1), 20, "forward_kernel"),
        )
    wb, wf = fused_work(bk, B, item, params), forward_work(fk, B, item, params)
    phase = "fused_zoo_vs_plain" if lane_key is None else "randomized_dynamics_vs_plain"
    line = {"phase": "triple_integrator_vs_plain" if name == "triple" else phase,
            "problem": name, "dtype": tag, "n": prob.n, "m": prob.m, "N": prob.N, "B": B,
            "backward_fused": errs_b, "forward": errs_f, **times,
            "backward_bound": bound(*wb, tag), "forward_bound": bound(*wf, tag)}
    if lane_key is not None:
        line["per_lane"] = sorted(bk.param_sig(params))
        assert len(line["per_lane"]) == 1, line["per_lane"]
    emit(line)
    return line


def zoo_part(dev):
    """The model zoo (perf/benchmark_zoo.py) through the fused kernels, as
    the JAX package runs it: quadrotor and cartpole fleets of ZOO_BATCH
    lanes, x0 spread 0.05 from seed 0, f32, bench options with the zoo's
    overrides.  Three timed solves of each on the kernels, with the
    kernels' counts set to 0 before them and read after.  Held to
    benchmark_zoo's contract against the plain path (eager passes, on the
    first ZOO_PLAIN_LANES lanes on PLAIN_DEVICE, one process per model, run
    by run_plain after the kernel solves so that they do not share the
    host with them):
    SOLVED rate within 2 points, median relative cost difference on
    jointly solved lanes < 2e-2, all results finite.  Returns run_plain's
    part, whose check returns each kernel's launches per solve, per
    model."""
    import torch

    from altro_tpu_torch import SolverStatus

    rng = np.random.default_rng(0)
    names = ("quadrotor", "cartpole")
    x0s, kern = {}, {}
    for name in names:
        s, prob, Z0, xf = zoo_solver(name, "kernels", dev)
        assert s._bwd is not None and s._fwd is not None, f"{name}: the fused kernels refused the model"
        assert s._ric is None, f"{name}: the Riccati kernel was selected"
        x0s[name] = zoo_x0s(prob.params.x0, ZOO_BATCH, rng).cpu().numpy()
        params = prob.params.replace(x0=torch.as_tensor(x0s[name], device=dev).float())
        s._bwd.launches = s._fwd.launches = 0
        walls, syncs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            res = s.solve(params, replicate(Z0, ZOO_BATCH))
            _sync()
            walls.append(time.perf_counter() - t0)
            syncs.append(s.host_syncs)
        kern[name] = dict(
            wall_s_reps=walls, wall_s=float(np.median(walls)), host_syncs=syncs,
            launches=dict(backward_fused=s._bwd.launches / 3, forward=s._fwd.launches / 3),
            **zoo_outcome(s, params, res, xf, ZOO_PLAIN_LANES),
        )
    jobs = [(name, zoo_plain_solve, (name, x0s[name][:, :ZOO_PLAIN_LANES], ZOO_PLAIN_LANES)) for name in names]

    def check(plain, plain_wall):
        solved = int(SolverStatus.SOLVED)
        launches = {}
        for name in names:
            rk, rs = kern[name], plain[name]
            L = ZOO_PLAIN_LANES
            st_all, st_s = rk["status"], rs["status"]
            st_k = st_all[:L]
            rate_k, rate_s = float((st_k == solved).mean()), float((st_s == solved).mean())
            both = (st_k == solved) & (st_s == solved)
            relj = np.abs(rk["J"] - rs["J"])[both] / np.maximum(np.abs(rs["J"])[both], 1e-9)
            it = rk["iterations"]
            emit(dict(
                phase="zoo", problem=name, N=ZOO_N[name], B=ZOO_BATCH, dtype="f32",
                launches_per_solve=rk["launches"], wall_s_reps=rk["wall_s_reps"], wall_s=rk["wall_s"],
                solves_per_s=ZOO_BATCH / rk["wall_s"], host_syncs=rk["host_syncs"],
                iters_p50=float(np.percentile(it, 50)), iters_p99=float(np.percentile(it, 99)),
                iters_max=int(it.max()), solved_frac_all=float((st_all == solved).mean()),
                status_hist={SolverStatus(int(c)).name: int((st_all == c).sum()) for c in sorted(set(st_all.tolist()))},
                median_terminal_err=float(np.median(rk["terminal_err"])),
                plain_lanes=L, plain_device=PLAIN_DEVICE, plain_wall_s=rs["wall_s"], plain_launches=rs["launches"],
                plain_phase_wall_s=plain_wall, solved_rate_kernel=rate_k, solved_rate_plain=rate_s,
                status_agreement=float((st_k == st_s).mean()), jointly_solved=int(both.sum()),
                cost_rel_diff_p50=float(np.median(relj)) if both.any() else None,
                cost_rel_diff_p99=float(np.percentile(relj, 99)) if both.any() else None,
            ))
            assert rk["finite"] and rs["finite"], f"{name}: non-finite result"
            assert min(rk["launches"].values()) > 0, (name, rk["launches"])
            assert rs["launches"] == 0, f"{name}: the plain path launched a kernel"
            assert abs(rate_k - rate_s) <= 0.02, (name, rate_k, rate_s)
            assert both.any() and float(np.median(relj)) < 2e-2, (name, float(np.median(relj)) if both.any() else None)
            launches[name] = rk["launches"]
        return launches

    return "zoo", jobs, check


def phase_zoo(dev) -> dict:
    """zoo_part and its plain solves."""
    return run_plain([zoo_part(dev)])["zoo"]


def obstacle_solver(mode, path, dev, **solver_kw):
    """perf/benchmark_obstacles.py's solver in `mode` ("f32_throughput" or
    "complete"): `CompactedALSolver(phase1_iters=PHASE1_ITERS,
    tail_batch=TAIL_BATCH)` on the bench options with the script's
    overrides, f32, and in complete mode its restart cascade; `path`
    "kernels" keeps both fused kernels, "plain" runs the eager passes;
    `solver_kw` (f64_polish) goes to the solver as well.
    Returns (solver, problem definition, compiled problem)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import THREE_OBSTACLES, UnicycleProblem
    from altro_tpu_torch.solver.compaction import CompactedALSolver

    defn = UnicycleProblem(scenario=THREE_OBSTACLES, dtype=torch.float32, device=dev, N=N)
    prob = defn.make_problem().compile()
    opts = SolverOptions(**BENCH_OPT_KW).replace(**OBST_OPT_KW)
    if path == "plain":
        opts = opts.replace(backward_pass="scan", forward_pass="scan")
    kw = dict(OBST_RESTART if mode == "complete" else {}, **solver_kw)
    solver = CompactedALSolver(prob, opts, phase1_iters=PHASE1_ITERS, tail_batch=TAIL_BATCH, device_tail=True,
                               **kw)
    return solver, defn, prob


def obstacle_kernels(solver) -> dict:
    """The fused kernels of a CompactedALSolver's solvers (phase 1, tail,
    restarts), by name; None where a solver runs the eager pass."""
    subs = [s for s in (solver._p1, solver._tail, solver._restart) if s is not None]
    return dict(backward_fused=[s._bwd for s in subs], forward=[s._fwd for s in subs],
                riccati=[s._ric for s in subs])


def obstacle_x0s(B) -> np.ndarray:
    """bench.make_batch's fleet: x0 uniform in ±0.1 from default_rng(0),
    lane 0 the canonical x0 = 0."""
    x0 = np.random.default_rng(0).uniform(-0.1, 0.1, size=(3, B))
    x0[:, 0] = 0.0
    return x0


def clearance(X, obstacles) -> np.ndarray:
    """Per lane, the least distance from the position (X [N+1, n, B]) to an
    obstacle's edge over every knot, metres, in f64.  `obstacles`: (cx, cy,
    r), each [n_obs] (every lane's) or [n_obs, B] (each lane its own)."""
    Xd = X.double()
    out = None
    for cx, cy, r in zip(*(torch_f64(a, Xd.device) for a in obstacles)):
        d = ((Xd[:, 0] - cx) ** 2 + (Xd[:, 1] - cy) ** 2).sqrt().amin(dim=0) - r
        out = d if out is None else out.minimum(d)
    return out.cpu().numpy()


def torch_f64(a, device):
    import torch

    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def obstacle_outcome(solver, defn, params, res, lanes) -> dict:
    """zoo_outcome of an obstacle solve's first `lanes` lanes, with every
    lane's clearance."""
    import torch

    xf = torch.as_tensor(defn.xf, device=res["Z"].X.device)
    out = zoo_outcome(solver._p1, params, res, xf, lanes)
    out["clearance"] = clearance(res["Z"].X, defn.obstacles)
    return out


def obstacle_plain_solve(mode: str, x0s: np.ndarray) -> dict:
    """The plain path's solve in `mode` of the obstacle fleet's lanes x0s
    [3, lanes] on PLAIN_DEVICE (run in its own process by run_plain): obstacle_outcome's
    dict, the wall time, host syncs, the kernels' launches and the
    solver's telemetry."""
    import torch

    s, defn, prob = obstacle_solver(mode, "plain", torch.device(PLAIN_DEVICE))
    params = prob.params.replace(x0=torch.as_tensor(x0s, device=prob.params.x0.device).float())
    t0 = time.perf_counter()
    res = s.solve(params, fleet_trajectory(defn, x0s.shape[1]))
    wall = time.perf_counter() - t0  # its last host read ended the solve
    launches = sum(_launches(ks) for ks in obstacle_kernels(s).values())
    return dict(wall_s=wall, host_syncs=s.host_syncs, launches=launches, telemetry=s.telemetry,
                **obstacle_outcome(s, defn, params, res, x0s.shape[1]))


def field_case(dtype, B, dev, rng):
    """The obstacle problem (N=100) at an expansion point where the circle
    rows are penalized: positions spread over the obstacle field, headings
    and controls uniform, x0 beside the first obstacle, and a warm random
    AL state (warm_al).  Returns (problem, params, Z, al, the share of
    circle rows with λ − ρc <= 0)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import THREE_OBSTACLES, UnicycleProblem
    from altro_tpu_torch.solver.batched import ALSolverBatched

    defn = UnicycleProblem(scenario=THREE_OBSTACLES, dtype=dtype, device=dev, N=N)
    prob = defn.make_problem().compile()
    t = lambda a: torch.as_tensor(a, device=dev).to(dtype)  # noqa: E731
    X = np.concatenate([rng.uniform(0.3, 2.7, (N + 1, 2, B)), rng.uniform(-np.pi, np.pi, (N + 1, 1, B))], axis=1)
    U = np.stack([rng.uniform(0.0, 1.5, (N, B)), rng.uniform(-1.0, 1.0, (N, B))], axis=1)
    x0 = np.concatenate([rng.uniform(0.3, 1.2, (2, B)), rng.uniform(-np.pi, np.pi, (1, B))])
    Z0 = defn.initial_trajectory()
    Z = replicate(Z0, B).replace(X=t(X).contiguous(), U=t(U).contiguous())
    ev = ALSolverBatched(prob, SolverOptions(), compensated_circles=True)
    al = warm_al(ev, B, dtype, dev, rng)
    fam = [i for i, f in enumerate(prob.constraint_families) if f.constraint.structure[0] == "circle"][0]
    c = ev.constraint_values(prob.params, Z)[fam]
    s = al[fam]["lam"] - al[fam]["rho"][:, None, :] * c
    return prob, prob.params.replace(x0=t(x0)), Z, al, float((s <= 0).double().mean())


def obstacle_kernels_vs_plain(dev) -> dict:
    """Steps 1-2 of phase_obstacles; returns the f32 summary of each kernel
    at B=B_FLEET (max error, times, work)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel, circle_rows_on_card, comp_circle
    from altro_tpu_torch.ops.forward import ForwardKernel

    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.float64):
        r = rng.uniform(0.2, 1.0, 1 << 16)
        phi = rng.uniform(0, 2 * np.pi, r.size)
        rad = np.concatenate([r[: r.size // 2] * (1 + rng.uniform(-1e-3, 1e-3, r.size // 2)),
                              rng.uniform(0.0, 3.0, r.size - r.size // 2)])
        dx, dy, rr = (torch.as_tensor(a, device=dev).to(dtype) for a in (rad * np.cos(phi), rad * np.sin(phi), r))
        got, want = circle_rows_on_card(dx, dy, rr), comp_circle(dx, dy, rr)
        _sync()
        same = bool((got.view(torch.uint8) == want.view(torch.uint8)).all())
        emit(dict(phase="obstacles_circle_rows", dtype=str(dtype).removeprefix("torch."), rows=r.size,
                  bitwise_equal=same, max_abs_diff=float((got - want).abs().max())))
        assert same, "the kernels' circle rows differ from comp_circle's"

    summary = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        item = torch.finfo(dtype).bits // 8
        for B in (B_FLEET, OBST_RAGGED_B):
            prob, params, Zb, al, active = field_case(dtype, B, dev, rng)
            opts = SolverOptions()
            bk = BackwardFusedKernel(prob, opts, dtype=dtype, device=dev)
            fk = ForwardKernel(prob, opts, dtype=dtype, device=dev)
            ap = bk.pad_al(al)
            errs_b, errs_f = {}, {}
            for rho_v in tol.RHOS[tag]["obstacles"]:
                rho = torch.full((B,), rho_v, dtype=dtype, device=dev)
                got = bk(params, ap, Zb, rho)
                want = bk.plain(params, ap, Zb, rho)
                _sync()
                assert torch.equal(got[4], want[4]), f"obstacles backward rho={rho_v}: failed flags differ"
                ok = ~want[4]
                case = {
                    key: compare(key, g, w, dtype, mask=ok, f32_rel=tol.OBSTACLE_F32_REL)
                    for key, g, w in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4])
                }
                case["J0"] = compare("J0", got[5], want[5], dtype, f32_rel=tol.OBSTACLE_F32_REL)
                case["n_failed"] = int(want[4].sum())
                errs_b[f"rho={rho_v}"] = case
                if rho_v == tol.RHOS[tag]["obstacles"][1]:
                    K, d = want[0], want[1]
            for alpha, cb, KK, dd in (
                (1.0, True, K, d), (0.5, True, K, d),
                (0.0, False, torch.zeros_like(K), torch.zeros_like(d)),
            ):
                a = torch.full((B,), alpha, dtype=dtype, device=dev)
                got = fk(params, ap, Zb, KK, dd, a, check_bounds=cb)
                want = fk.plain(params, ap, Zb, KK, dd, a, check_bounds=cb)
                _sync()
                assert torch.equal(got[3], want[3]), "obstacles forward: valid flags differ"
                assert torch.equal(got[4], want[4]), "obstacles forward: status differs"
                errs_f[f"alpha={alpha},guarded={cb}"] = {
                    key: compare(key, g, w, dtype, f32_rel=tol.OBSTACLE_F32_REL)
                    for key, g, w in zip(("Xn", "Ubar", "J"), got[:3], want[:3])
                }
            line = {"phase": "obstacles_kernel_vs_plain", "dtype": tag, "N": N, "B": B,
                    "Ps": bk.Ps, "Fs": bk.Fs, "circle_rows_penalized": active,
                    "backward_fused": errs_b, "forward": errs_f}
            if B == B_FLEET:
                rho = torch.full((B,), tol.RHOS[tag]["obstacles"][1], dtype=dtype, device=dev)
                a1 = torch.ones((B,), dtype=dtype, device=dev)
                times = dict(
                    backward_ms=cuda_ms(lambda: bk(params, ap, Zb, rho), 20),
                    backward_device_ms=device_ms(lambda: bk(params, ap, Zb, rho), 20, "backward_fused_kernel"),
                    backward_plain_ms=cuda_ms(lambda: bk.plain(params, ap, Zb, rho), 3),
                    forward_ms=cuda_ms(lambda: fk(params, ap, Zb, K, d, a1), 20),
                    forward_device_ms=device_ms(lambda: fk(params, ap, Zb, K, d, a1), 20, "forward_kernel"),
                    forward_plain_ms=cuda_ms(lambda: fk.plain(params, ap, Zb, K, d, a1), 3),
                )
                wb, wf = fused_work(bk, B, item), forward_work(fk, B, item)
                line.update(times, backward_bound=bound(*wb, tag), forward_bound=bound(*wf, tag))
                summary[tag] = dict(
                    backward_fused=dict(
                        max_abs_err=max(c[k]["max_abs"] for c in errs_b.values() for k in ("K", "d")),
                        ms=times["backward_ms"], device_ms=times["backward_device_ms"],
                        plain_ms=times["backward_plain_ms"], work=wb),
                    forward=dict(
                        max_abs_err=max(c[k]["max_abs"] for c in errs_f.values() for k in ("Xn", "Ubar")),
                        ms=times["forward_ms"], device_ms=times["forward_device_ms"],
                        plain_ms=times["forward_plain_ms"], work=wf),
                )
            emit(line)
            assert active > 0.05, f"only {active:.3f} of the circle rows are penalized"
    return summary


def obstacle_fleet_run(dev) -> dict:
    """Step 3 of phase_obstacles; returns each mode's result on the first
    OBST_PLAIN_LANES lanes and its launches per solve."""
    import torch

    from altro_tpu_torch import SolverStatus

    x0s = obstacle_x0s(B_FLEET)
    runs = {}
    for mode in ("f32_throughput", "complete"):
        solver, defn, prob = obstacle_solver(mode, "kernels", dev)
        kerns = obstacle_kernels(solver)
        assert all(k is not None for k in kerns["backward_fused"] + kerns["forward"]), (
            f"{mode}: the fused kernels refused the obstacle problem")
        params = prob.params.replace(x0=torch.as_tensor(x0s, device=dev).float())
        Zb = fleet_trajectory(defn, B_FLEET)
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        _sync()
        warm_s = time.perf_counter() - t0
        for ks in kerns.values():
            for k in ks:
                if k is not None:
                    k.launches = 0
        walls, syncs = [], []
        for _ in range(OBST_REPS):
            t0 = time.perf_counter()
            res = solver.solve(params, Zb)
            _sync()
            walls.append(time.perf_counter() - t0)
            syncs.append(solver.host_syncs)
        launches = {name: _launches(ks) / OBST_REPS for name, ks in kerns.items()}
        out = obstacle_outcome(solver, defn, params, res, OBST_PLAIN_LANES)
        status, it, clr = out["status"], out["iterations"], out["clearance"]
        solved = status == int(SolverStatus.SOLVED)
        wall = float(np.median(walls))
        emit(dict(
            phase="obstacles_fleet", mode=mode, path="kernels", B=B_FLEET, N=N, dtype="f32",
            status_hist={SolverStatus(int(c)).name: int((status == c).sum()) for c in sorted(set(status.tolist()))},
            solved_frac=float(solved.mean()), warmup_s=warm_s, wall_s_reps=walls, wall_s_median=wall,
            solves_per_s=B_FLEET / wall, host_syncs_per_solve=syncs, launches_per_solve=launches,
            iters_p50=float(np.percentile(it, 50)), iters_p99=float(np.percentile(it, 99)),
            iters_max=int(it.max()), telemetry=solver.telemetry,
            lane0_min_clearance_m=float(clr[0]), solved_min_clearance_m=float(clr[solved].min()),
        ))
        assert out["finite"], f"{mode}: non-finite result"
        assert launches["backward_fused"] > 0 and launches["forward"] > 0 and launches["riccati"] == 0, launches
        assert float(clr[solved].min()) >= CLEARANCE_MIN, f"{mode}: a SOLVED lane enters an obstacle"
        runs[mode] = dict(out, launches=launches, U=res["Z"].U.cpu())
    status = runs["complete"]["status"]
    assert int(status[0]) == int(SolverStatus.SOLVED), "complete mode: lane 0 not SOLVED"
    frac = float((status == int(SolverStatus.SOLVED)).mean())
    assert frac >= 0.99, f"complete mode: {frac:.4f} SOLVED"
    return runs


def obstacle_polish_run(dev, base) -> dict:
    """Step 4 of phase_obstacles: the fleet in f32_throughput mode with the
    float64 polish (the JAX package's f64 complete mode), one solve on the
    built kernels, every kernel's count set to 0 before it.  `base` is
    step 3's f32_throughput run, the same program before its polish.
    Returns each fused kernel's float64 launches in the solve."""
    import torch

    from altro_tpu_torch import SolverStatus
    from altro_tpu_torch.solver.compaction import _HARD, _POLISH_STAGES

    solver, defn, prob = obstacle_solver("f32_throughput", "kernels", dev, f64_polish=True)
    kerns = obstacle_kernels(solver)
    f64 = polish_kernels(solver)
    assert all(k is not None and k.dtype == torch.float64 for k in f64), "the polish has no float64 kernels"
    params = prob.params.replace(x0=torch.as_tensor(obstacle_x0s(B_FLEET), device=dev).float())
    for k in f64 + [k for ks in kerns.values() for k in ks if k is not None]:
        k.launches = 0
    t0 = time.perf_counter()
    res = solver.solve(params, fleet_trajectory(defn, B_FLEET))
    _sync()
    wall = time.perf_counter() - t0
    f64_launches = polish_launches(solver)
    out = obstacle_outcome(solver, defn, params, res, OBST_PLAIN_LANES)
    status, clr = out["status"], out["clearance"]
    solved = status == int(SolverStatus.SOLVED)
    before = base["status"]
    took = np.isin(before, _POLISH_STAGES[0][0])
    stage0 = int(took.sum())
    # what the JAX package's polish does to the same lanes
    g = np.load(OBST_POLISH_GOLDEN)
    hard0 = np.isin(g["stage0"], _HARD)
    ref = np.where(hard0, g["stage1"], g["stage0"]).astype(int)
    differ = np.nonzero(took & (status != ref))[0]
    ref_stages = [stage0, int((took & hard0).sum())]
    kept = before == int(SolverStatus.SOLVED)
    untouched = bool((status[kept] == before[kept]).all()) and bitwise(
        [res["Z"].U.cpu()[..., torch.as_tensor(kept)]], [base["U"][..., torch.as_tensor(kept)]])
    tel = solver.telemetry.get("polish")
    emit(dict(
        phase="obstacles_polish", mode="f32_throughput+f64_polish", path="kernels", B=B_FLEET, N=N,
        status_hist={SolverStatus(int(c)).name: int((status == c).sum()) for c in sorted(set(status.tolist()))},
        solved_frac=float(solved.mean()), wall_s=wall, host_syncs=solver.host_syncs,
        stage0_lanes_before=stage0, polish=tel, f64_launches=f64_launches,
        f32_launches={name: _launches(ks) for name, ks in kerns.items()},
        iters_p50=solver.telemetry["iters_p50"], iters_p95=solver.telemetry["iters_p95"],
        iters_p99=solver.telemetry["iters_p99"], iters_max=solver.telemetry["iters_max"],
        solved_before_untouched=untouched, solved_min_clearance_m=float(clr[solved].min()),
        # the polished lanes and their statuses, for holding them against
        # the JAX package's polish of the same lanes on the CPU
        polished_lanes=np.nonzero(took)[0].tolist(), polished_status=status[took].tolist(),
        jax_stage_lanes=ref_stages, lanes_unlike_jax=differ.tolist(),
        jax_solved_frac=float((np.where(took, ref, status) == int(SolverStatus.SOLVED)).mean()),
    ))
    assert out["finite"], "obstacles polish: non-finite result"
    assert tel is not None and tel["instances"] == stage0, (tel, stage0)
    assert [s["instances"] for s in tel["stages"]] == [n for n in ref_stages if n], (tel["stages"], ref_stages)
    assert min(f64_launches.values()) > 1, f64_launches
    assert differ.size == 0, f"polish: lanes {differ.tolist()} end unlike the JAX package's polish"
    assert float(clr[solved].min()) >= CLEARANCE_MIN, "polish: a SOLVED lane enters an obstacle"
    assert untouched, "polish: a lane SOLVED before the polish changed"
    return f64_launches


def obstacles_part(dev):
    """The three-obstacle unicycle fleet (perf/benchmark_obstacles.py: the
    scenario of the reference's 31.768 ms anchor), on both fused kernels:
      1. the kernels' circle rows (csrc/lane_algebra.cuh:comp_circle,
         through circle_rows_on_card) against comp_circle, bit for bit, on
         rows near the obstacles' edges and away from them, f32 and f64;
      2. both fused kernels against their plain versions at the obstacle
         problem's shapes (N=100; 7 stage multiplier rows, 2 penalty rows)
         at B=4096 and OBST_RAGGED_B, f64 and f32, at field_case's inputs
         (circle rows penalized): the backward kernel at each of
         tolerances.RHOS' obstacle ρ, the forward kernel rolling out the
         plain gains of the second (0.37) at α = 1 and 0.5 (guarded) and
         the open-loop α = 0; CUDA event and device times and the bounds at
         B=4096;
      3. the B=4096 fleet (bench.make_batch's x0) in f32 on the kernels, in
         both of the script's modes, f32_throughput and complete (its
         restart cascade): a warm-up and OBST_REPS timed solves each, the
         kernels' counts set to 0 before the timed solves;
      4. one solve in f32_throughput mode with the float64 polish
         (obstacle_polish_run): the polish takes the lanes step 3 left
         with its stage-0 codes, on the fused kernels' float64
         instantiations (each launched more than once); each stage takes
         the lanes, and every polished lane ends with the status, that the
         JAX package's float64 polish gives it (OBST_POLISH_GOLDEN); every
         lane SOLVED before the polish keeps its status and U bit for bit
         (tests/test_f64_polish.py:85-91);
      5. the fleet's first OBST_PLAIN_LANES lanes on the plain path (eager
         passes, on PLAIN_DEVICE) in OBST_PLAIN_MODE, split over
         OBST_PLAIN_PROCS processes that run_plain runs after the kernel
         solves (the lanes are independent), held to
         perf/benchmark_zoo.py's contract against the kernels' solve in
         that mode: SOLVED shares within 2 points, median relative cost
         difference on lanes both solved < 2e-2.
    Asserts as well that every SOLVED lane of either path clears every
    obstacle by CLEARANCE_MIN at every knot (example_unicycle_test.cpp:
    76-83), that lane 0 is SOLVED and >= 99% of lanes are in complete
    mode.  Returns (step 2's f32 summary, run_plain's part, whose check
    returns each kernel's launches per solve in each mode, and its float64
    launches in step 4's solve under "polish_f64")."""
    from altro_tpu_torch import SolverStatus

    summary = obstacle_kernels_vs_plain(dev)
    runs = obstacle_fleet_run(dev)
    polish = obstacle_polish_run(dev, runs["f32_throughput"])
    L, P = OBST_PLAIN_LANES, OBST_PLAIN_PROCS
    x0s = obstacle_x0s(B_FLEET)[:, :L]
    jobs = [(("obstacles", i), obstacle_plain_solve, (OBST_PLAIN_MODE, x0s[:, i * L // P:(i + 1) * L // P]))
            for i in range(P)]

    def check(parts, plain_wall):
        parts = [parts[key] for key, _, _ in jobs]
        plain = {key: np.concatenate([r[key] for r in parts]) for key in ("status", "J", "clearance")}
        rk = runs[OBST_PLAIN_MODE]
        solved = int(SolverStatus.SOLVED)
        st_k, st_p = rk["status"][:L], plain["status"]
        rate_k, rate_p = float((st_k == solved).mean()), float((st_p == solved).mean())
        both = (st_k == solved) & (st_p == solved)
        relj = np.abs(rk["J"] - plain["J"])[both] / np.maximum(np.abs(plain["J"])[both], 1e-9)
        clr = plain["clearance"]
        launches = sum(r["launches"] for r in parts)
        emit(dict(
            phase="obstacles_vs_plain", mode=OBST_PLAIN_MODE, lanes=L, processes=P, plain_device=PLAIN_DEVICE,
            plain_wall_s=[r["wall_s"] for r in parts], plain_stage_wall_s=plain_wall,
            plain_host_syncs=[r["host_syncs"] for r in parts], plain_launches=launches,
            plain_iters_max=[r["telemetry"]["iters_max"] for r in parts],
            plain_status_hist={SolverStatus(int(c)).name: int((st_p == c).sum()) for c in sorted(set(st_p.tolist()))},
            solved_rate_kernel=rate_k, solved_rate_plain=rate_p, status_agreement=float((st_k == st_p).mean()),
            jointly_solved=int(both.sum()),
            cost_rel_diff_p50=float(np.median(relj)) if both.any() else None,
            cost_rel_diff_p99=float(np.percentile(relj, 99)) if both.any() else None,
            plain_solved_min_clearance_m=float(clr[st_p == solved].min()) if (st_p == solved).any() else None,
        ))
        assert all(r["finite"] for r in parts), "obstacles plain: non-finite result"
        assert launches == 0, "obstacles: the plain path launched a kernel"
        assert (st_p != solved).all() or float(clr[st_p == solved].min()) >= CLEARANCE_MIN, (
            "plain: a SOLVED lane enters an obstacle")
        assert abs(rate_k - rate_p) <= 0.02, (rate_k, rate_p)
        assert both.any() and float(np.median(relj)) < 2e-2, float(np.median(relj)) if both.any() else None
        return dict({mode: r["launches"] for mode, r in runs.items()}, polish_f64=polish)

    return summary, ("obstacles", jobs, check)


def phase_obstacles(dev) -> tuple:
    """obstacles_part and its plain solves; returns (its f32 kernel
    summary, each kernel's launches per solve in each mode)."""
    summary, part = obstacles_part(dev)
    return summary, run_plain([part])["obstacles"]


def randomized_case(dtype, B, dev, rng):
    """The randomized fleet's per-lane params (RAND_SEED) at field_case's
    expansion point (positions over the obstacle field, warm random AL
    state).  Returns (problem, params, Z, al, the share of circle rows with
    λ − ρc <= 0 against each lane's own layout)."""
    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import THREE_OBSTACLES, UnicycleProblem, randomized_fleet
    from altro_tpu_torch.solver.batched import ALSolverBatched

    prob, _, Z, al, _ = field_case(dtype, B, dev, rng)
    defn = UnicycleProblem(scenario=THREE_OBSTACLES, dtype=dtype, device=dev, N=N)
    params, _, _ = randomized_fleet(defn, prob, B, seed=RAND_SEED)
    ev = ALSolverBatched(prob, SolverOptions(), compensated_circles=True)
    fam = [i for i, f in enumerate(prob.constraint_families) if f.constraint.structure[0] == "circle"][0]
    c = ev.constraint_values(params, Z)[fam]
    s = al[fam]["lam"] - al[fam]["rho"][:, None, :] * c
    return prob, params, Z, al, float((s <= 0).double().mean())


def bitwise(a, b) -> bool:
    """Two tuples of outputs equal bit for bit (NaNs included)."""
    import torch

    return all(x.view(torch.uint8).equal(y.view(torch.uint8)) if x.dtype.is_floating_point else x.equal(y)
               for x, y in zip(a, b))


def broadcast_lanes(prob, params, B):
    """`params` with the randomized fleet's six leaves per lane again, each
    the problem's own (shared) value in every lane."""
    canon = prob.params
    kinds = [f.constraint.structure[0] for f in prob.constraint_families]
    cons = list(params.constraints)
    for kind in ("circle", "goal"):
        i = kinds.index(kind)
        cons[i] = {k: v[..., None].expand(*v.shape, B).contiguous() for k, v in canon.constraints[i].items()}
    cp = canon.costs[0]
    lane = {k: cp[k][..., None].expand(*cp[k].shape, B).contiguous() for k in ("q", "c")}
    return params.replace(constraints=tuple(cons), costs=(dict(params.costs[0], **lane),))


def randomized_kernels_vs_plain(dev) -> dict:
    """Part 1 of phase_randomized; returns the f32 summary of each kernel at
    B=B_FLEET (max error, times, work)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
    from altro_tpu_torch.ops.forward import ForwardKernel
    from altro_tpu_torch.solver.batched import gather_params

    rng = np.random.default_rng(6)
    summary = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        item = torch.finfo(dtype).bits // 8
        for B in (B_FLEET, OBST_RAGGED_B):
            prob, params, Zb, al, active = randomized_case(dtype, B, dev, rng)
            opts = SolverOptions()
            bk = BackwardFusedKernel(prob, opts, dtype=dtype, device=dev)
            fk = ForwardKernel(prob, opts, dtype=dtype, device=dev)
            sig = sorted(bk.param_sig(params))
            assert len(sig) == 6 and sig == sorted(fk.param_sig(params)), sig
            ap = bk.pad_al(al)
            errs_b, errs_f = {}, {}
            for rho_v in tol.RHOS[tag]["obstacles"]:
                rho = torch.full((B,), rho_v, dtype=dtype, device=dev)
                got = bk(params, ap, Zb, rho)
                want = bk.plain(params, ap, Zb, rho)
                _sync()
                assert torch.equal(got[4], want[4]), f"randomized backward rho={rho_v}: failed flags differ"
                ok = ~want[4]
                case = {
                    key: compare(key, g, w, dtype, mask=ok, f32_rel=tol.OBSTACLE_F32_REL)
                    for key, g, w in zip(("K", "d", "dV1", "dV2"), got[:4], want[:4])
                }
                case["J0"] = compare("J0", got[5], want[5], dtype, f32_rel=tol.OBSTACLE_F32_REL)
                case["n_failed"] = int(want[4].sum())
                errs_b[f"rho={rho_v}"] = case
                if rho_v == tol.RHOS[tag]["obstacles"][1]:
                    K, d = want[0], want[1]
            for alpha, cb, KK, dd in (
                (1.0, True, K, d), (0.5, True, K, d),
                (0.0, False, torch.zeros_like(K), torch.zeros_like(d)),
            ):
                a = torch.full((B,), alpha, dtype=dtype, device=dev)
                got = fk(params, ap, Zb, KK, dd, a, check_bounds=cb)
                want = fk.plain(params, ap, Zb, KK, dd, a, check_bounds=cb)
                _sync()
                assert torch.equal(got[3], want[3]), "randomized forward: valid flags differ"
                assert torch.equal(got[4], want[4]), "randomized forward: status differs"
                errs_f[f"alpha={alpha},guarded={cb}"] = {
                    key: compare(key, g, w, dtype, f32_rel=tol.OBSTACLE_F32_REL)
                    for key, g, w in zip(("Xn", "Ubar", "J"), got[:3], want[:3])
                }
            line = {"phase": "randomized_kernel_vs_plain", "dtype": tag, "N": N, "B": B, "per_lane": sig,
                    "circle_rows_penalized": active, "backward_fused": errs_b, "forward": errs_f}
            if B == B_FLEET:
                rho = torch.full((B,), tol.RHOS[tag]["obstacles"][1], dtype=dtype, device=dev)
                a1 = torch.ones((B,), dtype=dtype, device=dev)
                # per-lane leaves holding the shared values give the shared launch's bits
                shared = prob.params.replace(x0=params.x0)
                lanes = broadcast_lanes(prob, shared, B)
                same_b = bitwise(bk(shared, ap, Zb, rho), bk(lanes, ap, Zb, rho))
                same_f = bitwise(fk(shared, ap, Zb, K, d, a1), fk(lanes, ap, Zb, K, d, a1))
                # lanes are independent: a permutation of the inputs permutes the outputs
                perm = torch.as_tensor(np.random.default_rng(8).permutation(B), device=dev)
                pp = gather_params(prob.params, params, perm)
                Zp = Zb.replace(X=Zb.X[..., perm].contiguous(), U=Zb.U[..., perm].contiguous())
                app = bk.pad_al(tuple(dict(lam=st["lam"][..., perm].contiguous(), rho=st["rho"][..., perm].contiguous())
                                      for st in al))
                perm_b = bitwise([x[..., perm] for x in bk(params, ap, Zb, rho)], bk(pp, app, Zp, rho))
                perm_f = bitwise([x[..., perm] for x in fk(params, ap, Zb, K, d, a1)],
                                 fk(pp, app, Zp, K[..., perm].contiguous(), d[..., perm].contiguous(), a1))
                line.update(broadcast_equals_shared=dict(backward=same_b, forward=same_f),
                            permutation_bitwise=dict(backward=perm_b, forward=perm_f))
                assert same_b and same_f, "per-lane leaves broadcast from the shared values differ from the shared launch"
                assert perm_b and perm_f, "a permutation of the lanes does not permute the outputs"
                times = dict(
                    backward_ms=cuda_ms(lambda: bk(params, ap, Zb, rho), 20),
                    backward_device_ms=device_ms(lambda: bk(params, ap, Zb, rho), 20, "backward_fused_lanes_kernel"),
                    backward_plain_ms=cuda_ms(lambda: bk.plain(params, ap, Zb, rho), 3),
                    forward_ms=cuda_ms(lambda: fk(params, ap, Zb, K, d, a1), 20),
                    forward_device_ms=device_ms(lambda: fk(params, ap, Zb, K, d, a1), 20, "forward_lanes_kernel"),
                    forward_plain_ms=cuda_ms(lambda: fk.plain(params, ap, Zb, K, d, a1), 3),
                )
                wb, wf = fused_work(bk, B, item, params), forward_work(fk, B, item, params)
                line.update(times, backward_bound=bound(*wb, tag), forward_bound=bound(*wf, tag),
                            lane_bytes_per_launch=lane_words(bk, params) * B * item,
                            backward_geometry=dataclasses.asdict(bk.geometry(B, params)),
                            forward_geometry=dataclasses.asdict(fk.geometry(B, params)))
                summary[tag] = dict(
                    backward_fused=dict(
                        max_abs_err=max(c[k]["max_abs"] for c in errs_b.values() for k in ("K", "d")),
                        ms=times["backward_ms"], device_ms=times["backward_device_ms"],
                        plain_ms=times["backward_plain_ms"], work=wb),
                    forward=dict(
                        max_abs_err=max(c[k]["max_abs"] for c in errs_f.values() for k in ("Xn", "Ubar")),
                        ms=times["forward_ms"], device_ms=times["forward_device_ms"],
                        plain_ms=times["forward_plain_ms"], work=wf),
                )
            emit(line)
            assert active > 0.05, f"only {active:.3f} of the circle rows are penalized"
    return summary


def randomized_fleet_run(dev) -> dict:
    """Part 3 of phase_randomized; returns each kernel's launches per
    solve."""
    import torch

    from altro_tpu_torch import SolverStatus
    from altro_tpu_torch.models.problems import randomized_fleet

    solver, defn, prob = obstacle_solver("f32_throughput", "kernels", dev)
    kerns = obstacle_kernels(solver)
    params, obstacles, xf = randomized_fleet(defn, prob, B_FLEET, seed=RAND_SEED)
    sigs = {k.param_sig(params) for k in kerns["backward_fused"] + kerns["forward"]}
    assert all(k is not None and k.takes(params) for k in kerns["backward_fused"] + kerns["forward"]), (
        "the fused kernels refused the randomized fleet")
    sig = sorted(kerns["forward"][0].param_sig(params))
    assert len(sigs) == 1 and len(sig) == 6, sigs  # circle cx, cy, r + goal xf + cost q, c
    Zb = fleet_trajectory(defn, B_FLEET)
    t0 = time.perf_counter()
    res = solver.solve(params, Zb)
    _sync()
    warm_s = time.perf_counter() - t0
    for ks in kerns.values():
        for k in ks:
            if k is not None:
                k.launches = 0
    walls, syncs = [], []
    for _ in range(RAND_REPS):
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        _sync()
        walls.append(time.perf_counter() - t0)
        syncs.append(solver.host_syncs)
    launches = {name: _launches(ks) / RAND_REPS for name, ks in kerns.items()}
    X = res["Z"].X
    status = res["status"].cpu().numpy()
    it = res["stats"].iterations_total.cpu().numpy()
    solved = status == int(SolverStatus.SOLVED)
    clr = clearance(X, obstacles)  # against each lane's own circles
    goal_err = (X[-1].double() - torch_f64(xf, X.device)).abs().amax(dim=0).cpu().numpy()  # its own goal
    finite = bool(torch.isfinite(X).all() and torch.isfinite(res["Z"].U).all())
    wall = float(np.median(walls))
    tol_goal = solver.opts.constraint_tolerance  # the goal row's bound when a lane is SOLVED
    emit(dict(
        phase="randomized_fleet", mode="f32_throughput", path="kernels", B=B_FLEET, N=N, dtype="f32",
        per_lane=sig, status_hist={SolverStatus(int(c)).name: int((status == c).sum()) for c in sorted(set(status.tolist()))},
        solved_frac=float(solved.mean()), warmup_s=warm_s, wall_s_reps=walls, wall_s_median=wall,
        solves_per_s=B_FLEET / wall, host_syncs_per_solve=syncs, launches_per_solve=launches,
        iters_p50=float(np.percentile(it, 50)), iters_p99=float(np.percentile(it, 99)), iters_max=int(it.max()),
        telemetry=solver.telemetry, solved_min_clearance_m=float(clr[solved].min()) if solved.any() else None,
        min_clearance_m=float(clr.min()), goal_err_p99=float(np.percentile(goal_err, 99)),
        solved_goal_err_max=float(goal_err[solved].max()) if solved.any() else None, goal_tolerance=tol_goal,
    ))
    assert finite, "randomized fleet: non-finite result"
    assert launches["backward_fused"] > 0 and launches["forward"] > 0 and launches["riccati"] == 0, launches
    assert solved.any() and float(clr[solved].min()) >= CLEARANCE_MIN, "a SOLVED lane enters one of its obstacles"
    assert float(goal_err[solved].max()) < tol_goal, "a SOLVED lane ends away from its goal"
    assert float(solved.mean()) >= RAND_SOLVED_MIN, f"{float(solved.mean()):.4f} SOLVED"
    return launches


def randomized_complete_run(dev) -> dict:
    """Part 4 of phase_randomized; returns each kernel's launches in the
    solve."""
    import torch

    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import THREE_OBSTACLES, UnicycleProblem, randomized_fleet
    from altro_tpu_torch.solver.compaction import CompactedALSolver

    defn = UnicycleProblem(scenario=THREE_OBSTACLES, dtype=torch.float32, device=dev, N=N)
    prob = defn.make_problem().compile()
    step_bound = float(defn.v_bnd * defn.tf / defn.N)
    opts = SolverOptions(**BENCH_OPT_KW).replace(**OBST_OPT_KW, max_iterations_total=RAND_COMPLETE_MAX_TOTAL)
    solver = CompactedALSolver(prob, opts, phase1_iters=PHASE1_ITERS, tail_batch=TAIL_BATCH, device_tail=True,
                               infeasible_step_bound=step_bound, **RAND_COMPLETE)
    kerns = obstacle_kernels(solver)
    params, obstacles, xf = randomized_fleet(defn, prob, B_FLEET, seed=RAND_SEED)
    assert all(k is not None and k.takes(params) for k in kerns["backward_fused"] + kerns["forward"]), (
        "the fused kernels refused the randomized fleet")
    for ks in kerns.values():
        for k in ks:
            if k is not None:
                k.launches = 0
    t0 = time.perf_counter()
    res = solver.solve(params, fleet_trajectory(defn, B_FLEET))
    _sync()
    wall = time.perf_counter() - t0
    launches = {name: _launches(ks) for name, ks in kerns.items()}
    X = res["Z"].X
    status = res["status"].cpu().numpy()
    it = res["stats"].iterations_total.cpu().numpy()
    solved = status == int(SolverStatus.SOLVED)
    clr = clearance(X, obstacles)
    goal_err = (X[-1].double() - torch_f64(xf, X.device)).abs().amax(dim=0).cpu().numpy()
    tol_goal = solver.opts.constraint_tolerance
    n_infeasible = int((status == int(SolverStatus.INFEASIBLE)).sum())
    emit(dict(
        phase="randomized_fleet", mode="complete", path="kernels", B=B_FLEET, N=N, dtype="f32",
        status_hist={SolverStatus(int(c)).name: int((status == c).sum()) for c in sorted(set(status.tolist()))},
        solved_frac=float(solved.mean()), infeasible=n_infeasible, step_bound=step_bound, wall_s=wall,
        solves_per_s=B_FLEET / wall, host_syncs=solver.host_syncs, launches=launches,
        restart_lanes=solver.telemetry["restart_lanes"], restart_host_syncs=solver.telemetry["restart_host_syncs"],
        tail_rounds=solver.telemetry["tail_rounds"], iters_p50=float(np.percentile(it, 50)),
        iters_p99=float(np.percentile(it, 99)), iters_max=int(it.max()),
        solved_min_clearance_m=float(clr[solved].min()) if solved.any() else None,
        solved_goal_err_max=float(goal_err[solved].max()) if solved.any() else None, goal_tolerance=tol_goal,
    ))
    assert bool(torch.isfinite(X).all() and torch.isfinite(res["Z"].U).all()), "complete mode: non-finite result"
    assert launches["backward_fused"] > 0 and launches["forward"] > 0 and launches["riccati"] == 0, launches
    assert n_infeasible == 0, f"{n_infeasible} lanes certified infeasible on a feasible sampler"
    assert float(solved.mean()) >= RAND_COMPLETE_SOLVED_MIN, f"complete mode: {float(solved.mean()):.4f} SOLVED"
    assert float(clr[solved].min()) >= CLEARANCE_MIN, "complete mode: a SOLVED lane enters one of its obstacles"
    assert float(goal_err[solved].max()) <= tol_goal, "complete mode: a SOLVED lane ends away from its goal"
    randomized_certificates(dev, defn, prob, step_bound)
    return launches


def randomized_certificates(dev, defn, prob, step_bound) -> None:
    """The certificates on the card: the randomized fleet with the goals of
    RAND_CERT_LANES lanes moved to the centre of their own first obstacle.
    `goal_obstacle_certificates` on the card flags exactly those lanes,
    and equals a numpy evaluation of its rule (a circle family at knot
    N-1: some obstacle with |xf − c| < r − step_bound)."""
    import torch

    from altro_tpu_torch.models.problems import randomized_fleet
    from altro_tpu_torch.problem.infeasibility import goal_obstacle_certificates

    params, (cx, cy, r), xf = randomized_fleet(defn, prob, B_FLEET, seed=RAND_SEED)
    lanes = np.random.default_rng(11).choice(B_FLEET, RAND_CERT_LANES, replace=False)
    xf = xf.copy()
    xf[0, lanes], xf[1, lanes] = cx[0, lanes], cy[0, lanes]
    gi = [f.constraint.structure[0] for f in prob.constraint_families].index("goal")
    cons = list(params.constraints)
    cons[gi] = dict(cons[gi], xf=torch.as_tensor(xf, device=dev).float())
    mask = goal_obstacle_certificates(prob, params.replace(constraints=tuple(cons)), B_FLEET, step_bound)
    got = mask.cpu().numpy()
    x, y, cx, cy, r = (a.astype(np.float32).astype(np.float64) for a in (xf[0], xf[1], cx, cy, r))  # the card's inputs
    rule = (np.sqrt((x - cx) ** 2 + (y - cy) ** 2) < r - step_bound).any(axis=0)
    want = np.zeros(B_FLEET, bool)
    want[lanes] = True
    emit(dict(phase="randomized_certificates", B=B_FLEET, moved=sorted(lanes.tolist()), device=str(mask.device),
              flagged=int(got.sum()), equals_moved=bool((got == want).all()), equals_numpy=bool((got == rule).all())))
    assert mask.device.type == "cuda" and mask.dtype == torch.bool
    assert (got == want).all(), "the certificates do not flag exactly the moved lanes"
    assert (got == rule).all(), "the certificates differ from the numpy rule"


def phase_randomized(dev) -> tuple:
    """The randomized three-obstacle fleet (perf/benchmark_randomized.py,
    BASELINE config 5): per-lane x0, obstacle layouts (cx, cy, r [3, B]),
    goals (xf [3, B]) and the tracking cost's q [N+1, 3, B], c [N+1, B],
    read per lane by the fused kernels' lane-params instantiations:
      1. both kernels against their plain versions at the fleet's shapes
         (N=100) at B=4096 and OBST_RAGGED_B, f64 and f32, at
         randomized_case's inputs: the backward kernel at each of
         tolerances.RHOS' obstacle ρ, the forward kernel rolling out the
         plain gains of the second at α = 1 and 0.5 (guarded) and the
         open-loop α = 0, within OBSTACLE_F32_REL (f32) and F64_RTOL /
         F64_ATOL (f64); at B=4096 per-lane leaves broadcast from the
         shared values equal the shared launch bit for bit, a permutation
         of the lanes permutes every output bit for bit, and CUDA event
         and device times beside the plain version's and the bounds (the
         lane table's bytes counted);
      2. per-lane dynamics params: the cartpole's pole mass [B] and the
         quadrotor's inertia J [3, B] at the zoo's shapes, B=2048, held as
         phase_fused_zoo_vs_plain holds the zoo;
      3. the B=4096 fleet in f32_throughput mode on the kernels: one
         warm-up and RAND_REPS timed solves (the counts set to 0 between),
         asserting both kernels ran with the six per-lane leaves, every
         SOLVED lane clear of its own circles by CLEARANCE_MIN at every
         knot and within the goal constraint's tolerance of its own goal,
         and at least RAND_SOLVED_MIN SOLVED;
      4. the script's complete mode (RAND_COMPLETE: the restart cascade,
         the certificates with the step bound v_max·h, total cap 120) on
         the kernels' lane-params instantiations: one solve on the built
         kernels, the counts set to 0 before it, asserting no lane
         certified infeasible (the sampler is feasible by construction),
         at least RAND_COMPLETE_SOLVED_MIN SOLVED and part 3's clearance
         and goal checks; then the certificates on the card
         (randomized_certificates).
    Returns (part 1's f32 summary, each kernel's launches per solve in
    part 3, its launches in part 4's solve)."""
    import torch

    summary = randomized_kernels_vs_plain(dev)
    for dtype in (torch.float64, torch.float32):
        for name, key in (("cartpole", "mass_pole"), ("quadrotor", "J")):
            zoo_kernels_vs_plain(dev, name, dtype, np.random.default_rng(0), lane_key=key)
    return summary, randomized_fleet_run(dev), randomized_complete_run(dev)


# --------------------------------------------------------------- this slice
SPEC_S = (2, 8)  # line_search_parallel of the main path's speculative solves
SPEC_RAND_LANES = 1024  # the randomized fleet's lanes in the speculative check
SPEC_RAND_S = 4
SPEC_RAND_MAX_TOTAL = 30
TRIPLE_B = (2048, 1001, 1)  # widths of the triple integrator's kernel checks
TRIPLE_FLEET_B = 2048
TRIPLE_U_REL = 1e-9  # kernels against the Riccati fallback, relative to max(|U|, 1), float64
GENERAL_B = 1024
GENERAL_N = 40
GENERAL_SOLVED_MIN = 0.99
GENERAL_U_REL = 1e-9
# the main path's last S=1 solve (phase_main_path), which the speculative
# and live-row steps are held against
_MAIN_REF = {}


def _same_solve(a, b) -> dict:
    """Statuses, iterations and α equal, U and cost bit for bit, between two
    solves' results."""
    return dict(
        statuses=bool(a["status"].equal(b["status"])),
        iterations=bool(a["stats"].iterations_total.equal(b["stats"].iterations_total)),
        alpha=bitwise([a["stats"].alpha], [b["stats"].alpha]),
        U_bitwise=bitwise([a["Z"].U], [b["Z"].U]),
        cost_bitwise=bitwise([a["stats"].cost], [b["stats"].cost]),
    )


def _main_fleet(dev):
    """The main path's problem and fleet, f32: bench.make_batch's x0
    uniform in ±0.1 from default_rng(0), lane 0 canonical.  Returns
    (definition, compiled problem, params, initial trajectory)."""
    import torch

    from altro_tpu_torch.models.problems import UnicycleProblem

    defn = UnicycleProblem(dtype=torch.float32, device=dev, N=N)
    prob = defn.make_problem().compile()
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, size=(3, B_FLEET)), device=dev).float()
    x0[:, 0] = 0.0
    return defn, prob, prob.params.replace(x0=x0), fleet_trajectory(defn, B_FLEET)


def _main_reference(dev) -> dict:
    """phase_main_path's S=1 solve, or (in a `--phase` run) one like it."""
    if not _MAIN_REF:
        defn, prob, params, Zb = _main_fleet(dev)
        solver = bench_solver(prob)
        solver.solve(params, Zb)
        first_syncs = solver.host_syncs
        for k in (solver._p1._fwd, solver._tail._fwd):
            k.launches = 0
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        _sync()
        _MAIN_REF.update(res=res, wall_s=time.perf_counter() - t0, host_syncs=solver.host_syncs,
                         first_host_syncs=first_syncs,
                         forward_launches=solver._p1._fwd.launches + solver._tail._fwd.launches)
    return _MAIN_REF


def spec_forward_times(dev) -> dict:
    """The forward kernel at the widths the speculative search launches it
    at on the main path: the main fleet's rollout (f32, B_FLEET lanes), a
    random AL state and the gains the fused backward returns at ρ = 0.37,
    widened as `_line_search_speculative` widens them (`_widened`, `_tile`:
    S·B lanes, candidate-major) with the candidates α = 1, ½, …, ½^(S-1),
    for S = 1 and each of SPEC_S.  Per S: ms (CUDA events, median of 20),
    device ms (torch.profiler) and the bound at S·B lanes."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
    from altro_tpu_torch.ops.forward import ForwardKernel
    from altro_tpu_torch.solver.batched import ALSolverBatched, _tile

    _, prob, params, Z0 = _main_fleet(dev)
    opts = SolverOptions()
    ev = ALSolverBatched(prob, opts)
    Zb = ev.rollout(params, Z0)
    al = warm_al(ev, B_FLEET, torch.float32, dev, np.random.default_rng(42))
    bk = BackwardFusedKernel(prob, opts, dtype=torch.float32, device=dev)
    fk = ForwardKernel(prob, opts, dtype=torch.float32, device=dev)
    ap = bk.pad_al(al)
    K, d = bk(params, ap, Zb, torch.full((B_FLEET,), 0.37, dtype=torch.float32, device=dev))[:2]
    out = {}
    for S in (1,) + SPEC_S:
        params_s, ap_s = ev._widened(params, ap, S)
        Zs = Zb.replace(X=_tile(Zb.X, S), U=_tile(Zb.U, S))
        Ks, ds = _tile(K, S), _tile(d, S)
        a = (0.5 ** torch.arange(S, device=dev, dtype=torch.float32)).repeat_interleave(B_FLEET)
        launch = lambda: fk(params_s, ap_s, Zs, Ks, ds, a)  # noqa: E731
        bound_ms, bound_by = bound(*forward_work(fk, S * B_FLEET, 4), "f32")
        out[S] = dict(lanes=S * B_FLEET, ms=cuda_ms(launch, 20), device_ms=device_ms(launch, 20, "forward_kernel"),
                      bound_ms=bound_ms, bound_by=bound_by)
    return out


def phase_speculative(dev) -> dict:
    """The speculative line search (`line_search_parallel` S > 1: S step
    sizes in one forward-kernel launch at S·B lanes) on the main path,
    bench.make_solver's program at B=4096 in f32, S in SPEC_S: one warm-up
    and one timed solve each, with the kernels' counts set to 0 between,
    held against phase_main_path's S=1 solve (statuses, iterations and α
    equal, U and cost bit for bit), with wall, forward launches and host
    syncs per solve at S = 1, 2 and 8, and the forward kernel's time at
    each of those widths (spec_forward_times).  Then the randomized fleet's first
    SPEC_RAND_LANES lanes (per-lane leaves: the lane-params forward kernel
    at S·B lanes, one lane table a solve), f32, `ALSolverBatched` with the
    fleet's options capped at SPEC_RAND_MAX_TOTAL total iterations, S =
    SPEC_RAND_S against S = 1, with the same equalities.  Returns each
    fused kernel's launches per solve at each S of the main path and the
    forward kernel's times at each width."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import THREE_OBSTACLES, UnicycleProblem, randomized_fleet
    from altro_tpu_torch.solver.batched import ALSolverBatched, gather_params

    ref = _main_reference(dev)
    defn, prob, params, Zb = _main_fleet(dev)
    rows = {1: dict(wall_s=ref["wall_s"], host_syncs=ref["host_syncs"], forward_launches=ref["forward_launches"])}
    launches = {}
    for S in SPEC_S:
        solver = bench_solver(prob, line_search_parallel=S)
        solver.solve(params, Zb)
        kerns = [solver._p1._bwd, solver._p1._fwd, solver._tail._bwd, solver._tail._fwd]
        for k in kerns:
            k.launches = 0
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        _sync()
        wall = time.perf_counter() - t0
        same = _same_solve(res, ref["res"])
        launches[S] = dict(backward_fused=kerns[0].launches + kerns[2].launches,
                           forward=kerns[1].launches + kerns[3].launches)
        rows[S] = dict(wall_s=wall, host_syncs=solver.host_syncs, forward_launches=launches[S]["forward"],
                       backward_launches=launches[S]["backward_fused"], lanes_per_forward=S * B_FLEET, **same)
        assert all(same.values()), (S, same)
    emit(dict(phase="speculative", path="main", B=B_FLEET, N=N, dtype="f32", per_S=rows))
    fwd_times = spec_forward_times(dev)
    emit(dict(phase="speculative_forward", B=B_FLEET, N=N, dtype="f32", per_S=fwd_times))

    rdefn = UnicycleProblem(scenario=THREE_OBSTACLES, dtype=torch.float32, device=dev, N=N)
    rprob = rdefn.make_problem().compile()
    full, _, _ = randomized_fleet(rdefn, rprob, B_FLEET, seed=RAND_SEED)
    L = SPEC_RAND_LANES
    rparams = gather_params(rprob.params, full, torch.arange(L, device=dev))
    opts = SolverOptions(**BENCH_OPT_KW).replace(**OBST_OPT_KW, max_iterations_total=SPEC_RAND_MAX_TOTAL)
    out, rrows = {}, {}
    for S in (1, SPEC_RAND_S):
        s = ALSolverBatched(rprob, opts.replace(line_search_parallel=S))
        assert s._fwd is not None and s._fwd.takes(rparams) and s._fwd.param_sig(rparams), "no lane-params forward"
        t0 = time.perf_counter()
        out[S] = s.solve(rparams, fleet_trajectory(rdefn, L))
        _sync()
        rrows[S] = dict(wall_s=time.perf_counter() - t0, host_syncs=s.host_syncs, forward_launches=s._fwd.launches,
                        backward_launches=s._bwd.launches, lane_table_lanes=[e[3].shape[1] for e in s._fwd._prep])
    same = _same_solve(out[SPEC_RAND_S], out[1])
    status = out[1]["status"].cpu().numpy()
    emit(dict(phase="speculative", path="randomized", lanes=L, N=N, dtype="f32", max_iterations_total=SPEC_RAND_MAX_TOTAL,
              S=SPEC_RAND_S, per_S=rrows, **same,
              status_hist={int(c): int((status == c).sum()) for c in sorted(set(status.tolist()))}))
    assert all(same.values()), same
    return launches, fwd_times


def phase_triple_integrator(dev) -> dict:
    """The fused kernels' triple-integrator instantiations
    (`csrc/models.cuh:TripleIntegrator<2>`, (n, m) = (6, 2)):
      1. both kernels against their plain versions at
         TripleIntegratorProblem's shapes (N=10, its control bounds and
         goal), f64 and f32, B in TRIPLE_B, as phase_fused_zoo_vs_plain
         holds the zoo (each of tolerances.RHOS' ρ; each f64 lane within
         SENS_FACTOR times its one-ulp sensitivity), with CUDA event and
         device times and the bounds at B=2048;
      2. a TRIPLE_FLEET_B-lane fleet (x0 spread 0.05 about the problem's
         x0 from seed 0), f64, bench options, `ALSolverBatched` on both
         fused kernels against the Riccati fallback (the Riccati kernel
         and the eager forward pass): statuses and iterations equal, U
         within TRIPLE_U_REL of max(|U|, 1).
    Returns the f32 summary at B=2048 and each kernel's launches per
    solve."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import TripleIntegratorProblem
    from altro_tpu_torch.solver.batched import ALSolverBatched

    summary = {}
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(0)
        for B in TRIPLE_B:
            line = zoo_kernels_vs_plain(dev, "triple", dtype, rng, B=B, device_times=B == TRIPLE_B[0])
            if B == TRIPLE_B[0] and dtype == torch.float32:
                summary = dict(
                    backward_fused=dict(
                        max_abs_err=max(c[k]["max_abs"] for c in line["backward_fused"].values() for k in ("K", "d")),
                        ms=line["backward_ms"], device_ms=line["backward_device_ms"], plain_ms=line["backward_plain_ms"],
                        bound=line["backward_bound"]),
                    forward=dict(
                        max_abs_err=max(c[k]["max_abs"] for c in line["forward"].values() for k in ("Xn", "Ubar")),
                        ms=line["forward_ms"], device_ms=line["forward_device_ms"], plain_ms=line["forward_plain_ms"],
                        bound=line["forward_bound"]),
                )
    defn = TripleIntegratorProblem(dtype=torch.float64, device=dev)
    prob = defn.make_problem(add_constraints=True).compile()
    params = prob.params.replace(x0=zoo_x0s(defn._t(defn.x0), TRIPLE_FLEET_B, np.random.default_rng(0)))
    opts = SolverOptions(**BENCH_OPT_KW)
    sk = ALSolverBatched(prob, opts)
    sr = ALSolverBatched(prob, opts.replace(backward_pass="riccati", forward_pass="scan"))
    assert sk._bwd is not None and sk._fwd is not None and sk._ric is None, "the fused kernels refused the model"
    assert sr._ric is not None and sr._bwd is None and sr._fwd is None
    Zb = replicate(defn.initial_trajectory(), TRIPLE_FLEET_B)
    t0 = time.perf_counter()
    rk = sk.solve(params, Zb)
    _sync()
    wall_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    rr = sr.solve(params, Zb)
    _sync()
    wall_r = time.perf_counter() - t0
    scale = max(float(rr["Z"].U.abs().max()), 1.0)
    du = float((rk["Z"].U - rr["Z"].U).abs().max()) / scale
    status = rk["status"].cpu().numpy()
    launches = dict(backward_fused=sk._bwd.launches, forward=sk._fwd.launches, riccati=sr._ric.launches)
    same_status = bool(rk["status"].equal(rr["status"]))
    same_it = bool(rk["stats"].iterations_total.equal(rr["stats"].iterations_total))
    emit(dict(phase="triple_integrator_fleet", B=TRIPLE_FLEET_B, N=prob.N, dtype="f64", wall_s_kernels=wall_k,
              wall_s_riccati_fallback=wall_r, host_syncs=dict(kernels=sk.host_syncs, riccati_fallback=sr.host_syncs),
              launches_per_solve=launches, statuses_equal=same_status, iterations_equal=same_it,
              U_max_rel_diff=du, status_hist={int(c): int((status == c).sum()) for c in sorted(set(status.tolist()))},
              iters_max=int(rk["stats"].iterations_total.max())))
    assert same_status and same_it, "the kernels' solve and the Riccati fallback's differ"
    assert du <= TRIPLE_U_REL, f"U differs by {du:.3e} relative"
    assert bool(torch.isfinite(rk["Z"].U).all()) and launches["backward_fused"] > 0 and launches["forward"] > 0
    summary["launches_per_solve"] = launches
    return summary


def phase_live_rows(dev) -> None:
    """The main path (bench.make_solver's program, B=4096, f32) at
    `verbose=OUTER`: one fleet row per lockstep outer iteration of every
    solve inside it, each one more host sync, so the solve's syncs exceed
    the SILENT solver's first solve's (phase_main_path's; a first solve
    also reads the params for its kernels' preparation) by exactly the
    rows; its statuses and U equal the SILENT solve's bit for bit."""
    import contextlib
    import io

    from altro_tpu_torch import LogLevel

    ref = _main_reference(dev)
    _, prob, params, Zb = _main_fleet(dev)
    solver = bench_solver(prob, verbose=LogLevel.OUTER)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        res = solver.solve(params, Zb)
        _sync()
        wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    rows = [ln for ln in lines if ln.strip() and ln.strip()[0].isdigit()]
    same = _same_solve(res, ref["res"])
    emit(dict(phase="live_rows", rows=len(rows), host_syncs=solver.host_syncs,
              silent_host_syncs=ref["first_host_syncs"],
              wall_s=wall, silent_wall_s=ref["wall_s"], first=lines[:4], last=rows[-1:] if rows else None, **same))
    assert rows, "no row printed"
    assert solver.host_syncs == ref["first_host_syncs"] + len(rows), (
        solver.host_syncs, ref["first_host_syncs"], len(rows))
    assert same["statuses"] and same["U_bitwise"], same


MPC_B = 4096
MPC_CAP = 3  # iterations a tick, total and inner (perf/mpc_device_latency.py)
MPC_WARM = 2  # warm-up ticks at x0 before the closed loop
MPC_TICKS = 100  # x h = 0.03 s: the whole 3 s manoeuvre
MPC_BITWISE_TICKS = 5
MPC_TRACE_TICKS = 3  # closed-loop ticks traced for the device's idle share (10 took 20 s more on an H100's host)
MPC_F64_B = 256
MPC_F64_TICKS = 30
MPC_SINGLE_WARM = 11  # perf/mpc_device_latency.py:single's ticks before its chain
MPC_SINGLE_TICKS = 100
MPC_GOLDEN_F32 = os.path.join(ROOT, "tests", "goldens", "mpc_fleet_jax_f32.npz")
MPC_GOLDEN_F64 = os.path.join(ROOT, "tests", "goldens", "mpc_fleet_jax_f64.npz")


def _mpc_setup(dtype, dev, lanes, **opt_kw):
    """The MPC fleet's controller (perf/mpc_device_latency.py:fleet):
    turn-90 with constraints, at most MPC_CAP iterations a tick, the guess
    shifted each tick, on the fused kernels; x0 uniform in ±0.1 from
    default_rng(0) (the first `lanes` of MPC_B draws), the initial guess
    replicated, the plant the model's RK4 step over the batch.  Returns
    (definition, controller, first state, x0, plant)."""
    import torch

    from altro_tpu_torch import BatchedMPC, SolverOptions
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.models.unicycle import unicycle_rk4

    defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
    prob = defn.make_problem().compile()
    opts = SolverOptions(backward_pass="fused", forward_pass="cuda", max_iterations_total=MPC_CAP,
                         max_iterations_inner=MPC_CAP).replace(**opt_kw)
    mpc = BatchedMPC(prob, opts, shift=True)
    x0 = np.random.default_rng(0).uniform(-0.1, 0.1, size=(3, MPC_B))[:, :lanes]
    model = unicycle_rk4()
    plant = lambda x, u: model(x, u, 0.0, defn.h)  # noqa: E731
    return defn, mpc, mpc.init(fleet_trajectory(defn, lanes)), torch.as_tensor(x0, device=dev).to(dtype), plant


def _eager_guard(solver) -> dict:
    """Count calls of the batched solver's eager passes (expansions, the
    eager sweep, the eager rollouts): a tick on the kernels makes none."""
    calls = dict(expand=0, riccati_scan=0, rollout=0, closed_loop_rollout=0)
    for name in calls:
        fn = getattr(solver, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        setattr(solver, name, counted)
    return calls


def _mpc_f64_lanes(dev) -> dict:
    """The fleet's first MPC_F64_B lanes in float64 on the fused kernels'
    float64 instantiations: MPC_WARM warm-up ticks and MPC_F64_TICKS
    closed-loop ticks against the JAX package's (tests/goldens/
    mpc_fleet_jax_f64.npz), lane for lane: statuses and iterations equal at
    every tick, u0 and the final x within tolerances.MPC_F64_ATOL.  Where
    they part, the same ticks through the eager passes on the card (the
    kernels' plain versions) say which side rounding decides."""
    import torch

    from altro_tpu_torch.ops import tolerances as tol

    gold = np.load(MPC_GOLDEN_F64)

    def run(**opt_kw):
        _, mpc, state, x, plant = _mpc_setup(torch.float64, dev, MPC_F64_B, **opt_kw)
        status, iters, u0s = [], [], []
        for tick in range(MPC_WARM + MPC_F64_TICKS):
            u0, state = mpc.step(state, x)
            if tick >= MPC_WARM:
                x = plant(x, u0)
            status.append(state.status)
            iters.append(state.iterations)
            u0s.append(u0)
        return mpc, [torch.stack(t).cpu().numpy() for t in (status, iters, u0s)] + [x.cpu().numpy()]

    t0 = time.perf_counter()
    mpc, (status, iters, u0, xf) = run()
    _sync()
    wall = time.perf_counter() - t0
    bad = (status != gold["status"]) | (iters != gold["iterations"])
    du = np.abs(u0 - gold["u0"]).max(axis=1)  # [ticks, lanes]
    out = dict(lanes=MPC_F64_B, ticks=MPC_WARM + MPC_F64_TICKS, wall_s=wall, statuses_equal=bool(not bad.any()),
               u0_max_diff=float(du.max()), x_final_max_diff=float(np.abs(xf - gold["x_final"]).max()),
               launches=dict(backward_fused=mpc.solver._bwd.launches, forward=mpc.solver._fwd.launches),
               solved_last_tick=int((status[-1] == 0).sum()))
    parted = bad | (du > tol.MPC_F64_ATOL)
    if parted.any():
        ticks, lanes = np.nonzero(parted)
        first = [(int(t), int(ln)) for t, ln in zip(ticks, lanes) if t == ticks.min()]
        _, (e_status, e_iters, e_u0, _) = run(backward_pass="scan", forward_pass="scan")
        out["parted"] = dict(
            lanes=sorted(set(lanes.tolist())), first_tick=int(ticks.min()),
            first=[dict(lane=ln, card=[int(status[t, ln]), int(iters[t, ln])],
                        jax=[int(gold["status"][t, ln]), int(gold["iterations"][t, ln])],
                        eager=[int(e_status[t, ln]), int(e_iters[t, ln])],
                        u0_diff=float(du[t, ln]), eager_u0_diff=float(np.abs(e_u0[t, :, ln] - gold["u0"][t, :, ln]).max()))
                   for t, ln in first[:8]])
    return out


def _mpc_idle_share(mpc, state, x0, plant) -> dict:
    """The device's idle share over the first MPC_TRACE_TICKS closed-loop
    ticks from the warm state: their untraced wall, then the same ticks
    traced with torch.profiler (CUDA activities only), whose device events
    (kernels, copies, sets) add up to the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    t0 = time.perf_counter()
    mpc.rollout_ticks(state, x0, plant, MPC_TRACE_TICKS)
    _sync()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mpc.rollout_ticks(state, x0, plant, MPC_TRACE_TICKS)
        _sync()
    rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    device_s = sum(dev_us(e) for e in rows) / 1e6
    assert device_s > 0, "the MPC fleet's trace holds no device time"
    return dict(ticks=MPC_TRACE_TICKS, wall_s=wall, device_s=device_s, device_idle_share=1.0 - device_s / wall,
                device_events=sum(e.count for e in rows))


def phase_mpc_fleet(dev) -> dict:
    """The 4,096-controller MPC fleet (perf/mpc_device_latency.py:fleet) on
    the fused kernels, float32: two warm-up ticks at x0, then
    `rollout_ticks` for MPC_TICKS ticks with every count set to 0 just
    before it.  Checks: both kernels launch on every tick and no tick runs
    an eager pass; from the warm state, MPC_BITWISE_TICKS ticks of
    `rollout_ticks` equal as many `step` calls plus the plant bit for bit;
    the closed loop against the JAX package's on its fused Pallas kernels
    (tests/goldens/mpc_fleet_jax_f32.npz) within the bounds of
    ops/tolerances.py; the
    first 256 lanes in float64, lane for lane (_mpc_f64_lanes).  Returns
    each kernel's launches per tick."""
    import torch

    from altro_tpu_torch import SolverStatus
    from altro_tpu_torch.ops import tolerances as tol

    defn, mpc, state, x0, plant = _mpc_setup(torch.float32, dev, MPC_B)
    solver = mpc.solver
    bwd, fwd = solver._bwd, solver._fwd
    assert bwd is not None and fwd is not None, "the MPC fleet did not select the CUDA kernels"
    eager = _eager_guard(solver)
    t0 = time.perf_counter()
    for _ in range(MPC_WARM):
        _, state = mpc.step(state, x0)
    _sync()
    warm_s = time.perf_counter() - t0

    # rollout_ticks against a loop of step + plant, from the same warm state
    st_r, x_r, X_r, U_r = mpc.rollout_ticks(state, x0, plant, MPC_BITWISE_TICKS)
    s, x, Us = state, x0, []
    for _ in range(MPC_BITWISE_TICKS):
        u, s = mpc.step(s, x)
        x = plant(x, u)
        Us.append(u)
    same = dict(
        U_hist=bitwise([U_r], [torch.stack(Us)]), x_final=bitwise([x_r], [x]), status=bool(st_r.status.equal(s.status)),
        al=bitwise([t for st in st_r.al for t in (st["lam"], st["rho"])], [t for st in s.al for t in (st["lam"], st["rho"])]),
    )

    # launch preparation of a tick's new params object (x0 replaced)
    desc = bwd._desc
    t0 = time.perf_counter()
    for _ in range(100):
        bwd._prepare(mpc.prob.params.replace(x0=x0), MPC_B)
    prepare_us = (time.perf_counter() - t0) * 1e4

    marks = []

    def plant_marked(x, u):  # called once a tick, after the tick's solve
        marks.append((bwd.launches, fwd.launches))
        return plant(x, u)

    bwd.launches = fwd.launches = 0
    _sync()
    t0 = time.perf_counter()
    st, xf, X, U = mpc.rollout_ticks(state, x0, plant_marked, MPC_TICKS)
    _sync()
    wall = time.perf_counter() - t0
    syncs = mpc.host_syncs
    launches = dict(backward_fused=bwd.launches, forward=fwd.launches)
    per_tick = np.diff(np.asarray([(0, 0)] + marks), axis=0)  # [ticks, 2]
    status = st.status.cpu().numpy()
    xf_np = xf.cpu().numpy()
    dist = np.linalg.norm(xf_np[:2] - defn.xf[:2, None], axis=0)
    idle = _mpc_idle_share(mpc, state, x0, plant)

    gold = np.load(MPC_GOLDEN_F32)
    solved_jax = float(gold["status_counts"][-1][int(SolverStatus.SOLVED)]) / MPC_B
    dist_jax = np.linalg.norm(gold["x_final"][:2].astype(np.float64) - defn.xf[:2, None], axis=0)
    x_med = float(np.median(np.abs(xf_np - gold["x_final"]).max(axis=0)))
    solved = float((status == int(SolverStatus.SOLVED)).mean())
    f64 = _mpc_f64_lanes(dev)
    hist = {SolverStatus(int(c)).name: int((status == c).sum()) for c in sorted(set(status.tolist()))}
    out = dict(
        phase="mpc_fleet", B=MPC_B, N=N, dtype="f32", cap=MPC_CAP, ticks=MPC_TICKS, warmup_s=warm_s, wall_s=wall,
        ms_per_tick=wall * 1e3 / MPC_TICKS, controller_steps_per_s=MPC_B * MPC_TICKS / wall,
        host_syncs=syncs, host_syncs_per_tick=syncs / MPC_TICKS,
        launches=launches, launches_per_tick=dict(backward_fused=launches["backward_fused"] / MPC_TICKS,
                                                  forward=launches["forward"] / MPC_TICKS),
        launches_per_tick_min=per_tick.min(axis=0).tolist(), eager_calls=eager,
        prepare_us_per_new_params=prepare_us, descriptor_rebuilt=bwd._desc is not desc,
        status_last_tick=hist, solved_frac=solved, solved_frac_jax=solved_jax,
        goal_dist_p50=float(np.percentile(dist, 50)), goal_dist_p99=float(np.percentile(dist, 99)),
        goal_dist_p99_jax=float(np.percentile(dist_jax, 99)), x_final_median_diff=x_med,
        rollout_equals_steps=same, f64=f64, traced=idle,
    )
    emit(out)
    assert tuple(U.shape) == (MPC_TICKS, 2, MPC_B) and tuple(X.shape) == (MPC_TICKS, 3, MPC_B)
    assert bool(torch.isfinite(U).all()) and bool(torch.isfinite(X).all()), "non-finite closed loop"
    assert (per_tick > 0).all(), "a tick launched no fused kernel"
    assert not any(eager.values()), f"a tick ran the eager passes: {eager}"
    assert all(same.values()), f"rollout_ticks differs from step: {same}"
    assert abs(solved - solved_jax) * 100 <= tol.MPC_SOLVED_POINTS, (solved, solved_jax)
    assert abs(out["goal_dist_p99"] - out["goal_dist_p99_jax"]) <= tol.MPC_GOAL_P99_M, out["goal_dist_p99"]
    assert x_med <= tol.MPC_X_MEDIAN, x_med
    assert f64["statuses_equal"] and "parted" not in f64, f"float64 lanes parted from the JAX package: {f64}"
    assert f64["x_final_max_diff"] <= tol.MPC_F64_ATOL, f64
    return dict(backward_fused=launches["backward_fused"] / MPC_TICKS, forward=launches["forward"] / MPC_TICKS)


SHARD_WORLD = 2  # gloo ranks that share the one card in the sharded phase
SHARD_TIMEOUT_S = 180  # each rank's start, warm-up and timed solve
SHARD_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce",
                     "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "send", "recv", "barrier",
                     "gather", "scatter")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _count_collectives() -> dict:
    """Wrap every collective of torch.distributed with a counter of its
    calls ({name: calls}), to show what a solve issued."""
    import torch.distributed as dist

    calls = {}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name in SHARD_COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, wrap(name, getattr(dist, name)))
    return calls


def _sharded_rank(rank: int, port: int, pkg: str, conn, parent: int) -> None:
    """One gloo rank of the sharded phase, spawned, on cuda:0:
    `ShardedBatchedALSolver` with the bench options on its half of the main
    path's fleet.  It solves once (warm-up), says "ready" on `conn`, waits
    for "go" so that both ranks time their solve together and alone on the
    card, solves again with its kernels' counts and the collectives' counter
    at 0, and sends its lanes, folds, wall, syncs, launches and
    collectives (or the traceback)."""
    _die_with_parent(parent)
    try:
        sys.path.insert(0, pkg)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import datetime

        import torch
        import torch.distributed as dist

        from altro_tpu_torch import SolverOptions
        from altro_tpu_torch.parallel.mesh import ShardedBatchedALSolver, init_distributed, make_mesh

        dev = torch.device("cuda", 0)
        mesh = init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=SHARD_WORLD,
                                rank=rank, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            calls = _count_collectives()
            _, prob, params, Zb = _main_fleet(dev)
            s = ShardedBatchedALSolver(prob, mesh, SolverOptions(**BENCH_OPT_KW))
            kerns = (s.solver._bwd, s.solver._fwd)
            assert all(k is not None for k in kerns), "a rank did not select the CUDA kernels"
            p_l, Z_l = s.shard_params(params), s.shard_batch(Zb)
            assert p_l.x0.device == dev and Z_l.X.device == dev, "a rank's slice is not on the card"
            s.solve(p_l, Z_l)
            _sync()
            conn.send(("ready", rank))
            assert conn.recv() == "go"
            for k in kerns:
                k.launches = 0
            calls.clear()
            t0 = time.perf_counter()
            res, viol, solved, stalled = s.solve(p_l, Z_l)
            _sync()
            wall = time.perf_counter() - t0
            r = dict(
                ok=True, wall_s=wall, host_syncs=s.solver.host_syncs, lanes=int(res["status"].shape[0]),
                devices=sorted({str(t.device) for t in (res["Z"].U, res["status"], viol, solved)}),
                launches=dict(backward_fused=kerns[0].launches, forward=kerns[1].launches),
                status=res["status"].cpu().numpy(), iterations=res["stats"].iterations_total.cpu().numpy(),
                U=res["Z"].U.cpu().numpy(), folds=(float(viol), int(solved), int(stalled)),
                collectives=list(s.collectives), calls=dict(calls),
            )
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the parent reports it and fails the phase
        r = dict(ok=False, error=traceback.format_exc())
    try:
        conn.send(("result", r))
    except BrokenPipeError:  # the parent stopped listening: it has failed already
        pass
    conn.close()


def _receive(conns, kind: str) -> list:
    """One (kind, value) message from each rank, in rank order, within
    SHARD_TIMEOUT_S; a rank that died or failed fails the phase."""
    from multiprocessing.connection import wait

    got, t0 = {}, time.perf_counter()
    while len(got) < len(conns):
        left = SHARD_TIMEOUT_S - (time.perf_counter() - t0)
        ready = wait([c for i, c in enumerate(conns) if i not in got], timeout=max(1.0, left))
        assert ready, f"no word from {len(conns) - len(got)} sharded rank(s) within {SHARD_TIMEOUT_S} s"
        for c in ready:
            try:
                k, v = c.recv()
            except EOFError:
                raise AssertionError("a sharded rank's process died") from None
            if k == "result":
                assert v["ok"], f"sharded rank {conns.index(c)}:\n{v['error']}"
            assert k == kind, (k, kind)
            got[conns.index(c)] = v
    return [got[i] for i in range(len(conns))]


def phase_sharded(dev) -> dict:
    """The multi-device layer on the main path's fleet (B=4096, N=100, f32,
    the bench options, both fused kernels), through `ALSolverBatched` with
    no compaction, whose lanes the sharded solvers split:
      1. a world of one rank over NCCL in this process:
         `ShardedBatchedALSolver` bit for bit with the unsharded solve, its
         folds the solve's max violation and counts, on the mesh over every
         rank (`make_mesh()`) and on `make_mesh([0])` alike;
      2. two gloo ranks on cuda:0 in processes of their own (NCCL takes
         one rank per GPU; gloo reduces CUDA tensors), 2,048 lanes each:
         statuses, iterations and U bit for bit with the unsharded solve's
         lanes, the folds equal to its, three one-element all_reduces per
         solve and no other collective; each rank's wall for one solve
         after a warm-up (both at once), host syncs and kernel launches;
      3. `BatchedALSolver` (batch-leading) bit for bit with the unsharded
         solve once the layout is moved back;
      4. bench.make_solver's program with the host-driven tail
         (`device_tail=False`) lane for lane bit for bit with its device
         program (the main path's solve).
    The ranks start first and warm up while this process runs 1, 3 and 4
    and times the unsharded solve after a warm-up, as each rank times its
    own (wall, host syncs, launches).  Returns each fused kernel's
    launches on each rank's timed solve."""
    import datetime
    import multiprocessing as mp

    import torch
    import torch.distributed as dist

    import altro_tpu_torch
    from altro_tpu_torch import SolverOptions, SolverStatus, Trajectory
    from altro_tpu_torch.parallel.batch import BatchedALSolver
    from altro_tpu_torch.parallel.mesh import ShardedBatchedALSolver, init_distributed, make_mesh
    from altro_tpu_torch.solver.batched import ALSolverBatched

    ctx = mp.get_context("spawn")
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(altro_tpu_torch.__file__)))
    port = _free_port()
    procs, conns = [], []
    try:
        for rank in range(SHARD_WORLD):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=_sharded_rank, args=(rank, port, pkg, theirs, os.getpid()))
            p.start()
            theirs.close()  # the child's end: a child that dies unheard reads as EOF here
            procs.append(p)
            conns.append(mine)

        _, prob, params, Zb = _main_fleet(dev)
        opts = SolverOptions(**BENCH_OPT_KW)
        unsharded = ALSolverBatched(prob, opts)
        unsharded.solve(params, Zb)  # warm-up, as the ranks have one
        for k in (unsharded._bwd, unsharded._fwd):
            k.launches = 0
        t0 = time.perf_counter()
        ref = unsharded.solve(params, Zb)
        _sync()
        ref_run = dict(wall_s=time.perf_counter() - t0, host_syncs=unsharded.host_syncs,
                       launches=dict(backward_fused=unsharded._bwd.launches, forward=unsharded._fwd.launches))
        status = ref["status"]
        folds_ref = (float(ref["stats"].violations.max()), int((status == int(SolverStatus.SOLVED)).sum()),
                     int((status == int(SolverStatus.SOLVED_STALLED)).sum()))

        mesh = init_distributed(backend="nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            s1 = ShardedBatchedALSolver(prob, mesh, opts)
            res1, *folds1 = s1.solve(s1.shard_params(params), s1.shard_batch(Zb))
            nccl = dict(_same_solve(res1, ref), folds=[float(folds1[0]), int(folds1[1]), int(folds1[2])],
                        collectives=list(s1.collectives), mesh=[mesh.size(), list(mesh.mesh_dim_names)],
                        device=str(folds1[0].device))
            # the same world on a mesh over the rank list [0] (the JAX call form)
            s0 = ShardedBatchedALSolver(prob, make_mesh([0]), opts)
            res0, *folds0 = s0.solve(s0.shard_params(params), s0.shard_batch(Zb))
            nccl["listed_mesh"] = dict(_same_solve(res0, res1), folds=[float(folds0[0]), int(folds0[1]),
                                                                       int(folds0[2])])
        finally:
            dist.destroy_process_group()

        Zl = Trajectory(X=Zb.X.movedim(-1, 0), U=Zb.U.movedim(-1, 0), t=Zb.t.expand(B_FLEET, -1),
                        h=Zb.h.expand(B_FLEET, -1))
        rb = BatchedALSolver(prob, opts).solve(params.replace(x0=params.x0.T), Zl)
        batched = dict(statuses=bool(rb.status.equal(status)),
                       iterations=bool(rb.stats.iterations_total.equal(ref["stats"].iterations_total)),
                       U_bitwise=bitwise([rb.Z.U], [ref["Z"].U.movedim(-1, 0).contiguous()]))

        main = _main_reference(dev)["res"]
        host = bench_solver(prob, device_tail=False)
        t0 = time.perf_counter()
        rh = host.solve(params, Zb)
        _sync()
        host_tail = dict(_same_solve(rh, main), wall_s=time.perf_counter() - t0, host_syncs=host.host_syncs,
                         tail_rounds=host.telemetry["tail_rounds"], polish=host.telemetry.get("polish"))

        _receive(conns, "ready")
        for c in conns:
            c.send("go")
        ranks = _receive(conns, "result")
    finally:
        for c in conns:
            c.close()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        _stop_resource_tracker()

    W = B_FLEET // SHARD_WORLD
    U_ref, st_ref, it_ref = ref["Z"].U.cpu().numpy(), status.cpu().numpy(), ref["stats"].iterations_total.cpu().numpy()
    per_rank = []
    for r, out in enumerate(ranks):
        lanes = slice(r * W, (r + 1) * W)
        per_rank.append(dict(
            lanes=out["lanes"], devices=out["devices"], wall_s=out["wall_s"], host_syncs=out["host_syncs"],
            launches=out["launches"], folds=list(out["folds"]), collectives=out["collectives"],
            collective_bytes=sum(c[2] for c in out["collectives"]), calls=out["calls"],
            statuses=bool(np.array_equal(out["status"], st_ref[lanes])),
            iterations=bool(np.array_equal(out["iterations"], it_ref[lanes])),
            U_bitwise=bool(np.array_equal(out["U"].view(np.uint32), U_ref[..., lanes].view(np.uint32))),
        ))
    emit(dict(phase="sharded", B=B_FLEET, N=N, dtype="f32", world=SHARD_WORLD, unsharded=ref_run,
              folds_unsharded=list(folds_ref), nccl_world_of_one=nccl, per_rank=per_rank,
              batched_al_solver=batched, host_tail=host_tail))
    assert all(nccl[k] for k in ("statuses", "iterations", "U_bitwise")), f"NCCL world of one: {nccl}"
    assert nccl["folds"] == list(folds_ref) and len(nccl["collectives"]) == 3 and nccl["device"] == "cuda:0", nccl
    listed = nccl["listed_mesh"]
    assert all(listed[k] for k in ("statuses", "iterations", "U_bitwise")) and listed["folds"] == nccl["folds"], (
        f"make_mesh([0]) parted from make_mesh(): {listed}")
    for r, pr in enumerate(per_rank):
        assert pr["devices"] == ["cuda:0"] and pr["lanes"] == W, pr
        assert pr["statuses"] and pr["iterations"] and pr["U_bitwise"], f"rank {r} parted from the unsharded lanes"
        assert pr["folds"] == list(folds_ref), (pr["folds"], folds_ref)
        assert [c[:2] for c in pr["collectives"]] == [("all_reduce_max", 1), ("all_reduce_sum", 1),
                                                      ("all_reduce_sum", 1)], pr["collectives"]
        assert pr["calls"] == {"all_reduce": 3}, pr["calls"]
        assert pr["launches"]["backward_fused"] > 0 and pr["launches"]["forward"] > 0, pr["launches"]
    assert all(batched.values()), f"BatchedALSolver parted from ALSolverBatched: {batched}"
    assert all(host_tail[k] for k in ("statuses", "iterations", "alpha", "U_bitwise", "cost_bitwise")), (
        f"the host-driven tail parted from the device program: {host_tail}")
    return [pr["launches"] for pr in per_rank]


def phase_per_instance(dev) -> None:
    """The per-instance solver and controller on the card (plain tensor
    code: the JAX package's per-instance path reaches no Pallas kernel).
    Untimed; in the full run it runs in this process while run_plain's
    processes run.
      1. ALSolver, float64, turn-90 at ctol 1e-6: SOLVED, 14 / 5
         iterations, J within 1e-9 of GOLDEN_J (auglag_test.cpp:325-351);
      2. the same solve at verbose=OUTER: its rows, and U bit for bit
         with 1;
      3. ILQRSolver on the unconstrained turn-90: the goldens of
         tests/test_ilqr.py::TestUnicycle;
      4. MPC against BatchedMPC's lane 0 (B=4 on the fused kernels),
         float64, 3 ticks from zero (tests/test_batched_mpc.py:65-78): u0
         within tolerances.MPC_F64_ATOL.
    The single controller's ticks run in a process of their own
    (mpc_single_solve).  Prints each solve's host syncs."""
    import contextlib
    import io

    import torch

    from altro_tpu_torch import MPC, ALSolver, BatchedMPC, ILQRSolver, LogLevel, SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.ops import tolerances as tol

    f64 = torch.float64
    defn = UnicycleProblem(dtype=f64, device=dev, N=N)
    prob = defn.make_problem().compile()
    out = dict(phase="per_instance")

    s = ALSolver(prob, SolverOptions(constraint_tolerance=1e-6))
    t0 = time.perf_counter()
    res = s.solve(prob.params, defn.initial_trajectory())
    _sync()
    J = float(s.fns.total_cost(prob.params, res.al, res.Z))
    out["golden"] = dict(wall_s=time.perf_counter() - t0, host_syncs=s.host_syncs, status=int(res.status),
                         iterations=[res.stats.iterations_total, res.stats.iterations_outer], J_diff=J - GOLDEN_J)

    si = ALSolver(prob, SolverOptions(constraint_tolerance=1e-6, verbose=LogLevel.OUTER))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        res_i = si.solve(prob.params, defn.initial_trajectory())
        _sync()
    rows = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    out["verbose"] = dict(wall_s=time.perf_counter() - t0, host_syncs=si.host_syncs, rows=rows,
                               U_bitwise=bitwise([res_i.Z.U], [res.Z.U]),
                               iterations=[res_i.stats.iterations_total, res_i.stats.iterations_outer])

    uprob = defn.make_problem(add_constraints=False).compile()
    il = ILQRSolver(uprob, SolverOptions())
    Z = il.rollout(uprob.params, defn.initial_trajectory())
    J_init = float(il.fns.total_cost(uprob.params, (), Z))
    exp = il.expansions(uprob.params, (), Z)
    bp = il.backward_pass(exp)
    fp = il.forward_pass(uprob.params, (), Z, bp, exp.costs.sum())
    t0 = time.perf_counter()
    ires = il.solve(uprob.params, (), defn.initial_trajectory())
    _sync()
    out["ilqr"] = dict(wall_s=time.perf_counter() - t0, host_syncs=il.host_syncs, status=int(ires.status),
                       iterations=ires.stats.iterations_inner,
                       J=float(il.fns.total_cost(uprob.params, (), ires.Z)), J_init=J_init,
                       p0=bp.p[0].tolist(), d0=bp.d[0].tolist(), alpha=float(fp.alpha))

    fleet = BatchedMPC(prob, SolverOptions(backward_pass="fused", forward_pass="cuda"))
    single = MPC(prob, SolverOptions())
    assert fleet.solver._bwd is not None and fleet.solver._fwd is not None
    sf, ss = fleet.init(fleet_trajectory(defn, 4)), single.init(defn.initial_trajectory())
    du, syncs_single = [], []
    t0 = time.perf_counter()
    for _ in range(3):
        uB, sf = fleet.step(sf, torch.zeros((3, 4), dtype=f64, device=dev))
        u1, ss = single.step(ss, torch.zeros(3, dtype=f64, device=dev))
        du.append(float((uB[:, 0] - u1).abs().max()))
        syncs_single.append(single.host_syncs)
    out["mpc_vs_fleet_lane0"] = dict(wall_s=time.perf_counter() - t0, u0_max_diff=max(du),
                                     host_syncs_per_tick=syncs_single, fleet_launches=fleet.solver._bwd.launches)

    emit(out)
    g, ins, il_out = out["golden"], out["verbose"], out["ilqr"]
    assert g["status"] == int(SolverStatus.SOLVED) and g["iterations"] == [14, 5], g
    assert abs(g["J_diff"]) <= 1e-9, g
    assert ins["U_bitwise"] and ins["iterations"] == g["iterations"] and len(rows) > 5, ins
    # tests/test_ilqr.py::TestUnicycle (unicycle_ilqr_test.cpp:36-100)
    assert il_out["status"] == int(SolverStatus.SOLVED) and il_out["iterations"] == 9, il_out
    assert abs(il_out["J"] - 0.0387016567) <= 1e-5 and abs(J_init - 259.27636137767087) <= 1e-5, il_out
    np.testing.assert_allclose(il_out["p0"], [0.024904637422419617, -0.46496022574032614, -0.0573096310550007],
                               atol=1e-5)
    np.testing.assert_allclose(il_out["d0"], [-2.565783457444465, 5.514158930898376], atol=1e-5 * 5.5)
    assert il_out["alpha"] == 0.0625, il_out
    assert max(du) <= tol.MPC_F64_ATOL, du


def mpc_single_solve() -> dict:
    """perf/mpc_device_latency.py:single on the card, in a process of its
    own (run_plain): the per-instance controller, float32, at most MPC_CAP
    iterations a tick, MPC_SINGLE_WARM ticks at x0 = 0, then
    MPC_SINGLE_TICKS ticks of rollout_ticks.  Its ms and host syncs a tick
    and the final goal xy distance."""
    import torch

    from altro_tpu_torch import MPC, SolverOptions
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.models.unicycle import unicycle_rk4

    dev = torch.device("cuda", 0)
    d32 = UnicycleProblem(dtype=torch.float32, device=dev, N=N)
    mpc = MPC(d32.make_problem().compile(), SolverOptions(max_iterations_total=MPC_CAP,
                                                          max_iterations_inner=MPC_CAP))
    model = unicycle_rk4()
    state = mpc.init(d32.initial_trajectory())
    x = torch.zeros(3, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for _ in range(MPC_SINGLE_WARM):
        _, state = mpc.step(state, x)
    _sync()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _, X, _ = mpc.rollout_ticks(state, x, lambda x, u: model(x, u, 0.0, d32.h), MPC_SINGLE_TICKS)
    _sync()
    wall = time.perf_counter() - t0
    dist = float(np.linalg.norm(X[-1].cpu().numpy()[:2] - d32.xf[:2]))
    return dict(warm_ticks=MPC_SINGLE_WARM, warm_s=warm, ticks=MPC_SINGLE_TICKS, wall_s=wall,
                ms_per_tick=wall * 1e3 / MPC_SINGLE_TICKS, host_syncs_per_tick=mpc.host_syncs / MPC_SINGLE_TICKS,
                goal_dist=dist, status_last_tick=int(state.status), finite=bool(torch.isfinite(X).all()))


def single_part(dev):
    """The single controller's part of the plain stage: one process
    running mpc_single_solve; its check holds the final goal xy distance
    within tolerances.SINGLE_GOAL_M of the JAX package's
    (tests/goldens/mpc_fleet_jax_f32.npz)."""
    from altro_tpu_torch.ops import tolerances as tol

    def check(results, stage_wall):
        out = dict(results["single"], phase="mpc_single", stage_wall_s=stage_wall,
                   goal_dist_jax=float(np.load(MPC_GOLDEN_F32)["single_goal_dist"]))
        out.pop("ok")
        emit(out)
        assert out["finite"], "non-finite closed loop"
        assert abs(out["goal_dist"] - out["goal_dist_jax"]) <= tol.SINGLE_GOAL_M, out
        return out

    return "single", [("single", mpc_single_solve, ())], check


def phase_mpc_single(dev) -> dict:
    """The single controller alone, in a process of its own (in the full
    run it is part of the plain stage)."""
    return run_plain([single_part(dev)])["single"]


def _general_problems(dev):
    """The three general problems of phase_general at GENERAL_N, float64,
    with x0 drawn from seed 0 as their tests draw it: (name, compiled
    problem, params, initial trajectory)."""
    import torch

    from altro_tpu_torch.models.problems import damping_schedule, hybrid_triple_integrator, soc_unicycle
    from altro_tpu_torch.types import initial_trajectory

    f64, B = torch.float64, GENERAL_B
    out = []
    defn, prob = soc_unicycle(GENERAL_N, device=dev)
    x0 = np.random.default_rng(0).uniform(-0.2, 0.2, (3, B))  # tests/test_batched_soc.py:82
    out.append(("soc_unicycle", prob, prob.params.replace(x0=torch.as_tensor(x0, device=dev)),
                defn.initial_trajectory()))
    for name, build in (("hybrid", hybrid_triple_integrator), ("per_instance_schedule", damping_schedule)):
        prob, x00, _ = build(2, GENERAL_N, device=dev)
        rng = np.random.default_rng(0)  # tests/test_batched_heterogeneous.py:64-75
        params = prob.params.replace(x0=torch.as_tensor(x00[:, None] + rng.uniform(-0.2, 0.2, (6, B)), device=dev))
        if name == "per_instance_schedule":  # tests/test_batched_heterogeneous.py:141-145
            c = prob.params.dynamics[0]["c"]
            scale = torch.as_tensor(rng.uniform(0.8, 1.2, (GENERAL_N, B)), device=dev)
            params = params.replace(dynamics=(dict(c=c[:, None] * scale),))
        out.append((name, prob, params, initial_trajectory(6, 2, GENERAL_N, 0.1, dtype=f64, device=dev)))
    return out


def phase_general(dev) -> None:
    """The problems no fused kernel takes, B=GENERAL_B, float64: the
    velocity-cone unicycle (a second-order cone, N=40), the hybrid
    triple-integrator / damped system at dof 2 (two dynamics families) and
    the damping schedule at dof 2 with per-knot params per lane.  Each
    solved twice on the card: with backward_pass="fused" and
    forward_pass="cuda", which route the backward pass to the Riccati
    kernel (its launch count > 0) and the forward pass to the eager
    rollout, and with the eager passes: statuses and iterations equal, U
    within GENERAL_U_REL of max(|U|, 1), at least GENERAL_SOLVED_MIN
    SOLVED.  Run in the parent while run_plain's processes run."""
    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.solver.batched import ALSolverBatched

    for name, prob, params, Z0 in _general_problems(dev):
        Zb = replicate(Z0, GENERAL_B)
        sk = ALSolverBatched(prob, SolverOptions(backward_pass="fused", forward_pass="cuda"))
        se = ALSolverBatched(prob, SolverOptions())
        assert sk._bwd is None and sk._fwd is None and sk._ric is not None, f"{name}: not on the fallback"
        t0 = time.perf_counter()
        rk = sk.solve(params, Zb)
        _sync()
        wall_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        re_ = se.solve(params, Zb)
        _sync()
        wall_e = time.perf_counter() - t0
        scale = max(float(re_["Z"].U.abs().max()), 1.0)
        du = float((rk["Z"].U - re_["Z"].U).abs().max()) / scale
        status = rk["status"].cpu().numpy()
        solved = float((status == int(SolverStatus.SOLVED)).mean())
        same_status = bool(rk["status"].equal(re_["status"]))
        same_it = bool(rk["stats"].iterations_total.equal(re_["stats"].iterations_total))
        emit(dict(phase="general", problem=name, B=GENERAL_B, N=prob.N, n=prob.n, m=prob.m, dtype="f64",
                  riccati_launches=sk._ric.launches, wall_s_riccati=wall_k, wall_s_eager=wall_e,
                  host_syncs=sk.host_syncs, statuses_equal=same_status, iterations_equal=same_it,
                  U_max_rel_diff=du, solved_frac=solved, iters_max=int(rk["stats"].iterations_total.max())))
        assert sk._ric.launches > 0, f"{name}: the Riccati kernel never ran"
        assert same_status and same_it, f"{name}: the Riccati path and the eager path differ"
        assert du <= GENERAL_U_REL, f"{name}: U differs by {du:.3e} relative"
        assert solved >= GENERAL_SOLVED_MIN, f"{name}: {solved:.4f} SOLVED"


def scaling_fleet(name, B, dev, dtype=None):
    """The problem (f32 unless `dtype` says otherwise), fleet trajectory
    (rolled out from the instance's own start) and warm AL state of one
    fused-kernel instance at B lanes: parking N=100 (x0 in ±0.1), or the
    zoo's quadrotor N=50 or cartpole N=60 (x0 spread 0.05)."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import UnicycleProblem, zoo_cartpole, zoo_quadrotor
    from altro_tpu_torch.solver.batched import ALSolverBatched

    dtype = dtype or torch.float32
    rng = np.random.default_rng(0)
    if name == "parking":
        defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
        prob, Z0 = defn.make_problem().compile(), defn.initial_trajectory()
        x0s = torch.as_tensor(rng.uniform(-0.1, 0.1, (3, B)), device=dev).to(dtype)
    else:
        prob, Z0, x0, _ = (zoo_quadrotor if name == "quadrotor" else zoo_cartpole)(dtype=dtype, device=dev)
        x0s = zoo_x0s(x0, B, rng).to(dtype)
    ev = ALSolverBatched(prob, SolverOptions())
    params = prob.params.replace(x0=x0s)
    return prob, params, ev.rollout(params, replicate(Z0, B)), warm_al(ev, B, dtype, dev, rng)


def phase_kernel_scaling(dev) -> None:
    """Each kernel instance in f32 against the batch width, timed with CUDA
    events (median of SCALING_REPS launches).  The fused kernels at parking
    (N=100), cartpole (N=60) and quadrotor (N=50), B in SCALING_B: the
    backward kernel at the instance's largest f32 ρ, the forward kernel
    rolling out the gains it returned with α = 1, and once more with
    `chain_only` (its inputs replayed from shared memory: the time of the
    rollout's chain alone, the floor of its design).  The Riccati kernel
    at each of its instances (riccati_fleet: parking, cartpole, quadrotor,
    triple integrator) over the eager expansions, at ρ = 1e3, where no lane
    fails (its time does not depend on ρ).  Per launch: ms (CUDA events
    around the wrapper's call, the host's preparation of the launch
    included), device ms (the kernel alone, `device_ms`), the bound and the
    grid the wrapper launches.  A time flat in B is a latency-bound chain;
    one that grows with B has filled the card."""
    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
    from altro_tpu_torch.ops.forward import ForwardKernel

    for name in ("parking", "cartpole", "quadrotor"):
        for B in SCALING_B:
            prob, params, Zb, al = scaling_fleet(name, B, dev)
            bk = BackwardFusedKernel(prob, SolverOptions(), dtype=torch.float32, device=dev)
            fk = ForwardKernel(prob, SolverOptions(), dtype=torch.float32, device=dev)
            ap = bk.pad_al(al)
            rho = torch.full((B,), tol.RHOS["f32"][name][-1], dtype=torch.float32, device=dev)
            a1 = torch.ones((B,), dtype=torch.float32, device=dev)
            K, d = bk(params, ap, Zb, rho)[:2]
            ms_b = cuda_ms(lambda: bk(params, ap, Zb, rho), SCALING_REPS)
            dev_b = device_ms(lambda: bk(params, ap, Zb, rho), SCALING_REPS, "backward_fused_kernel")
            ms_f = cuda_ms(lambda: fk(params, ap, Zb, K, d, a1), SCALING_REPS)
            dev_f = device_ms(lambda: fk(params, ap, Zb, K, d, a1), SCALING_REPS, "forward_kernel")
            ms_chain = cuda_ms(lambda: fk(params, ap, Zb, K, d, a1, chain_only=True), SCALING_REPS)
            dev_chain = device_ms(lambda: fk(params, ap, Zb, K, d, a1, chain_only=True), SCALING_REPS,
                                  "forward_kernel")
            gb, gf = bk.geometry(B, params), fk.geometry(B, params)
            emit(dict(
                phase="kernel_scaling", problem=name, N=prob.N, B=B,
                backward_bound=bound(*fused_work(bk, B, 4), "f32"),
                forward_bound=bound(*forward_work(fk, B, 4), "f32"),
                backward_ms=ms_b, backward_device_ms=dev_b, backward_us_per_knot=ms_b * 1e3 / prob.N,
                backward_blocks=gb.blocks, backward_threads=gb.threads, backward_smem=gb.smem,
                forward_ms=ms_f, forward_device_ms=dev_f, forward_us_per_knot=ms_f * 1e3 / prob.N,
                forward_chain_ms=ms_chain, forward_chain_device_ms=dev_chain, forward_blocks=gf.blocks,
                forward_threads=gf.threads, forward_smem=gf.smem,
            ))
    riccati_scaling(dev)


def riccati_scaling(dev) -> None:
    """The Riccati kernel's part of kernel_scaling (see there)."""
    import torch

    from altro_tpu_torch.ops.riccati import RiccatiKernel

    for name in ("parking", "cartpole", "quadrotor", "triple"):
        for B in SCALING_B:
            rng = np.random.default_rng(0)
            prob, Z0, x0s = riccati_fleet(name, B, torch.float32, dev, rng)
            exp = riccati_inputs(prob, Z0, x0s, torch.float32, dev, rng)
            Nk, n, m = prob.N, prob.n, prob.m
            kern = RiccatiKernel(n, m, dtype=torch.float32)
            rho = torch.full((B,), 1e3, dtype=torch.float32, device=dev)
            ms = cuda_ms(lambda: kern(exp, rho), SCALING_REPS)
            dms = device_ms(lambda: kern(exp, rho), SCALING_REPS, "riccati_kernel")
            # a checkout from before the kernel took its geometry from the
            # wrapper (--package-root) launched ceil(B/128) blocks of 128
            geo = kern.geometry(B) if hasattr(kern, "geometry") else None
            emit(dict(
                phase="kernel_scaling", kernel="riccati", problem=name, n=n, m=m, N=Nk, B=B,
                ms=ms, device_ms=dms, us_per_knot=ms * 1e3 / Nk,
                bound=bound(*riccati_work(Nk, n, m, B, 4), "f32"),
                blocks=geo.blocks if geo else -(-B // 128), threads=geo.threads if geo else 128,
                knots=geo.knots if geo else None, smem=geo.smem if geo else 0,
            ))


def phase_fused_digest(dev, dump=None, against=None) -> None:
    """The fused backward kernel's outputs (K, d, ΔV1, ΔV2, failed, J0) on
    phase_kernels' inputs (parking N=100, B=4096, ρ = 0 and 0.37) and at
    the zoo's shapes (quadrotor N=50, cartpole N=60, B=2048, at their
    tolerances.RHOS), f64 and f32: a SHA-256 of each output's bytes.  With
    --dump DIR the outputs are saved there; with --against DIR they are
    compared with the outputs another run saved (for instance from another
    checkout's package, --package-root), bit for bit and by the largest
    difference, NaNs included.  `dump`, `against`: those directories."""
    import hashlib

    import torch

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.ops import tolerances as tol
    from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
    from altro_tpu_torch.solver.batched import ALSolverBatched

    names = ("K", "d", "dV1", "dV2", "failed", "J0")
    saved = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        # phase_kernels' inputs
        defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
        prob = defn.make_problem().compile()
        ev = ALSolverBatched(prob, SolverOptions())
        rng = np.random.default_rng(42)
        params = prob.params.replace(
            x0=torch.as_tensor(rng.uniform(-0.1, 0.1, (3, B_FLEET)), device=dev).to(dtype)
        )
        Zb = ev.rollout(params, fleet_trajectory(defn, B_FLEET))
        fleets = [("parking", (0.0, 0.37), prob, params, Zb, warm_al(ev, B_FLEET, dtype, dev, rng))]
        for name in ("quadrotor", "cartpole"):
            fleets.append((name, tol.RHOS[tag][name], *scaling_fleet(name, ZOO_BATCH, dev, dtype)))
        for name, rhos, prob, params, Zb, al in fleets:
            bk = BackwardFusedKernel(prob, SolverOptions(), dtype=dtype, device=dev)
            ap = bk.pad_al(al)
            for r in rhos:
                rho = torch.full((Zb.X.shape[-1],), r, dtype=dtype, device=dev)
                out = bk(params, ap, Zb, rho)
                _sync()
                case = f"{name}/{tag}/rho={r}"
                saved[case] = {k: v.cpu() for k, v in zip(names, out)}
    if dump:
        os.makedirs(dump, exist_ok=True)
        torch.save(saved, os.path.join(dump, "fused_digest.pt"))
    other = torch.load(os.path.join(against, "fused_digest.pt")) if against else None
    for case, outs in saved.items():
        line = dict(phase="fused_digest", case=case,
                    sha256={k: hashlib.sha256(v.numpy().tobytes()).hexdigest()[:16] for k, v in outs.items()})
        if other is not None:
            ref = other[case]
            line["bitwise_equal"] = all(
                outs[k].numpy().tobytes() == ref[k].numpy().tobytes() for k in names
            )
            line["max_abs_diff"] = {k: _max_diff(outs[k], ref[k]) for k in names}
        emit(line)


def _max_diff(a, b) -> float:
    """max |a − b|, counting equal entries (infinities too) and entries NaN
    in both as 0, and an entry NaN in one only as inf."""
    import torch

    a, b = a.double(), b.double()
    d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
    return float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0


def phase_profile(dev) -> None:
    """Where the time of one parking-fleet solve goes, on each path: the
    main path's program (phase_main_path) and the same with
    `backward_pass="pallas"`.  Two warm-up solves, three without the
    profiler (median wall), then one traced with torch.profiler (CUDA
    activities only: the device's events, which are all the phase reads;
    the host operators' events took 60 of its 100 s in key_averages on an
    H100's host).  Per path: untraced and traced wall, the device time
    summed over the trace's device events (kernels and copies), its share
    of the untraced wall, host syncs, the port's kernel launches, the count
    of device events and the five largest by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from altro_tpu_torch import SolverOptions
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.solver.compaction import CompactedALSolver

    dtype = torch.float32
    defn = UnicycleProblem(dtype=dtype, device=dev, N=N)
    prob = defn.make_problem().compile()
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.1, 0.1, size=(3, B_FLEET)), device=dev).to(dtype)
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=x0)
    Zb = fleet_trajectory(defn, B_FLEET)

    for path, kw in (("main", {}), ("riccati", dict(backward_pass="pallas"))):
        opts = SolverOptions(**BENCH_OPT_KW).replace(**kw)
        solver = CompactedALSolver(prob, opts, phase1_iters=PHASE1_ITERS, tail_batch=TAIL_BATCH, device_tail=True)
        kerns = {
            name: [getattr(sub, attr) for sub in (solver._p1, solver._tail) if getattr(sub, attr) is not None]
            for name, attr in (("backward_fused", "_bwd"), ("forward", "_fwd"), ("riccati", "_ric"))
        }

        def solve():
            t0 = time.perf_counter()
            solver.solve(params, Zb)
            _sync()
            return time.perf_counter() - t0

        for _ in range(2):
            solve()
        walls = [solve() for _ in range(3)]
        for ks in kerns.values():
            for k in ks:
                k.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = solve()
        # device events only (kernels, copies, sets): a host op's entry
        # repeats the device time of the kernels it launched
        rows = sorted(
            (e for e in prof.key_averages() if e.device_type != DeviceType.CPU), key=dev_us, reverse=True
        )
        device_s = sum(dev_us(e) for e in rows) / 1e6
        wall = float(np.median(walls))
        emit(dict(
            phase="profile", path=path, B=B_FLEET, N=N, wall_s_reps=walls, wall_s_median=wall,
            traced_wall_s=traced, device_s=device_s, device_busy_of_untraced=device_s / wall,
            host_syncs=solver.host_syncs,
            kernel_launches={name: _launches(ks) for name, ks in kerns.items()},
            device_events=sum(e.count for e in rows),
            top=[dict(name=e.key[:80], device_ms=dev_us(e) / 1e3, count=e.count) for e in rows[:5]],
        ))
        assert device_s > 0, f"{path}: the trace holds no device time"


def ptxas_riccati(log: str) -> dict:
    """nvcc -Xptxas=-v's registers, stack and spill-store bytes of each
    Riccati kernel instance ("n13m4_f32": {...}), from the build log."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '_ZN5altro14riccati_kernelI([fd])Li(\d+)ELi(\d+)E", ln)
        if m:
            cur = f"n{m[2]}m{m[3]}_{'f32' if m[1] == 'f' else 'f64'}"
            out[cur] = {}
        elif "entry function" in ln:
            cur = None
        elif cur and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)):
            out[cur].update(stack=int(m[1]), spill_stores=int(m[2]))
        elif cur and (m := re.search(r"Used (\d+) registers", ln)):
            out[cur]["registers"] = int(m[1])
    return out


def _end_on_sigterm(signum, frame) -> None:
    """SIGTERM (a time limit's) ends the script as a failed phase does,
    through run_plain's clean-up, so that no process it started lives on."""
    raise SystemExit(128 + signum)


def _become_subreaper() -> None:
    """Make this process the parent of any orphaned descendant (Linux prctl
    PR_SET_CHILD_SUBREAPER), so that _end_children sees a grandchild whose
    own parent ended before it."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(36, 1)  # 36: PR_SET_CHILD_SUBREAPER


def _children() -> dict[int, str]:
    """The processes whose parent is this one, from /proc: {pid: state}
    ("Z" for one that ended and is not yet reaped)."""
    me, out = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]  # the fields after the name
        except OSError:  # it ended meanwhile
            continue
        if int(ppid) == me:
            out[int(d)] = state
    return out


def _end_children() -> list[str]:
    """Kill and reap every child of this process that is still there, and
    the orphans that come to it meanwhile (_become_subreaper); returns the
    command lines of those that were still running.  Every phase ends its
    own processes, so this finds none unless one of them failed to."""
    import signal

    running = []
    for _ in range(20):  # each round reaps one generation of orphans
        kids = _children()
        if not kids:
            break
        for pid, state in kids.items():
            if state != "Z":
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        running.append(f.read().replace(b"\0", b" ").decode(errors="replace").strip() or str(pid))
                    os.kill(pid, signal.SIGKILL)
                except OSError:  # it ended meanwhile
                    pass
        for pid in kids:
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
    return running


def _run(argv) -> int:
    """main(argv), after which no process it started is left running: any
    that is (a fault) is killed and named on stderr."""
    _become_subreaper()
    try:
        return main(argv)
    finally:
        left = _end_children()
        if left:
            print(f"chip_smoke: ended {len(left)} process(es) left running: {left}", file=sys.stderr)


def main(argv) -> int:
    import argparse
    import signal

    import torch

    signal.signal(signal.SIGTERM, _end_on_sigterm)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="append", default=[],
                    help="run only this phase (repeatable; e.g. kernel_scaling) after the build, "
                         "and print no kernel summary or result line")
    ap.add_argument("--package-root", default=None,
                    help="with --phase: import altro_tpu_torch from this directory (another "
                         "checkout, e.g. a parent commit unpacked into _work/) instead of this one's")
    ap.add_argument("--dump", default=None, help="fused_digest: save the outputs in this directory")
    ap.add_argument("--against", default=None,
                    help="fused_digest: compare with the outputs saved in this directory")
    args = ap.parse_args(argv)
    only = args.phase
    if args.package_root and not only:
        print("chip_smoke: --package-root needs --phase", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.package_root) if args.package_root else ROOT)
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
        ptxas = [
            ln.strip() for ln in lib.build_log.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln
        ]
        emit(dict(
            phase="env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
            device=torch.cuda.get_device_name(0), cpus=os.cpu_count(), build_s=lib.build_seconds, load_s=load_s,
            ptxas=ptxas, ptxas_riccati=ptxas_riccati(lib.build_log),
        ))
        seconds = {}

        def timed(fn, *extra):
            t0 = time.perf_counter()
            out = fn(dev, *extra)
            name = fn.__name__.removeprefix("phase_")
            seconds[name] = time.perf_counter() - t0
            emit(dict(phase="phase_seconds", name=name, s=seconds[name]))  # read where a run is cut
            return out

        if only:
            for name in only:
                extra = (args.dump, args.against) if name == "fused_digest" else ()
                timed(globals()[f"phase_{name}"], *extra)
            emit(dict(phase="seconds", **seconds))
            print(card)
            return 0
        kern = timed(phase_kernels)
        main_launches = timed(phase_main_path)
        timed(phase_parity)
        kern["riccati"] = timed(phase_riccati_vs_plain)
        ric_launches = timed(phase_riccati_path)
        timed(phase_golden_f64_riccati)
        timed(phase_fused_zoo_vs_plain)
        timed(phase_kernel_scaling)
        timed(phase_profile)
        zoo = timed(zoo_part)
        obst_kern, obst = timed(obstacles_part)
        rand_kern, rand_launches, complete_launches = timed(phase_randomized)
        spec_launches, spec_fwd = timed(phase_speculative)
        tri = timed(phase_triple_integrator)
        timed(phase_live_rows)
        mpc_launches = timed(phase_mpc_fleet)
        sharded_launches = timed(phase_sharded)

        def plain_stage(_dev):
            """The zoo's and the obstacle fleet's plain solves and the
            single controller's ticks, together, after every timed kernel
            measurement; the general problems' solves and the per-instance
            solver's checks (untimed) run in this process meanwhile."""
            return run_plain([zoo, obst, single_part(_dev)],
                             during=lambda: (timed(phase_general), timed(phase_per_instance)))

        plain = timed(plain_stage)
        zoo_launches, obst_launches = plain["zoo"], plain["obstacles"]
        emit(dict(phase="seconds", **seconds))
    except Exception:  # noqa: BLE001 - report any failed phase and exit non-zero
        traceback.print_exc()
        return 1
    print(card)
    # each kernel's launches on the paths that run it: the fused kernels on
    # the main path (5 solves; its float64 polish apart), the zoo and the
    # obstacle fleet's two modes (per solve), the float64 polish of the
    # obstacle fleet and the randomized fleet's complete mode (one solve
    # each), the main path with the speculative line search and the triple
    # integrator's fleet (per solve), the MPC fleet (per tick), each sharded
    # rank's timed solve, the Riccati kernel on backward_pass="pallas" (3
    # solves)
    by_path = {
        name: dict(main_path=main_launches[name], main_path_polish=main_launches["polish"][name],
                   riccati_path=ric_launches[name],
                   **{f"zoo_{z}_per_solve": zoo_launches[z][name] for z in zoo_launches},
                   **{f"obstacles_{mode}_per_solve": obst_launches[mode][name] for mode in obst_launches},
                   randomized_f32_throughput_per_solve=rand_launches[name],
                   randomized_complete_per_solve=complete_launches[name],
                   **{f"main_path_speculative_S{S}": spec_launches[S][name] for S in SPEC_S},
                   triple_integrator_per_solve=tri["launches_per_solve"][name],
                   mpc_fleet_per_tick=mpc_launches[name],
                   sharded_per_rank=[rank[name] for rank in sharded_launches])
        for name in ("backward_fused", "forward")
    }
    by_path["riccati"] = dict(riccati_path=ric_launches["riccati"])
    sources = dict(
        backward_fused=("altro_tpu_torch/csrc/backward_fused.cuh",
                        "altro_tpu/ops/backward_fused_pallas.py:546", "main_path"),
        forward=("altro_tpu_torch/csrc/forward.cuh", "altro_tpu/ops/forward_pallas.py:699", "main_path"),
        riccati=("altro_tpu_torch/csrc/riccati.cu", "altro_tpu/ops/riccati_pallas.py:268", "riccati_path"),
    )
    rows = []
    for name, (src, rep, path) in sources.items():
        k = kern[name]["f32"]
        bound_ms, bound_by = bound(*k["work"], "f32")
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=by_path[name][path],
            launches_by_path=by_path[name], max_abs_err=k["max_abs_err"], ms=k["ms"],
            device_ms=k["device_ms"], plain_ms=k["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None,
        ))
        if name in obst_kern["f32"]:  # the same kernel at the obstacle problem's shapes
            o = obst_kern["f32"][name]
            ob_ms, ob_by = bound(*o["work"], "f32")
            rows[-1]["obstacles"] = dict(max_abs_err=o["max_abs_err"], ms=o["ms"], device_ms=o["device_ms"],
                                         plain_ms=o["plain_ms"], bound_ms=ob_ms, bound_by=ob_by)
        if name in rand_kern["f32"]:  # its lane-params instantiation on the randomized fleet
            o = rand_kern["f32"][name]
            rb_ms, rb_by = bound(*o["work"], "f32")
            rows[-1]["randomized"] = dict(max_abs_err=o["max_abs_err"], ms=o["ms"], device_ms=o["device_ms"],
                                          plain_ms=o["plain_ms"], bound_ms=rb_ms, bound_by=rb_by)
        if name == "forward":  # at the speculative search's S·B lanes on the main path
            rows[-1]["speculative"] = {f"S{S}": t for S, t in spec_fwd.items()}
            # its search mode, one launch a line search (phase_kernels)
            rows[-1]["search"] = {
                tag: {key: c[key] for key in ("lanes", "searched", "tries", "lane_tries_run", "lanes_parted", "ms",
                                              "device_ms", "plain_ms", "bound_ms", "bound_by")}
                for tag, c in kern["search"].items()
            }
        if name in tri:  # its (6, 2) triple-integrator instantiation, B=2048
            o = tri[name]
            tb_ms, tb_by = o["bound"]
            rows[-1]["triple_integrator"] = dict(max_abs_err=o["max_abs_err"], ms=o["ms"], device_ms=o["device_ms"],
                                                 plain_ms=o["plain_ms"], bound_ms=tb_ms, bound_by=tb_by)
    emit({"kernels": rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(_run(sys.argv[1:]))

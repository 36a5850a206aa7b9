#!/usr/bin/env python3
"""Per-iteration trace of lane 0 of the f32 parity solve.

The configuration of `bench.parity_solve`: the turn-90 parking problem in
float32, canonical x0 = 0 replicated over the batch, constraint tolerance
1e-6, line search 20, no stall exit.  One JSON line per inner iteration of
lane 0 (total iteration, cost, dJ, gradient, α, ρ; for the port also J0,
the cost the backward pass reports for the trajectory it starts from, which
within one inner solve differs from the previous iteration's cost only by
rounding), then one summary line (status, iterations, control parity
against tests/goldens/unicycle_turn90_refsolve_f64_tol6.npz).  Every lane starts at
the same x0, so every lane iterates as lane 0 does.

    python3 tests/_torch_parity_trace.py torch --device cuda --passes kernels
    python3 tests/_torch_parity_trace.py torch --device cuda --passes riccati
    python3 tests/_torch_parity_trace.py torch --device cpu --passes plain
    python3 tests/_torch_parity_trace.py jax           # scan passes, CPU
    python3 tests/_torch_parity_trace.py compare A.jsonl B.jsonl
    python3 tests/_torch_parity_trace.py jax-spread --batch 1024

`torch` runs the PyTorch port (`kernels`: the fused backward and forward
CUDA kernels; `riccati`: the Riccati kernel over the eager expansions and
the forward kernel; `plain`: the eager passes) and records each inner
iteration from the solver's line search, which it wraps; `jax` runs the
JAX package's scan passes with its iteration history.  `compare` prints the first iteration
where two traces part: a relative difference above 1e-4 in cost, gradient
or α, well above the float32 rounding (~1e-7) in which two traces of the
same path already differ.  `jax-spread` solves `--batch` lanes in the JAX
package, lane 0 at the canonical x0 and the others at x0 moved by at most
PARITY_SPREAD (altro_tpu_torch/ops/tolerances.py), and prints the spread
of their control parity and statuses: what chip_smoke.py's parity phase
reads on the card for the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the repository
GOLDEN = os.path.join(ROOT, "tests", "goldens", "unicycle_turn90_refsolve_f64_tol6.npz")
OPT_KW = dict(
    scan_unroll=4, line_search_max_iterations=20, max_stall_iterations=0, constraint_tolerance=1e-6,
)
FIELDS = ("cost", "cost_decrease", "gradient", "alpha", "regularization")


def _summary(status_name, iters, outer, U0):
    g = np.load(GOLDEN)
    return dict(summary=True, status=status_name, iterations_total=iters, iterations_outer=outer,
                control_parity=float(np.abs(U0 - g["U"]).max()))


def trace_torch(device: str, passes: str, B: int) -> list[dict]:
    import torch

    sys.path.insert(0, ROOT)
    from altro_tpu_torch import SolverOptions, SolverStatus
    from altro_tpu_torch.models.problems import UnicycleProblem
    from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory

    kw = dict(OPT_KW)
    if passes != "plain":
        kw.update(backward_pass="fused" if passes == "kernels" else "pallas", forward_pass="cuda")
    defn = UnicycleProblem(dtype=torch.float32, device=device)
    prob = defn.make_problem().compile()
    solver = ALSolverBatched(prob, SolverOptions(**kw))
    rows = []
    line_search = solver.forward_pass

    def traced_line_search(params, al, Z, bp, J0, *args, **kwargs):
        """The line search, recording lane 0's iteration as
        `ALSolverBatched.ilqr_solve` folds it into its stats."""
        fp = line_search(params, al, Z, bp, J0, *args, **kwargs)
        ok = bool(fp["success"][0])
        cost = float(fp["J"][0]) if ok else float(J0[0])
        alpha = float(fp["alpha"][0]) if ok else (rows[-1]["alpha"] if rows else 0.0)
        grad = (bp["d"].abs() / (fp["Z"].U.abs() + 1.0)).amax(dim=1).mean(dim=0)
        rows.append(dict(
            iteration=len(rows) + 1, J0=float(J0[0]), cost=cost, cost_decrease=float(J0[0]) - cost,
            gradient=float(grad[0]), alpha=alpha,
            regularization=float(bp["rho"][0]),
        ))
        return fp

    solver.forward_pass = traced_line_search
    Z0 = defn.initial_trajectory()
    Z = BatchedTrajectory(Z0.X[..., None].expand(-1, -1, B).contiguous(),
                          Z0.U[..., None].expand(-1, -1, B).contiguous(), Z0.t, Z0.h)
    res = solver.solve(prob.params.replace(x0=torch.zeros((3, B), dtype=torch.float32, device=device)), Z)
    st = res["stats"]
    rows.append(_summary(SolverStatus(int(res["status"][0])).name, int(st.iterations_total[0]),
                         int(st.iterations_outer[0]), res["Z"].U[..., 0].double().cpu().numpy()))
    return rows


def trace_jax(B: int) -> list[dict]:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from altro_tpu import SolverOptions, SolverStatus
    from altro_tpu.models.problems import UnicycleProblem
    from altro_tpu.solver.batched import ALSolverBatched, batched_stats_column, to_batch_last

    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem().compile()
    solver = ALSolverBatched(prob, SolverOptions(iteration_history_capacity=300, **OPT_KW))
    Zb = to_batch_last(jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), defn.initial_trajectory()))
    res = jax.jit(solver.solve)(prob.params.replace(x0=jnp.zeros((3, B), jnp.float32)), Zb)
    st = res["stats"]
    iters = int(st.iterations_total[0])
    cols = {f: np.asarray(batched_stats_column(st, f))[:iters, 0] for f in FIELDS}
    rows = [dict(iteration=i + 1, **{f: float(cols[f][i]) for f in FIELDS}) for i in range(iters)]
    rows.append(_summary(SolverStatus(int(res["status"][0])).name, iters,
                         int(st.iterations_outer[0]), np.asarray(res["Z"].U, np.float64)[..., 0]))
    return rows


def spread_jax(B: int) -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from altro_tpu import SolverOptions, SolverStatus
    from altro_tpu.models.problems import UnicycleProblem
    from altro_tpu.solver.batched import ALSolverBatched, to_batch_last
    from altro_tpu_torch.ops.tolerances import PARITY_SPREAD

    x0 = np.random.default_rng(0).uniform(-PARITY_SPREAD, PARITY_SPREAD, (3, B))
    x0[:, 0] = 0.0
    defn = UnicycleProblem(dtype=jnp.float32)
    prob = defn.make_problem().compile()
    solver = ALSolverBatched(prob, SolverOptions(backward_pass="scan", forward_pass="scan", **OPT_KW))
    Zb = to_batch_last(jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape), defn.initial_trajectory()))
    res = jax.jit(solver.solve)(prob.params.replace(x0=jnp.asarray(x0, jnp.float32)), Zb)
    U = np.asarray(res["Z"].U, np.float64)
    parity = np.abs(U - np.load(GOLDEN)["U"][..., None]).max(axis=(0, 1))
    status = [SolverStatus(int(c)).name for c in np.asarray(res["status"])]
    return dict(
        spread=PARITY_SPREAD, batch=B, lane0=dict(status=status[0], control_parity=float(parity[0])),
        parity_quantiles=dict(zip(("min", "p10", "p50", "p90", "max"),
                                  (float(np.quantile(parity, q)) for q in (0.0, 0.1, 0.5, 0.9, 1.0)))),
        status_counts={name: status.count(name) for name in sorted(set(status))},
    )


def compare(a_path: str, b_path: str) -> dict:
    def load(path):
        with open(path) as f:
            return [r for r in map(json.loads, f) if not r.get("summary")]

    a, b = load(a_path), load(b_path)
    for ra, rb in zip(a, b):
        for f in ("cost", "gradient", "alpha"):
            if abs(ra[f] - rb[f]) > 1e-4 * max(abs(ra[f]), abs(rb[f]), 1e-30):
                return dict(first_departure=ra["iteration"], field=f, a=ra, b=rb)
    return dict(first_departure=None, common_iterations=min(len(a), len(b)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("torch", "jax", "compare", "jax-spread"))
    ap.add_argument("files", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--passes", choices=("kernels", "riccati", "plain"), default="kernels")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if args.what == "compare":
        print(json.dumps(compare(*args.files)))
        return 0
    if args.what == "jax-spread":
        print(json.dumps(spread_jax(args.batch)))
        return 0
    rows = trace_torch(args.device, args.passes, args.batch) if args.what == "torch" else trace_jax(args.batch)
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())

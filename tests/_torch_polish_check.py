"""The JAX package's float64 polish of the three-obstacle fleet, lane by
lane, and the card's polish held against it.

    JAX_PLATFORMS=cpu python tests/_torch_polish_check.py golden
    python tests/_torch_polish_check.py LOG

A polish stage starts each lane afresh from the initial guess with zero
duals (`altro_tpu/solver/compaction.py:_run_polish`), so a lane's outcome
in each stage depends on its x0 alone, not on the float32 phases before
it, nor on which other lanes share its solve.  `golden` runs both stages
of the JAX package's polish (float64, scan passes, on the CPU, about six
minutes) on every lane of the fleet (`bench.make_batch`'s x0, B=4096, the
fleet's options: chip_smoke.py's BENCH_OPT_KW with OBST_OPT_KW) and writes
each lane's status after stage 0 and after stage 1 to GOLDEN; the polish
takes a lane's stage-1 status where its stage-0 status is a hard failure.
chip_smoke.py's `obstacles_polish` step holds every lane it polished to
that outcome.  With LOG, the output of `python3 chip_smoke.py`, it prints
the same comparison from the log's `obstacles_polish` line as one JSON
line.  Not collected by pytest (no `test_` prefix).
"""
import json
import os
import sys

import numpy as np

B = 4096
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "obstacle_fleet_polish_jax_f64.npz")
SOLVED = 0
HARD = (5, 7, 6, 1, 8)  # MAX_ITERATIONS, MAX_INNER, MAX_OUTER, UNSOLVED, MAX_PENALTY
NAMES = {0: "SOLVED", 1: "UNSOLVED", 5: "MAX_ITERATIONS", 6: "MAX_OUTER_ITERATIONS",
         7: "MAX_INNER_ITERATIONS", 8: "MAX_PENALTY", 10: "SOLVED_STALLED"}


def write_golden():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from altro_tpu import SolverOptions
    from altro_tpu.models.problems import UnicycleProblem
    from altro_tpu.solver.batched import ALSolverBatched, to_batch_last

    fleet = dict(scan_unroll=4, initial_penalty=1.0, line_search_max_iterations=20, max_stall_iterations=10,
                 outer_constraints_f64=True)
    polish = dict(line_search_max_iterations=20, max_stall_iterations=10, stalled_feasible_exits=False,
                  reset_duals=True)
    stages = ({}, dict(penalty_scaling=4.0, max_iterations_outer=60, max_iterations_total=900))
    defn = UnicycleProblem(scenario="three_obstacles", dtype=jnp.float64)
    prob = defn.make_problem(add_constraints=True).compile()
    x0 = np.random.default_rng(0).uniform(-0.1, 0.1, size=(3, B))
    x0[:, 0] = 0.0
    params = prob.params.replace(x0=jnp.asarray(x0))
    Zb = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), defn.initial_trajectory()))
    out = {}
    for si, extra in enumerate(stages):
        opts = SolverOptions(**fleet).replace(**polish, **extra)
        res = jax.jit(ALSolverBatched(prob, opts).solve)(params, Zb)
        out[f"stage{si}"] = np.asarray(res["status"]).astype(np.int8)
        out[f"stage{si}_iterations"] = np.asarray(res["stats"].iterations_total).astype(np.int16)
    np.savez_compressed(GOLDEN, **out)
    print(json.dumps({k: np.bincount(v, minlength=11).tolist() for k, v in out.items() if "iter" not in k}))


def polished(golden, lanes):
    """The JAX polish's status of each of `lanes`."""
    s0, s1 = golden["stage0"][lanes].astype(int), golden["stage1"][lanes].astype(int)
    return np.where(np.isin(s0, HARD), s1, s0)


def check_log(path):
    line = next(json.loads(ln) for ln in open(path) if '"phase": "obstacles_polish"' in ln)
    lanes, card = np.asarray(line["polished_lanes"]), np.asarray(line["polished_status"])
    ref = polished(np.load(GOLDEN), lanes)
    hist = lambda st: {NAMES.get(int(c), str(c)): int((st == c).sum()) for c in sorted(set(st.tolist()))}  # noqa: E731
    print(json.dumps(dict(
        lanes=int(lanes.size), card=hist(card), jax_cpu_f64=hist(ref), agree=int((card == ref).sum()),
        differ=lanes[card != ref].tolist(), fleet_solved_card=line["solved_frac"],
        fleet_solved_jax=line["solved_frac"] + (int((ref == SOLVED).sum()) - int((card == SOLVED).sum())) / B,
    )))


if __name__ == "__main__":
    write_golden() if sys.argv[1] == "golden" else check_log(sys.argv[1])

"""The JAX package's closed loops of the MPC fleet and of the single
controller, on the CPU: the goldens that chip_smoke.py's `mpc_fleet` and
`per_instance` steps hold the port's controllers to.

    python tests/_torch_mpc_check.py golden
    python tests/_torch_mpc_check.py single
    python tests/_torch_mpc_check.py passes

The configuration is `perf/mpc_device_latency.py`'s: the turn-90 unicycle
(N=100, with constraints), at most 3 iterations a tick (total and inner),
the warm-start guess shifted each tick, the plant the model's RK4 step.

- The fleet, float32 (x64 off, as on the TPU), on the script's own
  passes, the fused Pallas kernels (run in interpret mode off the TPU):
  B=4096 controllers, x0 uniform in ±0.1 from `np.random.default_rng(0)`,
  two warm-up ticks at x0, then 100 closed-loop ticks.  Written: the
  status counts of every tick and each lane's final state.  The kernels
  sum the cost with Kahan compensation (`forward_pallas.py:567-570`), as
  the port's CUDA kernels do; the scan passes' float32 sums are noisier,
  and in the last 40 ticks their line searches stall lanes that the
  kernels and every float64 loop solve (85.4% SOLVED at the last tick on
  the scan passes, 100% in float64; `passes` below).
- The fleet's first 256 lanes, float64, on the scan passes (the Pallas
  kernels run in float32 only on a TPU): the same x0 draws in float64,
  two warm-up ticks and 30 closed-loop ticks.  Written: u0, the status
  and the iterations of every lane at every one of the 32 ticks, and the
  final state.
- The single controller, float32: one tick and ten more at x0 = 0, then
  100 ticks of `rollout_ticks`.  Written: the final goal xy distance.
  `single` recomputes only this one (about a minute) and rewrites it in
  the float32 golden, leaving the fleet's entries as they are.

`passes` prints the fleet's SOLVED count at every tick on the scan
passes in float32 and in float64 (all B lanes, about 15 minutes): where
the float32 loops part, which side rounding decides.

Each tick is the JAX package's `BatchedMPC.step` (or `MPC`), its jitted
solve, then the plant; the fleet's ticks are stepped from the host so
that every tick's statuses can be read.  Writes
tests/goldens/mpc_fleet_jax_{f32,f64}.npz (about 15 minutes on an 8-core
CPU, most of it the interpreted kernels).  Not collected by pytest (no `test_` prefix).
"""
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_F32 = os.path.join(HERE, "goldens", "mpc_fleet_jax_f32.npz")
GOLDEN_F64 = os.path.join(HERE, "goldens", "mpc_fleet_jax_f64.npz")
B = 4096
B_F64 = 256
CAP = 3
WARM = 2
TICKS = 100
TICKS_F64 = 30
SINGLE_WARM = 11
SINGLE_TICKS = 100
N_STATUS = 12


def _setup(dtype):
    import jax
    import jax.numpy as jnp

    from altro_tpu.models.problems import UnicycleProblem
    from altro_tpu.models.unicycle import unicycle_rk4

    defn = UnicycleProblem(dtype=dtype)
    prob = defn.make_problem(add_constraints=True).compile()
    step1 = unicycle_rk4()
    h = defn.h
    plant1 = lambda x, u: step1(x, u, 0.0, h)  # noqa: E731
    plant = jax.jit(jax.vmap(plant1, in_axes=-1, out_axes=-1))
    return defn, prob, plant, jax.jit(plant1)


def _fleet(dtype, lanes, ticks, **passes):
    """The fleet's closed loop on `passes` (the scan passes by default):
    (per-tick statuses [WARM+ticks, lanes], iterations, u0 [WARM+ticks, 2,
    lanes], final x [3, lanes])."""
    import jax
    import jax.numpy as jnp

    from altro_tpu import BatchedMPC, SolverOptions
    from altro_tpu.solver.batched import to_batch_last

    defn, prob, plant, _ = _setup(dtype)
    mpc = BatchedMPC(prob, SolverOptions(max_iterations_total=CAP, max_iterations_inner=CAP, **passes), shift=True)
    Zb = to_batch_last(jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (lanes,) + l.shape),
                                              defn.initial_trajectory()))
    state = mpc.init(Zb)
    x = jnp.asarray(np.random.default_rng(0).uniform(-0.1, 0.1, size=(3, B))[:, :lanes], dtype)
    status, iters, u0s = [], [], []
    for tick in range(WARM + ticks):
        u0, state = mpc.step(state, x)
        if tick >= WARM:
            x = plant(x, u0)
        status.append(np.asarray(state.status))
        iters.append(np.asarray(state.iterations))
        u0s.append(np.asarray(u0))
    return np.stack(status), np.stack(iters), np.stack(u0s), np.asarray(x)


def _single():
    import jax.numpy as jnp

    from altro_tpu import MPC, SolverOptions

    defn, prob, _, plant = _setup(jnp.float32)
    mpc = MPC(prob, SolverOptions(max_iterations_total=CAP, max_iterations_inner=CAP), shift=True)
    state = mpc.init(defn.initial_trajectory())
    x = jnp.zeros(3, jnp.float32)
    for _ in range(SINGLE_WARM):
        _, state = mpc.step(state, x)
    _, xf, X, _ = mpc.rollout_ticks(state, x, plant, SINGLE_TICKS)
    return float(np.linalg.norm(np.asarray(X[-1])[:2] - np.asarray(defn.xf)[:2]))


def write_golden():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import jax.numpy as jnp

    t0 = time.perf_counter()
    status, _, _, x_final = _fleet(jnp.float32, B, TICKS, backward_pass="fused", forward_pass="pallas")
    counts = np.stack([np.bincount(s, minlength=N_STATUS) for s in status]).astype(np.int32)
    single = _single()
    np.savez_compressed(GOLDEN_F32, status_counts=counts, x_final=x_final.astype(np.float32),
                        single_goal_dist=np.float64(single))
    t1 = time.perf_counter()
    jax.config.update("jax_enable_x64", True)
    status, iters, u0, x_final = _fleet(jnp.float64, B_F64, TICKS_F64)
    np.savez_compressed(GOLDEN_F64, status=status.astype(np.int8), iterations=iters.astype(np.int8),
                        u0=u0, x_final=x_final)
    print(json.dumps(dict(f32_seconds=t1 - t0, f64_seconds=time.perf_counter() - t1,
                          f32_last_tick_counts=counts[-1].tolist(), single_goal_dist=single,
                          f64_last_tick_counts=np.bincount(status[-1], minlength=N_STATUS).tolist())))


def write_single():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    t0 = time.perf_counter()
    single = _single()
    gold = dict(np.load(GOLDEN_F32))
    gold["single_goal_dist"] = np.float64(single)
    np.savez_compressed(GOLDEN_F32, **gold)
    print(json.dumps(dict(single_seconds=time.perf_counter() - t0, single_goal_dist=single)))


def compare_passes():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    for dtype in (jnp.float32, jnp.float64):
        status = _fleet(dtype, B, TICKS)[0]
        print(json.dumps(dict(passes="scan", dtype=str(np.dtype(dtype)), lanes=B,
                              solved_per_tick=(status == 0).sum(axis=1).tolist())), flush=True)


if __name__ == "__main__":
    modes = dict(golden=write_golden, single=write_single, passes=compare_passes)
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        sys.path.insert(0, os.path.dirname(HERE))
        modes[sys.argv[1]]()
    else:
        print(__doc__)
        sys.exit(2)

"""How closely each CUDA kernel must agree with its plain PyTorch version,
and how close the float32 parity solve must come to the reference.

One copy of the bounds that `chip_smoke.py` and the tests hold the port
to, and of the regularizations ρ at which each problem's backward sweep is
compared.

float64 bounds are algorithmic: kernel and plain version differ only in
rounding order.  Elementwise, |Δ| <= F64_ATOL + rtol·|plain| for gains, cost
and ΔV; for the rolled-out trajectories, whose diverging lanes amplify
rounding along the horizon, max |Δ| <= rtol · max(max |plain|, 1).  Where
the sweep is ill-conditioned (the quadrotor at small ρ) a lane's bound grows
by SENS_FACTOR times its sensitivity: how far the plain version's own K, d
move, relative to 1 + |K|, when every input moves by one unit in the last
place (the largest over SENS_DRAWS random moves).  A lane whose failure
flag flips under such a move is on the edge and compared on neither flag
nor values.  Two float64 sweeps that differ only in rounding order (the JAX
package's riccati_scan and the port's plain sweep) stay within that bound
at the quadrotor's ρ=10 and 1e3 (tests/test_torch_riccati.py).

The float32 parity solve (bench.parity_solve's configuration) is held at
lane 0, from the canonical x0, and over lanes whose x0 moved by at most
PARITY_SPREAD: its median control parity must stay within 1e-3.  The JAX
package's own float32 solve spreads that far under such a move (up to
5.6e-3 over 64 lanes; tests/test_torch_parity_f32.py holds it to
RICCATI_PARITY_LIMIT), so lane 0 of a path whose rounding differs from the
fused kernels' is held to RICCATI_PARITY_LIMIT rather than 1e-3.

float32 bounds sit about 5-10x above what an H100 (700 W) showed, relative
to each output's largest magnitude (floored at 1).  Each float32 sweep is
also held, with the plain float32 sweep, against the float64 plain sweep of
the same inputs: the kernel's error must stay within F32_VS_F64_RATIO times
the plain version's.
"""
from __future__ import annotations

import numpy as np
import torch

PARITY_SPREAD = 1e-6
RICCATI_PARITY_LIMIT = 1e-2

F64_RTOL = dict(K=1e-9, d=1e-9, dV1=1e-8, dV2=1e-8, J0=1e-10, Xn=1e-10, Ubar=1e-10, J=1e-10)
F64_ATOL = 1e-10
F64_SCALED = ("Xn", "Ubar")
SENS_FACTOR = 100.0
SENS_DRAWS = 3

# the fused kernels on the parking problem.  Observed on an H100 (700 W): K
# 5.9e-5, d 4.3e-5, dV1 9.4e-7, dV2 1.0e-6, J0 3.8e-7, Xn 3.8e-7, Ubar
# 4.0e-7, J 6.3e-7
F32_REL = dict(K=3e-4, d=3e-4, dV1=8e-6, dV2=8e-6, J0=2e-6, Xn=2e-6, Ubar=2e-6, J=5e-6)

# the Riccati kernel per problem.  Observed on an H100 (700 W), largest over
# the cases: parking K 7.3e-5, d 4.3e-5, dV1 1.0e-6, dV2 9.4e-7; quadrotor
# (ρ=1e3) K 1.3e-2, d 1.9e-3, dV1 9.9e-6, dV2 1.0e-5; cartpole K 1.6e-5, d
# 1.8e-5, dV1 2.1e-6, dV2 1.8e-6; triple integrator K 3.8e-3, d 3.7e-3,
# dV1 5.0e-5, dV2 3.4e-4 (its terminal weight 1e5 and |K| up to ~800 at
# ρ=0 make it round coarsest: the plain float32 sweep is as far off the
# float64 one)
RICCATI_F32_REL = dict(
    parking=dict(K=5e-4, d=3e-4, dV1=8e-6, dV2=8e-6),
    quadrotor=dict(K=1e-1, d=1.5e-2, dV1=8e-5, dV2=8e-5),
    cartpole=dict(K=1.5e-4, d=1.5e-4, dV1=1.5e-5, dV2=1.5e-5),
    triple=dict(K=3e-2, d=3e-2, dV1=3e-4, dV2=2e-3),
)

# the fused kernels on the zoo's problems.  Observed on an H100 (700 W),
# largest over the cases: quadrotor (ρ=1e3) K 1.2e-2, d 1.5e-3, dV1 1.2e-5,
# dV2 1.3e-5, J0 1.6e-7, Xn 1.4e-6, Ubar 3.7e-7, J 5.7e-7; cartpole K 1.6e-5,
# d 1.6e-5, dV1 2.1e-6, dV2 2.0e-6, J0 2.2e-7, Xn 5.1e-7, Ubar 1.2e-6, J 1.6e-6;
# the triple integrator (dof 2, N=10, B = 2048, 1001, 1) K 3.8e-3, d 3.7e-3,
# dV1 5.4e-5, dV2 3.6e-4, J0 3.4e-7, Xn 6.9e-7, Ubar 1.3e-6, J 1.8e-6 (the
# Riccati kernel's K and d on it: its plain float32 sweep rounds as coarsely)
ZOO_F32_REL = dict(
    quadrotor=dict(K=1e-1, d=1.5e-2, dV1=1e-4, dV2=1e-4, J0=1.5e-6, Xn=1e-5, Ubar=3e-6, J=5e-6),
    cartpole=dict(K=1.5e-4, d=1.5e-4, dV1=2e-5, dV2=2e-5, J0=2e-6, Xn=4e-6, Ubar=1e-5, J=1.5e-5),
    triple=dict(K=3e-2, d=3e-2, dV1=3e-4, dV2=2e-3, J0=2e-6, Xn=5e-6, Ubar=1e-5, J=1e-5),
)

# the fused kernels on the three-obstacle problem, at chip_smoke.py's
# field_case inputs (positions over the obstacle field, circle rows
# penalized).  Observed on an H100 (700 W), largest over the cases at
# B=4096 and 1001: K 4.7e-7, d 5.1e-7, dV1 7.3e-7, dV2 3.6e-7, J0 1.9e-7,
# Xn 4.0e-7, Ubar 3.8e-7, J 3.3e-7 (the circle rows equal the plain
# version's bit for bit).  The randomized fleet (per-lane obstacle layouts,
# goals and tracking costs; the kernels' lane-params instantiations) is held
# to the same bounds, and to F64_RTOL / F64_ATOL in float64
OBSTACLE_F32_REL = dict(K=5e-6, d=5e-6, dV1=8e-6, dV2=4e-6, J0=2e-6, Xn=4e-6, Ubar=4e-6, J=4e-6)

# observed on an H100 (700 W): the kernel's float32 error against the
# float64 plain sweep is 0.70-1.37 times the plain float32 sweep's
F32_VS_F64_RATIO = 4.0

# the associative-scan sweep (`solver/pscan_batched.py:riccati_pscan_batched`)
# against the Riccati kernel at ρ=0 on the parking expansions (N=100,
# B=4096): the largest |Δ| of each output over the lanes that did not fail,
# relative to max(max |kernel|, 1).  The two compose the same recursion in
# another order, so float64 agrees to rounding.  Observed on an H100
# (700 W): float64 K 3.0e-13, d 2.0e-13, dV1 3.2e-14, dV2 3.2e-14; float32
# K 1.2e-4, d 8.3e-5, dV1 1.3e-5, dV2 1.3e-5 (the kernel is itself 7.3e-5
# from the plain float32 sweep, above)
PSCAN_REL = dict(
    f64=dict(K=1e-9, d=1e-9, dV1=1e-9, dV2=1e-9),
    f32=dict(K=1e-3, d=8e-4, dV1=1e-4, dV2=1e-4),
)

# regularizations of the backward checks.  The quadrotor's open-loop hover
# sweep is ill-conditioned at small ρ: a one-ulp move of the float64 inputs
# moves the plain version's gains by about 1e-5 at ρ=10 and 1e-12 at ρ=1e3
# (relative to 1 + |K|; chip_smoke.py reports this sensitivity for every
# case), and at ρ=0 every lane fails.  In float32 the same move is 2^29
# times larger, so float32 is held at ρ=1e3 only (and at ρ=0, flags alone).
RHOS = dict(
    f64=dict(parking=(0.0, 0.37), quadrotor=(0.0, 10.0, 1e3), cartpole=(0.0, 0.37), triple=(0.0, 0.37),
             obstacles=(0.0, 0.37, 10.0)),
    f32=dict(parking=(0.0, 0.37), quadrotor=(0.0, 1e3), cartpole=(0.0, 0.37), triple=(0.0, 0.37),
             obstacles=(0.0, 0.37, 10.0)),
)


def ulp_moved(t: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """`t` with every entry moved by one unit in the last place, up or down
    at random (from `rng`)."""
    up = torch.as_tensor(rng.random(tuple(t.shape)) < 0.5, device=t.device)
    inf = torch.full_like(t, float("inf"))
    return torch.nextafter(t, torch.where(up, inf, -inf))


def sensitivity(want, moved) -> tuple[torch.Tensor, torch.Tensor]:
    """Per lane [B]: how far the gains K, d (the first two outputs, batch
    last) move, relative to 1 + |K|, between the outputs `want` of a
    backward sweep and each of `moved`, sweeps whose inputs differ from its
    own by one ulp (the largest over them); and the lanes whose failure flag
    (the fifth output) flips in any of them."""
    s, flips = None, None
    for out in moved:
        for w, p in zip(want[:2], out[:2]):
            r = ((p.double() - w.double()).abs() / (1.0 + w.double().abs())).flatten(0, -2).amax(dim=0)
            s = r if s is None else s.maximum(r)
        f = want[4] != out[4]
        flips = f if flips is None else flips | f
    return s, flips

# The MPC fleet (perf/mpc_device_latency.py's configuration: 4,096 warm-
# started controllers, at most 3 iterations a tick, 100 closed-loop ticks)
# on the fused kernels in float32, against the JAX package's closed loop on
# its fused Pallas kernels (interpreted on the CPU) from the same draws
# (tests/goldens/mpc_fleet_jax_f32.npz).  Both kernels sum the cost with
# Kahan compensation; on the scan passes, whose float32 sums are noisier,
# the JAX loop ends 13 points lower, where every float64 loop solves all
# lanes (tests/_torch_mpc_check.py passes).  Each tick feeds its float32
# rounding into the next tick's x0, and a capped solve's status turns on
# where its last iteration lands, so the two loops agree as fleets, not
# lane for lane: the SOLVED share at the last tick
# within MPC_SOLVED_POINTS percentage points; the 99th percentile of the
# goal xy distance within MPC_GOAL_P99_M metres (the task's scale: the
# goal constraint's tolerance is 1e-4 and the fleet ends centimetres from
# the goal); the median over lanes of the largest |x_final − x_final_JAX|
# within MPC_X_MEDIAN.
MPC_SOLVED_POINTS = 2.0
MPC_GOAL_P99_M = 0.01
MPC_X_MEDIAN = 1e-3
# float64, lane for lane (the fleet's first 256 lanes on the fused kernels'
# float64 instantiations, 30 closed-loop ticks; tests/goldens/
# mpc_fleet_jax_f64.npz): statuses and iterations equal at every tick, u0
# at every tick and the final x within MPC_F64_ATOL.  Two float64 paths
# that differ only in rounding order stay far inside it (each solve's U
# within 1e-10 of the JAX package's on the CPU, tests/test_torch_mpc.py);
# the per-instance MPC against the fleet's lane 0 is held to the same bound.
MPC_F64_ATOL = 1e-8
# the single controller (float32, perf/mpc_device_latency.py:single): its
# final goal xy distance within SINGLE_GOAL_M metres of the JAX package's
SINGLE_GOAL_M = 0.01

"""The benchmark's frozen yardstick for kernels: the H100's published
peaks and the operations and bytes of one launch of each fused kernel,
counted from the configuration's shapes alone.

The counts are those the port's smoke test used when the kernels were
measured alone (`chip_smoke.py:fused_work`, `forward_work`,
`riccati_step_flops`, `bound`), copied here so that a later change to the
program cannot change the yardstick it is measured by.  Inputs come from a
configuration file: horizon and sizes, the constraint rows, and the model's
operation counts as its device functor counts them (`kernel_work`).
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the dense rates outside
# the tensor cores, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


@dataclasses.dataclass(frozen=True)
class KernelShape:
    N: int
    n: int
    m: int
    Ps: int  # stage constraint rows per knot
    Fs: int  # stage constraint families
    Pt: int  # terminal constraint rows
    Ft: int  # terminal constraint families
    f_ops: int  # operations of one model evaluation
    tangent_ops: int  # of one tangent of the model at a known point
    rk4: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "KernelShape":
        pb = cfg["problem"]
        n, m = int(pb["n"]), int(pb["m"])
        bound_rows = 2 * m if "bound" in pb["constraints"] else 0
        goal_rows = n if "goal" in pb["constraints"] else 0
        f_ops, tangent_ops = cfg["kernel_work"]["model_ops"]
        return cls(N=int(pb["N"]), n=n, m=m, Ps=bound_rows, Fs=int(bound_rows > 0), Pt=goal_rows,
                   Ft=int(goal_rows > 0), f_ops=int(f_ops), tangent_ops=int(tangent_ops),
                   rk4=pb.get("integrator", "rk4") == "rk4")


def bound_seconds(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """(seconds, what sets it): the least time the card could take to move
    `nbytes` and do `flops` in `dtype`."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _mm(i, j, k):
    return i * k * (2 * j - 1)


def riccati_step_flops(n, m) -> int:
    """Operations of one knot of the Riccati step, per lane, each counted
    once."""
    f = 2 * _mm(n, n, n) + n * n
    f += 2 * _mm(n, n, m) + n * m
    f += _mm(m, n, m) + m * m
    f += _mm(n, n, 1) + n + _mm(m, n, 1) + m
    f += sum(3 + 2 * j + (m - 1 - j) * (2 * j + 1) for j in range(m))
    f += 2 * m * m * (n + 1) + m * (n + 1)
    f += _mm(n, m, m) + 3 * _mm(n, m, 1) + 3 * n
    f += 2 * _mm(n, m, n) + 3 * n * n
    f += 2 * (2 * m - 1) + _mm(m, m, 1) + 4
    return f


def _step_ops(k: KernelShape) -> tuple[int, int]:
    """(model evaluations, operations per state entry) of one integrator
    step: RK4's four stages, or Euler's one."""
    return (4, 14) if k.rk4 else (1, 2)


def fused_backward_work(k: KernelShape, B: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of one fused backward launch over B lanes: per
    lane it reads X, U, the packed AL state and ρ and writes K, d, ΔV1, ΔV2,
    J0 and the flags; per knot the quadratic cost's value and gradient, its
    Hessian, the AL rows, the step's value, its n+m tangents, and one
    Riccati step."""
    N, n, m = k.N, k.n, k.m
    evals, per_entry = _step_ops(k)
    read = (N + 1) * n + N * m + N * (k.Ps + k.Fs) + k.Pt + k.Ft + 1
    write = N * (m * n + m) + 3
    quad = 2 * _mm(n, n, 1) + 2 * _mm(n, m, 1) + 2 * _mm(m, m, 1) + 6 * (n + m)
    hess = n * n + n * m + m * m
    al = k.Ps * 8
    value = evals * k.f_ops + per_entry * n
    tangents = (n + m) * (evals * k.tangent_ops + per_entry * n)
    per_knot = quad + hess + al + value + tangents + riccati_step_flops(n, m)
    return B * ((read + write) * ITEMSIZE[dtype] + 4), float(N * B * per_knot)


def forward_work(k: KernelShape, B: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of one forward launch over B lanes: per lane it
    reads x0, α, X, U, K, d and the packed AL state and writes X̄, Ū, J and
    two flags; per knot the feedback law, the step, the cost and AL value
    and the guard."""
    N, n, m = k.N, k.n, k.m
    evals, per_entry = _step_ops(k)
    read = n + 1 + (N + 1) * n + N * m + N * (m * n + m) + N * (k.Ps + k.Fs) + k.Pt + k.Ft
    write = N * (n + m) + 1
    per_knot = (_mm(m, n, 1) + n + 3 * m + evals * k.f_ops + per_entry * n
                + 2 * (n * n + n * m + m * m) + 4 * (n + m) + k.Ps * 6 + 2 * (n + m))
    return B * ((read + write) * ITEMSIZE[dtype] + 8), float(N * B * per_knot)


WORK = {"backward_fused": fused_backward_work, "forward": forward_work}


def least_seconds(kernel: str, k: KernelShape, B: int, dtype: str) -> float:
    nbytes, flops = WORK[kernel](k, B, dtype)
    return bound_seconds(nbytes, flops, dtype)[0]

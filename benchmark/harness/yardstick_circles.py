"""The frozen yardstick's count of the fused backward kernel with keep-out
circle rows among the stage constraints (a configuration whose `problem.
constraints` has a `circle` entry), and the roofline reader that uses it.

`yardstick.py` counts bound and goal rows only, 8 operations a stage row.
A circle row costs the backward kernel 81, as the port's smoke test counts
it (`chip_smoke.py:CIRCLE_ROW_OPS`): dx and dy (2), the compensated row
(`csrc/lane_algebra.cuh:comp_circle`, 53), its AL value with the weights
(8), and its gradient and Gauss-Newton terms (18).  Each circle row adds a
dual to the packed AL state a lane reads at each knot, and the circle
family a penalty.  The peaks, the shape and the rest of the count are the
frozen file's, used and not changed.
"""
from __future__ import annotations

import dataclasses

from .yardstick import KernelShape, bound_seconds, fused_backward_work

CIRCLE_ROW_OPS = 2 + 53 + 8 + 18
BOUND_ROW_OPS = 8  # the frozen count's, for each stage row


def circle_rows(cfg: dict) -> int:
    entry = cfg["problem"]["constraints"].get("circle")
    return 0 if entry is None else len(entry["cx"])


def shape(cfg: dict) -> KernelShape:
    """The frozen shape with the circle rows and their family among the
    stage constraints."""
    k = KernelShape.from_config(cfg)
    rows = circle_rows(cfg)
    return dataclasses.replace(k, Ps=k.Ps + rows, Fs=k.Fs + int(rows > 0))


def backward_work(cfg: dict, B: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of one fused backward launch over B lanes."""
    k = shape(cfg)
    nbytes, flops = fused_backward_work(k, B, dtype)
    return nbytes, flops + float(k.N * B * circle_rows(cfg) * (CIRCLE_ROW_OPS - BOUND_ROW_OPS))


def least_seconds(cfg: dict, B: int, dtype: str) -> float:
    return bound_seconds(*backward_work(cfg, B, dtype), dtype)[0]


def roofline_percent(run) -> float | None:
    """This count's least time of every float32 launch of the fused
    backward kernel in the traced stretch over their device time, as
    `readers.roofline_percent` reckons the frozen count's: None where the
    stretch launched none, or the trace does not hold each launch once."""
    if run.trace is None:
        return None
    widths = [(w, c) for w, c in run.launches.get("backward_fused", []) if c > 0]
    launched = sum(c for _, c in widths)
    dtype = run.cell.config["dtype"]
    events = run.trace.kernels("backward_fused_kernel", dtype=dtype)
    if launched == 0 or len(events) != launched:
        return None
    least = sum(c * least_seconds(run.cell.config, w, dtype) for w, c in widths)
    return 100.0 * least / (sum(e.dur_us for e in events) * 1e-6)

"""Shared arithmetic of the metric readers in `benchmark/metrics/`."""
from __future__ import annotations

import statistics

from .yardstick import least_seconds


def mean(values) -> float | None:
    vals = [float(v) for v in values if v is not None]
    return statistics.fmean(vals) if vals else None


def idle_percent(run) -> float | None:
    """The share of the traced stretch with no device activity."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline_percent(run, kernel: str, name: str) -> float | None:
    """The frozen count's least time of every launch of `kernel` in the
    traced stretch over their device time in the trace: None where the
    stretch launched none, or the trace does not hold each launch once."""
    if run.trace is None:
        return None
    widths = [(w, c) for w, c in run.launches.get(kernel, []) if c > 0]
    launched = sum(c for _, c in widths)
    events = run.trace.kernels(name, dtype=run.cell.config["dtype"])
    if launched == 0 or len(events) != launched:
        return None
    dtype = run.cell.config["dtype"]
    least = sum(c * least_seconds(kernel, run.shape, w, dtype) for w, c in widths)
    return 100.0 * least / (sum(e.dur_us for e in events) * 1e-6)

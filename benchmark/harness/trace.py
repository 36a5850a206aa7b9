"""Traced stretches of a run: torch.profiler over the device (the busy
time, kernel times and rooflines) and, in a second stretch, over host and
device (what the host did in the device's idle gaps), reduced to what the
per-layer readers and the breakdown need.

The benchmark marks its own calls into the program with host ranges named
`bench.<what>` (`span`); the device's activity is every kernel, copy and
set in the trace.  Busy time is the union of the device intervals inside
the stretch, so overlapping work is counted once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import time

import torch

PREFIX = "bench."


def span(name: str):
    """A host range around a call into the program (a no-op cost when no
    profiler runs)."""
    return torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass
class Interval:
    name: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    device: list  # Interval of every device activity inside the stretch
    ranges: list  # Interval of every benchmark range
    host_ops: list  # Interval of the outermost host operations
    window_s: float
    busy_s: float

    def kernels(self, pattern: str, dtype: str | None = None) -> list:
        """Device intervals whose name holds the kernel `pattern` as a
        whole word, and, with `dtype`, whose template argument is it."""
        word = re.compile(r"\b" + re.escape(pattern) + r"\b")
        want = None if dtype is None else {"float32": "float", "float64": "double"}[dtype]
        out = []
        for e in self.device:
            if not word.search(e.name):
                continue
            if want is not None:
                m = re.search(r"<\s*(float|double)\b", e.name)
                if m is None or m.group(1) != want:
                    continue
            out.append(e)
        return out

    def idle_gaps(self) -> list:
        """The stretch's gaps with no device activity: (start_us, end_us)."""
        gaps, t = [], self._t0
        for s, e in self._union:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self._t1 > t:
            gaps.append((t, self._t1))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the benchmark range and the outermost host operation
        running when each began ("python" where none ran)."""
        totals: dict = {}
        for e in self.device:
            totals[e.name] = totals.get(e.name, 0.0) + e.dur_us * 1e-6
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        named = []
        for s, e in sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]:
            rng = [r for r in self.ranges if r.start_us <= s < r.end_us and r.name != PREFIX + "trace"]
            where = min(rng, key=lambda r: r.dur_us).name[len(PREFIX):] if rng else "between calls"
            host = [h for h in self.host_ops if h.start_us <= s < h.end_us]
            named.append([f"{where}: {host[0].name if host else 'python'}", (e - s) * 1e-6])
        return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=named)


def _ev_fields(e):
    """(name, is_device, start_us, end_us) of a raw profiler event."""
    name = e.name() if callable(getattr(e, "name", None)) else e.name
    dt = e.device_type() if callable(getattr(e, "device_type", None)) else e.device_type
    is_dev = "CPU" not in str(dt)
    if hasattr(e, "start_ns"):
        start = e.start_ns() / 1e3
        dur = (e.duration_ns() if hasattr(e, "duration_ns") else e.end_ns() - e.start_ns()) / 1e3
    else:
        start, dur = e.start_us(), e.duration_us()
    return name, is_dev, float(start), float(start + dur)


@contextlib.contextmanager
def traced(out: dict, host: bool):
    """Trace the body; on exit `out["trace"]` holds the reduced `Trace`.
    The body's end is synchronised with the card inside the trace.  With
    `host`, host operations and the benchmark's ranges are recorded too,
    which slows the host; without it only the device is traced and the
    stretch is timed on the host clock."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with span("trace"):
            yield
            sync()
        wall = time.perf_counter() - t0
    out["trace"] = _reduce(prof.profiler.kineto_results.events(), wall)


def _reduce(events, wall_s: float) -> Trace:
    dev, ranges, host = [], [], []
    for e in events:
        name, is_dev, s, t = _ev_fields(e)
        if name.startswith(PREFIX):
            if not is_dev:  # a device copy of a host range is no device work
                ranges.append(Interval(name, s, t))
        elif is_dev:
            dev.append(Interval(name, s, t))
        else:
            host.append(Interval(name, s, t))
    outer = [r for r in ranges if r.name == PREFIX + "trace"]
    if outer:  # the host was traced: the stretch is its range
        t0, t1 = outer[0].start_us, outer[0].end_us
        dev = [d for d in dev if d.end_us > t0 and d.start_us < t1]
    elif dev:  # the device alone: its events all belong to the stretch
        t0 = min(d.start_us for d in dev)
        t1 = t0 + wall_s * 1e6
    else:
        raise RuntimeError("the trace holds neither a benchmark range nor device activity")
    host = _outermost([h for h in host if h.end_us > t0 and h.start_us < t1])
    union = []
    for d in sorted(dev, key=lambda d: d.start_us):
        s, e = max(d.start_us, t0), min(d.end_us, t1)
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            union.append([s, e])
    tr = Trace(device=dev, ranges=ranges, host_ops=host, window_s=(t1 - t0) * 1e-6,
               busy_s=sum(e - s for s, e in union) * 1e-6)
    tr._t0, tr._t1, tr._union = t0, t1, union
    return tr


def _outermost(ops: list) -> list:
    out, end = [], float("-inf")
    for h in sorted(ops, key=lambda h: (h.start_us, -h.end_us)):
        if h.start_us >= end:
            out.append(h)
            end = h.end_us
    return out

"""Phase timing: the per-instance solver's `Timer`, and the fleet path's
span tracer and counted host reads.

`Timer` is the host-side analog of the reference's
`Timer`/`Stopwatch`/`ProfileEntry` (`altro/common/timer.hpp:41-95`,
`timer.cpp:10-134`, `profile_entry.hpp:20-36`): nested named scopes add
microseconds into "al/ilqr/forward_pass"-style paths, and `summary` prints
the call tree with time, %total and %parent columns like
`perf/profiler_unicycle.out`.  CUDA work is asynchronous, so a scope around
it measures the launches unless it blocks: `block=True` synchronizes the
timer's `device` (a CUDA device; nothing to wait for on the CPU) before the
scope ends.  `trace_context` also marks the scope in a `torch.profiler`
trace (the per-instance solver's phases use it).  An inactive timer costs
one attribute test per scope.

The tracer covers the fleet path: the controllers (`mpc.*`), the compaction
driver (`compaction.*`), the lockstep AL-iLQR loops (`al.*`, `ilqr.*`) and
the kernels' host side (`kernel.prepare`).  `span(name)` marks a phase;
`root_span(name)` marks a top-level solve or tick, and is where the tracer
decides whether to record: while a torch.profiler session records, or
inside `tracing()`.  Off, a span costs one module-level bool test and
returns the shared `NO_SPAN`; it makes no profiler call.  On, each span
appends a `SpanRecord` to an in-memory buffer of the last `CAPACITY`
records (`records()`), stamped with `now_ns`, the clock torch.profiler
stamps its events with (`time.time_ns`), so a span and a device event of
one trace compare directly.  The spans are not profiler ranges: a range
would add a device-typed copy of itself to a CUDA trace, spanning the
device's idle gaps.

`host_read(site, fn)` is the fleet path's one way to read device data on
the host (or otherwise block on the device's queue): it counts the read
(`host_reads`; the solvers' `host_syncs` are its growth over a solve or
tick) and, when tracing, holds it in a `sync.<site>` span, so the span is
the host's blocked time.  Two sites are traced but not counted
(`UNCOUNTED`): the compaction driver's final read-back of statuses and
iterations (`FINAL_READBACK`), and the stop test of the forward kernel's
plain search (`PLAIN_SEARCH`), which stands in on the CPU for the kernel's
search on the card, where nothing is read.

The forward kernel's line search (`ops/forward.py:ForwardKernel.search`)
adds its tries, the lanes it searched and the lane tries its blocks ran
to a device-side triple per device (`search_counts`); the solvers keep a
solve's or a tick's growth of it on the device
(`ALSolverBatched.ls_counts`), read only where the caller asks or in a
read-back the solve makes anyway (`CompactedALSolver.telemetry`).
`ls_tries` turns it into tries per searched lane, and `ls_block_tries`
into lane tries run per searched lane: a block of the kernel runs each of
its lanes for as many tries as its slowest lane takes.

The tracer and the counts belong to the process, and assume that one
thread drives the solvers.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import time

import torch

# the clock of every span and of `Timer`: torch.profiler's (epoch ns)
now_ns = time.time_ns

CAPACITY = 1 << 18  # the records kept; older ones drop
FINAL_READBACK = "final_readback"
PLAIN_SEARCH = "plain_search"
UNCOUNTED = frozenset({FINAL_READBACK, PLAIN_SEARCH})  # the sites `host_reads` leaves out


class Timer:
    """Hierarchical profiler with named scopes."""

    def __init__(self, active: bool = False, device=None):
        self.active = active
        self.device = torch.device(device) if device is not None else None
        self._stack: list[str] = []
        self._times_us: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def reset(self) -> None:
        self._times_us.clear()
        self._counts.clear()
        self._stack.clear()

    @contextlib.contextmanager
    def scope(self, name: str, block: bool = False):
        """Time a named scope; keys join the live stack with "/"
        (`timer.cpp:96-106`)."""
        if not self.active:
            yield
            return
        self._stack.append(name)
        key = "/".join(self._stack)
        t0 = now_ns()
        try:
            yield
        finally:
            if block and self.device is not None and self.device.type == "cuda":
                # drain the device's queue so the scope holds its device time
                torch.cuda.synchronize(self.device)
            dt_us = (now_ns() - t0) * 1e-3
            self._times_us[key] = self._times_us.get(key, 0.0) + dt_us
            self._counts[key] = self._counts.get(key, 0) + 1
            self._stack.pop()

    @contextlib.contextmanager
    def trace_context(self, name: str, block: bool = False):
        """A scope that is also a range named `name` in a torch.profiler
        trace; nothing when the timer is inactive."""
        if not self.active:
            yield
            return
        with self.scope(name, block=block):
            with torch.profiler.record_function(name):
                yield

    def get_us(self, key: str) -> float:
        return self._times_us.get(key, 0.0)

    def summary(self) -> str:
        """Indented call-tree table (`timer.cpp:24-94`)."""
        if not self._times_us:
            return "(no profile data)\n"
        keys = sorted(self._times_us)
        roots = [k for k in keys if "/" not in k]
        total = sum(self._times_us[k] for k in roots)
        lines = [f"{'scope':<40}{'time (ms)':>12}{'%total':>9}{'%parent':>9}{'count':>8}"]

        def emit(key: str, depth: int):
            t = self._times_us[key]
            parent = key.rsplit("/", 1)[0] if "/" in key else None
            pt = self._times_us.get(parent, total) if parent else total
            name = "  " * depth + key.rsplit("/", 1)[-1]
            lines.append(
                f"{name:<40}{t / 1000:>12.3f}"
                f"{100 * t / total if total else 0:>8.1f}%"
                f"{100 * t / pt if pt else 0:>8.1f}%"
                f"{self._counts.get(key, 0):>8d}"
            )
            for c in keys:
                if c.startswith(key + "/") and "/" not in c[len(key) + 1:]:
                    emit(c, depth + 1)

        for r in roots:
            emit(r, 0)
        return "\n".join(lines) + "\n"

    def print_summary(self, file=None) -> None:
        print(self.summary(), file=file, end="")


# ------------------------------------------------------------------ tracer
class SpanRecord:
    """One span: its `name`, `start_ns` and `end_ns` (`now_ns`; `end_ns` is
    None while it is open), its `index` in the process's sequence of spans,
    the index of the span that encloses it (`parent`, -1 for none) and of
    its top-level span (`root`, its own index for a top-level span)."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "root")

    def __init__(self, name: str, index: int, parent: int, root: int):
        self.name, self.index, self.parent, self.root = name, index, parent, root
        self.start_ns = self.end_ns = None

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, index={self.index}, parent={self.parent}, root={self.root}, "
                f"start_ns={self.start_ns}, end_ns={self.end_ns})")


_on = False  # the tracer records: the one test a span makes when off
_stack: list = []  # the open spans, innermost last
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_next = 0  # the index of the next span
_reads = 0  # counted host reads of device data so far


class _NoSpan:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "owner")

    def __init__(self, name: str, owner: bool = False):
        self.name = name
        self.owner = owner  # a top-level span that turned the tracer on

    def __enter__(self) -> SpanRecord:
        global _next, _on
        up = _stack[-1] if _stack else None
        rec = SpanRecord(self.name, _next, -1 if up is None else up.index, _next if up is None else up.root)
        _next += 1
        if self.owner:
            _on = True
        _stack.append(rec)
        _records.append(rec)
        rec.start_ns = now_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        global _on
        rec = _stack.pop()
        rec.end_ns = now_ns()
        if self.owner:
            _on = False
        return False


def _profiling() -> bool:
    """Whether a torch.profiler session records in this process."""
    return torch.autograd.profiler._is_profiler_enabled or torch._C._autograd._profiler_enabled()


def span(name: str):
    """A phase of the fleet path, as a context manager: `NO_SPAN` when the
    tracer is off, else a span recorded under the innermost open one."""
    if not _on:
        return NO_SPAN
    return _Span(name)


def root_span(name: str):
    """A top-level solve or tick: turns the tracer on for its duration
    while a torch.profiler session records; a plain `span` inside another
    span or `tracing()`."""
    if _on:
        return _Span(name)
    if _profiling():
        return _Span(name, owner=True)
    return NO_SPAN


def host_read(site: str, fn):
    """`fn()`, a read of device data on the host, counted in `host_reads`
    (but for the `UNCOUNTED` sites) and, when tracing, held in the span
    `sync.<site>`."""
    global _reads
    if site not in UNCOUNTED:
        _reads += 1
    if not _on:
        return fn()
    with _Span("sync." + site):
        return fn()


def host_reads() -> int:
    """The process's counted host reads so far."""
    return _reads


_searches: dict = {}  # device -> int64 [3]: line-search tries, searched lanes, lane tries run


def search_counts(device) -> torch.Tensor:
    """The process's device-side sums on `device` of the forward kernel's
    line-search tries, of the lanes it searched (those with a budget) and
    of the lane tries its blocks ran (each block's slowest lane's tries
    times its lanes), int64 [3], which each search adds to on the
    device."""
    dev = torch.device(device)
    counts = _searches.get(dev)
    if counts is None:
        counts = _searches[dev] = torch.zeros(3, dtype=torch.int64, device=dev)
    return counts


def ls_tries(counts) -> float | None:
    """Tries per searched lane of (tries, searched lanes, lane tries run),
    host values of a growth of `search_counts`; None where no lane was
    searched."""
    tries, lanes, _ = (int(v) for v in counts)
    return tries / lanes if lanes else None


def ls_block_tries(counts) -> float | None:
    """Lane tries the kernel's blocks ran per searched lane, of the same
    counts as `ls_tries`: at least `ls_tries`, by the tries a lane sits
    out while the slowest lane of its block still searches."""
    _, lanes, run = (int(v) for v in counts)
    return run / lanes if lanes else None


def records() -> list:
    """The last `CAPACITY` spans recorded, oldest first."""
    return list(_records)


def open_span():
    """The innermost open span's record, or None."""
    return _stack[-1] if _stack else None


@contextlib.contextmanager
def tracing():
    """Record every span of the body, with or without a profiler:
    `with tracing() as spans:` fills `spans` with the body's records when
    it ends."""
    global _on
    out: list = []
    first = _next
    prev, _on = _on, True
    try:
        yield out
    finally:
        _on = prev
        # the body's records are the newest: read the buffer from its end
        mine = itertools.takewhile(lambda r: r.index >= first, reversed(_records))
        out.extend(reversed(list(mine)))

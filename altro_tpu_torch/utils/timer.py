"""Hierarchical wall-clock profiler (`altro_tpu/utils/timer.py`).

The host-side analog of the reference's `Timer`/`Stopwatch`/`ProfileEntry`
(`altro/common/timer.hpp:41-95`, `timer.cpp:10-134`,
`profile_entry.hpp:20-36`): nested named scopes add microseconds into
"al/ilqr/forward_pass"-style paths, and `summary` prints the call tree
with time, %total and %parent columns like `perf/profiler_unicycle.out`.

CUDA work is asynchronous, so a scope around it measures the launches
unless it blocks: `block=True` synchronizes the timer's `device` (a CUDA
device; nothing to wait for on the CPU) before the scope ends.
`trace_context` also marks the scope in a `torch.profiler` trace (the
per-instance solver's phases use it).  An inactive timer costs one
attribute test per scope.
"""
from __future__ import annotations

import contextlib
import time

import torch


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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block and self.device is not None and self.device.type == "cuda":
                # drain the device's queue so the scope holds its device time
                torch.cuda.synchronize(self.device)
            dt_us = (time.perf_counter() - t0) * 1e6
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

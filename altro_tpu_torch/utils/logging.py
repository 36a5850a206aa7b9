"""Tabular, colored console logger for solver iterations
(`altro_tpu/utils/logging.py`).

Host-side analog of `SolverLogger`/`LogEntry`
(`altro/common/solver_logger.hpp:53-215`, `log_entry.hpp:27-229`): ordered
columns with format strings and widths, verbosity levels per column,
tolerance-bound-based coloring (green below lower bound, red above upper),
and periodic header reprinting.  The batched solver prints its live fleet
rows through it (`solver/batched.py:_emit_outer_row`), each after one read
of the device's values.
"""
from __future__ import annotations

import dataclasses
import math
import sys

from ..options import LogLevel

_RESET = "\x1b[0m"
_GREEN = "\x1b[32m"
_RED = "\x1b[31m"
_YELLOW = "\x1b[33m"


@dataclasses.dataclass
class LogEntry:
    """One column (`log_entry.hpp:45-229`)."""

    title: str
    fmt: str = "{:>.4g}"
    width: int = 10
    level: LogLevel = LogLevel.INNER
    lower_bound: float = -math.inf
    upper_bound: float = math.inf
    is_int: bool = False

    def format_value(self, value, color: bool) -> str:
        if value is None:
            s = ""
        else:
            v = int(value) if self.is_int else float(value)
            s = self.fmt.format(v)
            if color and not self.is_int:
                if v < self.lower_bound:
                    s = f"{_GREEN}{s}{_RESET}"
                elif v > self.upper_bound:
                    s = f"{_RED}{s}{_RESET}"
        pad = self.width - _visible_len(s)
        return " " * max(pad, 0) + s


def _visible_len(s: str) -> int:
    n = 0
    skip = False
    for ch in s:
        if ch == "\x1b":
            skip = True
        elif skip and ch == "m":
            skip = False
        elif not skip:
            n += 1
    return n


class SolverLogger:
    """Ordered-column iteration logger (`solver_logger.hpp:53-215`) with
    the batched solver's fleet columns: each row summarizes the whole
    lockstep batch (the batched analog of the reference's per-iteration
    rows, `solver_logger.cpp:47-54`)."""

    def __init__(self, level: LogLevel = LogLevel.SILENT, color: bool = True, frequency: int = 10):
        self.level = LogLevel(level)
        self.color = color and sys.stdout.isatty()
        # header reprint period (`SolverOptions.header_frequency`,
        # `solver_logger.cpp:47-54`)
        self.frequency = max(int(frequency), 1)
        self._count = 0
        self.entries: dict[str, LogEntry] = {}
        self._order: list[str] = []
        self._current: dict[str, object] = {}
        add = self.add_entry
        add(LogEntry("iters", "{:>4d}", 6, LogLevel.INNER, is_int=True))
        add(LogEntry("iter_al", "{:>4d}", 8, LogLevel.OUTER, is_int=True))
        add(LogEntry("active", "{:>5d}", 8, LogLevel.INNER, is_int=True))
        add(LogEntry("solved", "{:>5d}", 8, LogLevel.OUTER, is_int=True))
        add(LogEntry("viol_max", "{:>.3e}", 12, LogLevel.OUTER))
        add(LogEntry("cost_med", "{:>.4g}", 11, LogLevel.INNER))
        add(LogEntry("dJ_med", "{:>.2e}", 10, LogLevel.INNER))
        add(LogEntry("alpha_med", "{:>.2f}", 10, LogLevel.INNER_DEBUG))
        add(LogEntry("grad_med", "{:>.2e}", 10, LogLevel.OUTER_DEBUG))
        add(LogEntry("pen_max", "{:>.1e}", 9, LogLevel.OUTER_DEBUG))

    def add_entry(self, entry: LogEntry):
        self.entries[entry.title] = entry
        self._order.append(entry.title)
        return entry

    def active(self, title: str) -> bool:
        return self.entries[title].level <= self.level

    def log(self, title: str, value) -> None:
        if title in self.entries:
            self._current[title] = value

    def print_header(self) -> None:
        if self.level <= LogLevel.SILENT:
            return
        cols = [t for t in self._order if self.active(t)]
        line = "".join(f"{t:>{self.entries[t].width}}" for t in cols)
        if self.color:
            line = f"{_YELLOW}{line}{_RESET}"
        print(line)
        print("-" * sum(self.entries[t].width for t in cols))

    def print_row(self) -> None:
        if self.level <= LogLevel.SILENT:
            return
        if self._count % self.frequency == 0:
            self.print_header()
        self._count += 1
        cols = [t for t in self._order if self.active(t)]
        print(
            "".join(
                self.entries[t].format_value(self._current.get(t), self.color)
                for t in cols
            )
        )
        self._current.clear()

"""Tabular, colored console logger for solver iterations
(`altro_tpu/utils/logging.py`).

Host-side analog of `SolverLogger`/`LogEntry`
(`altro/common/solver_logger.hpp:53-215`, `log_entry.hpp:27-229`): ordered
columns with format strings and widths, verbosity levels per column,
tolerance-bound-based coloring (green below lower bound, red above upper),
and periodic header reprinting.  The per-instance solver prints its live
rows through it (`solver/ilqr.py`, `solver/al.py`), and the batched solver
its fleet rows (`solver/batched.py:_emit_outer_row`), each after one read
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
    """Ordered-column iteration logger (`solver_logger.hpp:53-215`).

    The per-instance columns mirror `SolverStats::DefaultLogger`
    (`solver_stats.cpp:80-114`); `fleet=True` gives the batched solver's
    fleet columns instead, each row summarizing the whole lockstep batch
    (the batched analog of the reference's per-iteration rows,
    `solver_logger.cpp:47-54`).
    """

    def __init__(self, level: LogLevel = LogLevel.SILENT, color: bool = True, frequency: int = 10,
                 fleet: bool = False):
        self.level = LogLevel(level)
        self.color = color and sys.stdout.isatty()
        # header reprint period (`SolverOptions.header_frequency`,
        # `solver_logger.cpp:47-54`)
        self.frequency = max(int(frequency), 1)
        self._count = 0
        self.entries: dict[str, LogEntry] = {}
        self._order: list[str] = []
        self._current: dict[str, object] = {}
        if fleet:
            self._fleet_columns()
        else:
            self._default_columns()

    def _default_columns(self):
        add = self.add_entry
        add(LogEntry("iters", "{:>4d}", 6, LogLevel.OUTER_DEBUG, is_int=True))
        add(LogEntry("iter_al", "{:>4d}", 8, LogLevel.OUTER, is_int=True))
        add(LogEntry("cost", "{:>.4g}", 10, LogLevel.INNER))
        add(LogEntry("viol", "{:>.3e}", 12, LogLevel.OUTER))
        add(LogEntry("dJ", "{:>.2e}", 10, LogLevel.INNER))
        add(LogEntry("grad", "{:>.2e}", 10, LogLevel.OUTER_DEBUG))
        add(LogEntry("alpha", "{:>.2f}", 6, LogLevel.INNER))
        add(LogEntry("reg", "{:>.1e}", 9, LogLevel.INNER_DEBUG))
        add(LogEntry("z", "{:>.3f}", 7, LogLevel.INNER_DEBUG))
        add(LogEntry("pen", "{:>.1e}", 9, LogLevel.DEBUG))

    def _fleet_columns(self):
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

    def reset(self) -> None:
        """Restart the header cadence (a new solve)."""
        self._count = 0
        self._current.clear()

    def add_entry(self, entry: LogEntry):
        self.entries[entry.title] = entry
        self._order.append(entry.title)
        return entry

    def set_tolerances(self, cost=1e-4, viol=1e-4, grad=1e-2):
        """Colour thresholds (`solver_stats.cpp:16-23`): on the cost
        decrease, violation and gradient columns, or the fleet's medians and
        largest violation."""
        for titles, bound in ((("dJ", "dJ_med"), cost), (("viol", "viol_max"), viol),
                              (("grad", "grad_med"), grad)):
            for title in titles:
                if title in self.entries:
                    self.entries[title].lower_bound = bound

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

    def _print_current(self) -> None:
        cols = [t for t in self._order if self.active(t)]
        print("".join(self.entries[t].format_value(self._current.get(t), self.color) for t in cols))
        self._current.clear()

    def print_row(self) -> None:
        if self.level <= LogLevel.SILENT:
            return
        if self._count % self.frequency == 0:
            self.print_header()
        self._count += 1
        self._print_current()

    def print_solve_summary(self, stats, status=None) -> None:
        """A finished per-instance solve's history rows (`SolverStats`) as
        the iteration table the reference prints live, one read of the
        rows."""
        from ..types import _COLUMNS, SolverStatus

        if self.level <= LogLevel.SILENT:
            return
        rows = stats.rows[: stats.length].detach().cpu().tolist()
        titles = dict(cost="cost", alpha="alpha", improvement_ratio="z", gradient="grad",
                      cost_decrease="dJ", regularization="reg", violations="viol", max_penalty="pen")
        self.print_header()
        for i, row in enumerate(rows):
            self.log("iters", i + 1)
            for name, v in zip(_COLUMNS, row):
                self.log(titles[name], v)
            self._count += 1  # no header reprint inside the table
            self._print_current()
        if status is not None:
            print(f"status: {SolverStatus(int(status)).name}")

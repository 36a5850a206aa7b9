"""Traffic of kind `fleet`: closed-loop back-to-back solves of the whole
fleet, each from the initial states of the pool member the seed's order
gives it.  The window holds whole cycles through the pool: it closes at the
end of the cycle during which `--seconds` pass; every solve in it counts.
"""
from __future__ import annotations

import time

import torch

from . import traffic as tr
from .trace import span, traced


def _x0(run, which):
    t = run.cell.traffic
    return tr.pool_x0(t, run.x0_canonical, t["lanes"], which, run.device, run.dtype)


def warm_up(run, sut) -> None:
    t = run.cell.traffic
    for i in range(int(t.get("warm_solves", 1))):
        sut.solve(_x0(run, i % int(t["pool"])))
    run.sync()


def window(run, sut) -> None:
    t = run.cell.traffic
    lanes, k = t["lanes"], int(t["check"]["lanes_per_solve"])
    keep = dict(x0=[], X=[], U=[], solved=[])
    solved_total = torch.zeros((), dtype=torch.int64, device=run.device)
    syncs, tails = [], []
    i = 0
    run.window_start()
    while True:
        x0 = _x0(run, tr.member(t, run.seed, i))
        with span("fleet.solve"):
            out = sut.solve(x0)
        solved_total += out["solved"].sum()
        idx = torch.as_tensor(tr.sample(run.seed, i, lanes, k, always=(0,) if i == 0 else ()), device=run.device)
        for key, v in (("x0", x0), ("X", out["X"]), ("U", out["U"]), ("solved", out["solved"])):
            keep[key].append(v.index_select(0, idx))
        run.sync()
        end = time.perf_counter()
        c = sut.counters()
        syncs.append(c.get("host_syncs"))
        tails.append(c.get("tail_rounds"))
        i += 1
        if tr.cycle_done(t, i - 1) and end - run.t_window >= run.seconds:
            break
    n_solved = int(solved_total)
    run.window.update(solves=i, plans=n_solved, span_s=end - run.t_window)
    run.attempted, run.failed = i * lanes, i * lanes - n_solved
    run.counters.update(host_syncs_per_solve=syncs, tail_rounds_per_solve=tails)
    run.records = {key: torch.cat(v) for key, v in keep.items()}


def trace(run, sut) -> None:
    """Two more solves, traced: the first over the device alone, with its
    kernels' launches counted; the second over host and device, for the
    names of the idle gaps."""
    before = sut.launch_counts()
    out, named = {}, {}
    with traced(out, host=False):
        with span("fleet.solve"):
            sut.solve(_x0(run, 0))
    after = sut.launch_counts()
    with traced(named, host=True):
        with span("fleet.solve"):
            sut.solve(_x0(run, 1 % int(run.cell.traffic["pool"])))
    run.trace, run.trace_named = out["trace"], named["trace"]
    run.launches = {k: [(w, a - b) for (w, b), (_, a) in zip(before[k], after[k])] for k in after}

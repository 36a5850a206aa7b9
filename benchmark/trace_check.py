#!/usr/bin/env python3
"""Check the program's tracer on the card, cell by cell, and print one JSON
line a cell (with `--out`, append them to that file too):

    python3 benchmark/trace_check.py [--cells a,b] [--seed n] [--cost-reps k] [--cost-ticks t] [--out f]

(`--device cpu --lanes 8` rehearses it on the CPU at a tiny size, with no
sync check.)

- `sync_debug`: `torch.cuda.set_sync_debug_mode("warn")` around one solve
  (one warm tick), every synchronising CUDA call by source line and by the
  program span open at it, against the solver's `host_syncs` plus the
  compaction driver's final read-back;
- `profiling`: whether the tracer sees a CUDA-only profiler session;
- the cell's traced stretches as the benchmark makes them: the root spans
  against the benchmark's host ranges and against the device's first and
  last activity, the idle split by layer and by innermost span, the syncs
  by site, and the per-layer metrics;
- `cost`: solves (ticks) with the tracer off and inside `tracing()`, in
  turns, as `plans_per_s` (`tick_p95_ms` and the median tick).

Without a CUDA card (and `--device cpu`) it exits 2.
"""
import argparse
import collections
import json
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELLS = ("parking.fleet32k", "quadrotor.fleet8k", "parking.mpc32k")


def _sync_debug(call, timer, cuda: bool):
    """Every synchronising CUDA call of `call()`: (file:line, open span)."""
    import torch

    seen = []
    if not cuda:
        with timer.tracing() as spans:
            out = call()
        return seen, spans, out

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            rec = timer.open_span()
            where = f"{Path(filename).name}:{lineno}"
            if rec is None:  # outside the program's spans: say where from
                where = " < ".join(f"{Path(f.filename).parent.name}/{Path(f.filename).name}:{f.lineno}"
                                   for f in traceback.extract_stack()[-6:-1])
            seen.append((where, rec.name if rec is not None else None))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old, warnings.showwarning = warnings.showwarning, hook
        try:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with timer.tracing() as spans:
                    out = call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        finally:
            warnings.showwarning = old
    return seen, spans, out


def _stretch(run, tr, named: bool):
    """The root spans of a traced stretch against the benchmark's ranges
    (host-and-device) or the device's activity (device only), the idle
    split, and the syncs by site."""
    from benchmark.harness import spans as sp

    got = sp.in_stretch(tr)
    if got is None:
        return dict(spans=0)
    roots = [x for x in got if x[3].parent < 0]
    out = dict(spans=len(got), roots=[x[0] for x in roots])
    if named:
        rngs = sorted((r for r in tr.ranges if r.name in ("bench.fleet.solve", "bench.mpc.step")),
                      key=lambda r: r.start_us)
        out["root_vs_range_us"] = [
            [x[0], round(x[1] - r.start_us, 1), round(r.end_us - x[2], 1)]
            for x, r in zip(roots, rngs)]
        if rngs and roots:  # the host's work between the first range's start and its root's
            out["before_first_root"] = [[h.name, round(h.start_us - rngs[0].start_us, 1), round(h.dur_us, 1)]
                                        for h in tr.host_ops if rngs[0].start_us <= h.start_us < roots[0][1]][:12]
    else:
        # the clocks: a host read that waited ends after the device's last
        # activity before it (its wake-up); a read that ends while the
        # device is busy would mean the device's clock runs late
        union = tr._union
        wake, busy_at_end, overhang, series = [], 0, [], []
        for x in got:
            if not x[0].startswith("sync."):
                continue
            at_start = [u for u in union if u[0] <= x[1] < u[1]]
            if not at_start:
                continue  # the device was idle: no wait
            over = [u[1] - x[2] for u in union if u[0] < x[2] < u[1]]
            if over:
                busy_at_end += 1
                overhang.append(over[0])
                series.append([round((x[2] - tr._t0) * 1e-3, 3), round(over[0], 1)])
                continue
            series.append([round((x[2] - tr._t0) * 1e-3, 3), -round(x[2] - max(u[1] for u in union if u[1] <= x[2]), 1)])
            ends = [u[1] for u in union if u[1] <= x[2]]
            wake.append(x[2] - max(ends))
        wake.sort()
        out["waited_syncs"] = dict(n=len(wake), device_busy_at_end=busy_at_end,
                                   wake_us_min=wake[0] if wake else None,
                                   wake_us_median=wake[len(wake) // 2] if wake else None,
                                   wake_us_p90=wake[int(0.9 * (len(wake) - 1))] if wake else None,
                                   overhang_us=sorted(overhang)[::max(1, len(overhang) // 10)],
                                   series_ms_us=series)
        dev = sorted(tr.device, key=lambda d: d.start_us)
        out["first_kernel_after_root_us"] = round(dev[0].start_us - roots[0][1], 1) if dev and roots else None
        out["root_end_after_last_kernel_us"] = round(roots[-1][2] - max(d.end_us for d in dev), 1) if dev and roots else None
    split = sp.idle_split(tr, got)
    idle = tr.window_s - tr.busy_s
    out["window_s"], out["idle_pct"] = tr.window_s, 100.0 * idle / tr.window_s
    out["idle_split_pct"] = {k: 100.0 * v / tr.window_s for k, v in split.items()}
    out["split_sum_minus_idle_pct"] = 100.0 * (sum(split.values()) - idle) / tr.window_s
    # the idle time by the innermost span's own name
    by_name = collections.Counter()
    segs = sp.innermost(got, key=lambda name: name)
    for gs, ge in tr.idle_gaps():
        covered = 0.0
        for s, e, name in segs:
            if e <= gs or s >= ge:
                continue
            ov = min(e, ge) - max(s, gs)
            by_name[name] += ov
            covered += ov
        by_name[None] += ge - gs - covered
    out["idle_by_span_pct"] = {str(k): round(100.0 * v * 1e-6 / tr.window_s, 3) for k, v in by_name.most_common(20)}
    n = max(1, len(roots))
    syncs = collections.Counter(x[0] for x in got if x[0].startswith("sync."))
    out["syncs_by_site_per_root"] = {k: v / n for k, v in sorted(syncs.items())}
    span_s = collections.Counter()
    for x in got:
        span_s[x[0]] += (x[2] - x[1]) * 1e-6
    out["span_seconds_per_root"] = {k: round(v / n, 5) for k, v in span_s.most_common(25)}
    return out


def _clock(call, timer) -> dict:
    """One call traced over host and device: each kernel's start after its
    launch (the runtime call of the same correlation id) on the profiler's
    two clocks, and where the program's host reads end against the
    device's activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    first = timer._next
    with profile(activities=acts) as prof:
        call()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    launch, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        dev = "CPU" not in str(e.device_type())
        if not dev and e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync")):
            launch[e.correlation_id()] = (e.name(), e.start_ns())
        elif dev:
            kernels.append((e.correlation_id(), e.start_ns(), e.end_ns(), e.name()[:60]))
    pairs = [(launch[c][0], n, (s - launch[c][1]) * 1e-3) for c, s, _, n in kernels if c in launch]
    lag = sorted(x[2] for x in pairs)
    negative = collections.Counter((a, n) for a, n, x in pairs if x < 0)
    busy = sorted((s * 1e-3, e * 1e-3, n) for _, s, e, n in kernels)
    inside = []
    for r in (r for r in timer.records() if r.index >= first and r.name.startswith("sync.")):
        end = r.end_ns * 1e-3
        cover = [(e - end, round(end - s, 1), n, r.name) for s, e, n in busy if s < end < e]
        if cover:
            inside.append(max(cover))
    inside.sort()
    q = (lambda v, f: round(v[int(f * (len(v) - 1))], 2) if v else None)
    return dict(kernels=len(kernels), matched=len(lag), lag_us_min=q(lag, 0), lag_us_p01=q(lag, 0.01),
                lag_us_median=q(lag, 0.5), negative=sum(x < 0 for x in lag),
                negative_by_name=[[a, n, c] for (a, n), c in negative.most_common(8)],
                syncs_ending_in_device_work=len(inside),
                overhang=[[round(o, 1), age, n, site] for o, age, n, site in inside[::max(1, len(inside) // 12)]])


def check(cell_name: str, seed: int, cost_reps: int, cost_ticks: int, device: str = "cuda",
          lanes: int = 0, ab_reps: int = 2) -> dict:
    import torch

    from altro_tpu_torch.utils import timer
    from benchmark.harness import fleet, mpc, runner, spec

    cell = spec.load_cell(cell_name)
    if lanes:
        cell.traffic["lanes" if cell.traffic["kind"] == "fleet" else "controllers"] = lanes
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = runner.Run(cell=cell, seed=seed, seconds=0.0, t_start=time.perf_counter(), device=dev)
    kind = cell.traffic["kind"]
    sut = runner.make_sut(run)
    driver = runner.DRIVERS[kind]
    t0 = time.perf_counter()
    driver.warm_up(run, sut)
    out = dict(cell=cell_name, device=torch.cuda.get_device_name(dev) if cuda else "cpu",
               warm_up_s=time.perf_counter() - t0)

    # the tracer under a CUDA-only profiler session
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]):
        out["profiling"] = dict(python_flag=bool(torch.autograd.profiler._is_profiler_enabled),
                                c_flag=bool(torch._C._autograd._profiler_enabled()),
                                root_on=timer.root_span("probe") is not timer.NO_SPAN)

    if kind == "fleet":
        x0 = fleet._x0(run, 0)
        call = lambda: sut.solve(x0)  # noqa: E731
        final = 1 if sut.driver == "compacted" else 0
    else:
        plant = mpc.Plant(run)
        st = [sut.init(cell.traffic["controllers"]), mpc._x0(run, 0)]
        for _ in range(3):
            u, st[0], _ = sut.step(st[0], st[1])
            st[1] = plant(st[1], u)

        def call():
            u, st[0], _ = sut.step(st[0], st[1])
            return u

        final = 0
    seen, spans, _ = _sync_debug(call, timer, cuda)
    syncs = sut.counters()["host_syncs"]
    by_line = collections.Counter(f"{f} [{s}]" for f, s in seen)
    by_site = collections.Counter(r.name for r in spans if r.name.startswith("sync."))
    out["sync_debug"] = dict(sync_calls=len(seen), host_syncs=syncs, final_readback=final,
                             equal=len(seen) == syncs + final, by_line=dict(by_line.most_common()),
                             sync_spans_by_site=dict(sorted(by_site.items())),
                             outside_sync_spans=sum(1 for _, s in seen if s is None or not s.startswith("sync.")))

    # the benchmark's own traced stretches, with the tracer off (the
    # profiler's session not shown to it) and on, in turns: the tracer's
    # cost in the traced stretches, and no device work of its own
    ab = []
    shown = timer._profiling
    for rep in range(ab_reps):
        for on in ((True, False) if rep % 2 == 0 else (False, True)):
            timer._profiling = shown if on else (lambda: False)
            try:
                driver.trace(run, sut)
            finally:
                timer._profiling = shown
            ab.append(dict(on=on, device_only=[run.trace.window_s, run.trace.busy_s],
                           host_and_device=[run.trace_named.window_s, run.trace_named.busy_s]))
    out["traced_ab"] = ab
    out["clock"] = _clock(call, timer)
    driver.trace(run, sut)
    out["device_only"] = _stretch(run, run.trace, named=False)
    out["host_and_device"] = _stretch(run, run.trace_named, named=True)
    metrics = runner.read_metrics(run, cell.per_layer)
    out["per_layer"] = {k: v["value"] for k, v in metrics.items()}

    # the tracer's cost on this host: a span and a host read, off and on
    import timeit

    reps = 100_000
    per = {}
    per["span_off_us"] = 1e6 * timeit.timeit(lambda: timer.span("x").__enter__(), number=reps) / reps
    with timer.tracing():
        def on():
            with timer.span("x"):
                pass
        per["span_on_us"] = 1e6 * timeit.timeit(on, number=reps) / reps
    per["host_read_off_us"] = 1e6 * timeit.timeit(lambda: timer.host_read("x", int), number=reps) / reps
    out["per_call"] = per

    # the tracer's cost: off and on in turns
    sync()
    if (cost_reps if kind == "fleet" else cost_ticks) <= 0:
        return out
    if kind == "fleet":
        solved = {False: 0, True: 0}
        secs = {False: 0.0, True: 0.0}
        for rep in range(cost_reps):
            for on in ((False, True) if rep % 2 == 0 else (True, False)):
                x0 = fleet._x0(run, (rep + 2) % int(cell.traffic["pool"]))
                sync()
                t = time.perf_counter()
                if on:
                    with timer.tracing() as sp:
                        o = sut.solve(x0)
                else:
                    o = sut.solve(x0)
                n = int(o["solved"].sum())
                secs[on] += time.perf_counter() - t
                solved[on] += n
                if on:
                    out.setdefault("spans_per_solve", len(sp))
        out["cost"] = {("on" if k else "off"): dict(plans_per_s=solved[k] / secs[k], seconds=secs[k]) for k in secs}
        out["cost"]["on_over_off"] = out["cost"]["on"]["plans_per_s"] / out["cost"]["off"]["plans_per_s"]
    else:
        ticks = {False: [], True: []}
        plant = mpc.Plant(run)
        for rep in range(6):
            on = rep % 2 == 1
            state, x = sut.init(cell.traffic["controllers"]), mpc._x0(run, rep % int(cell.traffic["pool"]))
            for _ in range(cost_ticks):
                sync()
                t = time.perf_counter()
                if on:
                    with timer.tracing() as sp:
                        u, state, _ = sut.step(state, x)
                        u.cpu()
                else:
                    u, state, _ = sut.step(state, x)
                    u.cpu()
                ticks[on].append(time.perf_counter() - t)
                if on:
                    out.setdefault("spans_per_tick", len(sp))
                x = plant(x, u)
        out["cost"] = {("on" if k else "off"): dict(
            tick_p95_ms=1e3 * statistics.quantiles(v, n=100, method="inclusive")[94],
            tick_p50_ms=1e3 * statistics.median(v), ticks=len(v)) for k, v in ticks.items()}
        out["cost"]["p95_on_over_off"] = out["cost"]["on"]["tick_p95_ms"] / out["cost"]["off"]["tick_p95_ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    ap.add_argument("--cost-reps", type=int, default=8)
    ap.add_argument("--cost-ticks", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=0)
    ap.add_argument("--ab-reps", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_check: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    for name in args.cells.split(","):
        line = json.dumps(check(name, args.seed, args.cost_reps, args.cost_ticks, args.device, args.lanes,
                                args.ab_reps))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

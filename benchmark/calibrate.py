#!/usr/bin/env python3
"""Readings of a cell's correctness check over many seeds in one process,
for the program and for the control (the reference in a lower precision in
the program's place), from which the limits in `benchmark/limits/` are set.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 --seconds 5 \
        [--control [DTYPE]] [--check key=value ...] [--traffic key=value ...]

`--control` puts the reference in the program's place, in bfloat16 (the
control) or in the precision given, with the cell's `control_options`:
`--control float32` is the witness that a reading of the control comes
from its precision and not from those options.  One system is built and
warmed up once; each seed then runs a window of
`--seconds` and the check, and prints one JSON line of readings.  `--check`
overrides the traffic file's `check` block (how much each window samples),
so that a short window compares as many answers as a full run does;
`--traffic` overrides its top-level numbers (a control's shorter episodes,
whose ticks take seconds).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", nargs="?", const="bfloat16", default=None,
                    choices=("bfloat16", "float16", "float32", "float64"))
    ap.add_argument("--check", nargs="*", default=[])
    ap.add_argument("--traffic", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import runner, spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = spec.load_cell(args.workload)
    for kv in args.check:
        key, value = kv.split("=")
        cell.traffic["check"][key] = int(value)
    for kv in args.traffic:
        key, value = kv.split("=")
        cell.traffic[key] = int(value)
    dev = torch.device(args.device)
    driver = runner.DRIVERS[cell.traffic["kind"]]
    first = runner.Run(cell=cell, seed=args.seeds[0], seconds=args.seconds, t_start=time.perf_counter(), device=dev)
    system = runner.make_sut(first, None if args.control is None else getattr(torch, args.control))
    driver.warm_up(first, system)
    for seed in args.seeds:
        run = runner.Run(cell=cell, seed=seed, seconds=args.seconds, t_start=time.perf_counter(), device=dev)
        driver.window(run, system)
        t = time.perf_counter()
        ok, _, numbers = runner.correctness(run)
        window = {k: v for k, v in run.window.items() if k != "ticks"}
        if "ticks" in run.window:
            ticks = sorted(run.window["ticks"])
            window.update(ticks=len(ticks), tick_ms={q: 1e3 * ticks[min(len(ticks) - 1, int(q / 100 * len(ticks)))]
                                                    for q in (5, 50, 90, 95, 99)})
        mode = f"control_{args.control}" if args.control else "program"
        print(json.dumps(dict(workload=cell.name, mode=mode, seed=seed, correct=ok, attempted=run.attempted,
                              failed=run.failed, window=window, check_s=time.perf_counter() - t,
                              readings=numbers)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

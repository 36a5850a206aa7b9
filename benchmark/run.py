#!/usr/bin/env python3
"""Run one cell of the benchmark of `altro_tpu_torch` once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in BENCHMARK.json, builds the program and warms up
every shape the cell uses (set-up), measures for `--seconds`, optionally
traces a steady stretch (`--trace 1`), checks what the timed path produced
against the plain reference, and prints one JSON line last on standard
output: the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`.  Without a CUDA card it exits 2 and prints no
result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache a run writes stays inside the checkout, at fixed paths
    cache = ROOT / "benchmark" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    line = runner.execute(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    runner.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

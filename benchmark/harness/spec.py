"""Everything a run takes from files, found by name: the cell in
`BENCHMARK.json`, its configuration (`configs/<config>.json`), its traffic
mix (`traffic/<traffic>.json`), the limits of its correctness check
(`limits/<cell>.json`), the readers of its metrics (`metrics/<metric>.py`)
and the program's builder of its problem (`program/<name>.py`); the plain
reference finds its model and constraint kinds the same way
(`reference/models/<model>.py`, `reference/constraints/<kind>.py`).
Adding a cell, a configuration, a model, a traffic mix or a metric adds
files and entries; no code here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # and with --trace 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def load_module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod

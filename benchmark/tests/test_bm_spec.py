"""BENCHMARK.json against the contract's form, and every name in it found
as a file."""
import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = dict(
    top={"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    config={"name", "source", "file", "reduced", "why"},
    workload={"name", "config", "traffic", "chips", "why"},
    end_to_end={"name", "unit", "better", "bound", "source"},
    per_layer={"name", "unit", "better", "source", "layer", "moves"},
)


@pytest.fixture(scope="module")
def bench():
    with open(spec.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_keys(bench):
    assert set(bench) == KEYS["top"]
    assert bench["command"][1:] == ["benchmark/run.py"] and bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    for kind, key in (("config", "configs"), ("workload", "workloads")):
        for e in bench[key]:
            assert set(e) == KEYS[kind], e
    for kind in ("end_to_end", "per_layer"):
        for e in bench[kind]:
            assert set(e) - {"workloads"} == KEYS[kind], e
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    for w in bench["command"]:
        assert _line(w)


def test_metrics_cover_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 0.01 <= e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for cell in cells:
        reported = [m for m in e2e.values() if cell in m.get("workloads", cells)]
        assert len(reported) >= 2, cell
        layers = [m for m in bench["per_layer"] if cell in m.get("workloads", cells)]
        assert layers, cell
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (spec.BENCH_DIR / "program" / f"{cfg['program']}.py").is_file()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.traffic["kind"] in ("fleet", "mpc")
        assert cell.limits["limits"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)

"""A new cell, traffic mix, metric, configuration and model take only new
files and entries: a copy of the benchmark gains them and runs the new
cells on the CPU, checked against the plain reference, without an edit to
any file it had."""
import json
import shutil
import subprocess
import sys
import textwrap

from benchmark.harness import spec

SCRIPT = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, ".")
    import torch
    torch.set_num_threads(2)
    from benchmark.harness import runner, spec
    name = sys.argv[1]
    cell = spec.load_cell(name)
    run = runner.Run(cell=cell, seed=2**33 + 5, seconds=0.1, t_start=time.perf_counter(), device=torch.device("cpu"))
    driver = runner.DRIVERS[cell.traffic["kind"]]
    sut = runner.make_sut(run)
    driver.warm_up(run, sut)
    driver.window(run, sut)
    ok, checks, numbers = runner.correctness(run)
    print(json.dumps(dict(ok=ok, config=cell.config["name"], lanes=cell.traffic["lanes"], numbers=numbers,
                          metrics=runner.read_metrics(run, cell.end_to_end + cell.per_layer))))
""")

# a model the benchmark did not know: the cart-pole swing-up (the zoo's),
# its plain dynamics written from the equations, not taken from the program
CARTPOLE = textwrap.dedent("""
    \"\"\"Cart-pole: x = (p, θ, ṗ, θ̇), θ = 0 hanging down; u = the cart's force.\"\"\"
    import torch


    def dynamics(x, u, params):
        mc, mp, l, g = params["mass_cart"], params["mass_pole"], params["length"], params["gravity"]
        th, pd, thd, f = x[..., 1], x[..., 2], x[..., 3], u[..., 0]
        s, c = torch.sin(th), torch.cos(th)
        den = mc + mp * s * s
        pdd = (f + mp * s * (l * thd * thd + g * c)) / den
        thdd = (-f * c - mp * l * thd * thd * c * s - (mc + mp) * g * s) / (l * den)
        return torch.stack([pd, thd, pdd, thdd], dim=-1)
""")
PROGRAM = textwrap.dedent("""
    def build(cfg, device, dtype):
        from altro_tpu_torch.models.problems import zoo_cartpole

        pb = cfg["problem"]
        prob, Z0, _, _ = zoo_cartpole(N=int(pb["N"]), tf=float(pb["tf"]), dtype=dtype, device=device)
        return prob, Z0
""")
CONFIG = dict(
    name="cartpole", source="the zoo's cart-pole swing-up", program="zoo_cartpole",
    problem=dict(model="cartpole", model_params=dict(mass_cart=1.0, mass_pole=0.3, length=0.5, gravity=9.81),
                 integrator="rk4", n=4, m=1, N=60, tf=2.0, h_in_float32=False, x0=[0.0, 0.0, 0.0, 0.0],
                 xf=[0.0, 3.141592653589793, 0.0, 0.0], u0=0.01, uref=0.0,
                 cost=dict(Q_diag=0.01, R_diag=0.1, stage_weights_times_h=True, Qf_diag=100.0),
                 constraints=dict(bound=dict(lower=-10.0, upper=10.0))),
    program_constraints={"Control Bound": "bound"}, dtype="float64",
    solver=dict(driver="batched", options=dict()),
    kernel_work=dict(model_ops=[30, 60]), reduced=[], assumed=[])


def _run(cwd, cell):
    out = subprocess.run([sys.executable, "-c", SCRIPT, cell], cwd=cwd, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_cell_traffic_and_metric_from_files_alone(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    new = {
        # a traffic mix, a cell's limits and a metric on a configuration it had
        "traffic/fleet_tiny.json": json.dumps(dict(
            kind="fleet", lanes=4, x0=dict(draw="uniform", half_width=0.05, lane0_canonical=True), pool=2,
            pool_seed=7, warm_solves=1, check=dict(lanes_per_solve=2))),
        "limits/parking.tiny.json": (spec.BENCH_DIR / "limits" / "parking.fleet32k.json").read_text(),
        "metrics/solves.tiny.py": 'def read(run):\n    return run.window.get("solves")\n',
        # a configuration of a model it did not know, and its cell
        "reference/models/cartpole.py": CARTPOLE,
        "program/zoo_cartpole.py": PROGRAM,
        "configs/cartpole.json": json.dumps(CONFIG),
        "traffic/fleet_tiny_normal.json": json.dumps(dict(
            kind="fleet", lanes=3, x0=dict(draw="normal", std=0.05), pool=2, pool_seed=11, warm_solves=1,
            check=dict(lanes_per_solve=3))),
        "limits/cartpole.tiny.json": json.dumps(dict(
            # both sides in float64 with the same options: they agree to
            # about 1e-10 (a wrong model reads far off)
            reference=dict(dtype="float64", options={}),
            limits=dict(u_gap=1e-6, cost_gap=1e-9, violation=1e-4, dynamics_gap=1e-9))),
    }
    for rel, text in new.items():
        assert not (tmp_path / "benchmark" / rel).exists(), rel
        (tmp_path / "benchmark" / rel).write_text(text)
    # the new entries
    bench["configs"].append(dict(name="cartpole", source="https://github.com/RoboticExplorationLab/TrajectoryOptimization.jl",
                                 file="benchmark/configs/cartpole.json", reduced=[], why="test"))
    bench["workloads"] += [dict(name="parking.tiny", config="parking", traffic="fleet_tiny", chips=1, why="test"),
                           dict(name="cartpole.tiny", config="cartpole", traffic="fleet_tiny_normal", chips=1,
                                why="test")]
    for m in bench["end_to_end"]:
        if m["name"] == "plans_per_s":
            m["workloads"] += ["parking.tiny", "cartpole.tiny"]
    bench["per_layer"].append(dict(name="solves.tiny", unit="solves", better="higher", source="program_counter",
                                   layer="compaction driver", moves="plans_per_s", workloads=["parking.tiny"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if k in after), "a file the benchmark had was edited"
    # the program, found beside the copy as in a checkout
    (tmp_path / "altro_tpu_torch").symlink_to(spec.ROOT / "altro_tpu_torch")

    res = _run(tmp_path, "parking.tiny")
    assert res["ok"] and res["config"] == "parking" and res["lanes"] == 4, res
    assert set(res["metrics"]) == {"setup_s", "plans_per_s", "solves.tiny"}
    assert res["metrics"]["solves.tiny"]["value"] >= 1

    res = _run(tmp_path, "cartpole.tiny")
    assert res["ok"] and res["config"] == "cartpole" and res["numbers"]["compared_lanes"] >= 3, res
    assert set(res["metrics"]) == {"setup_s", "plans_per_s"}

"""One run of one cell: set-up, warm-up, the measured window, the optional
traced stretch, the correctness check, and the result's line.

The traffic file's `kind` names the driver (`fleet` or `mpc`, modules of
this package); every metric's value comes from its reader,
`benchmark/metrics/<name>.py`, which takes the `Run` and returns a number,
or None where it finds nothing to read (the metric is then left out).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time

import torch

from . import check, fleet, mpc, spec, sut as suts
from .yardstick import KernelShape
from ..reference import problem as ref_problem
from ..reference.arith import Arith

DRIVERS = {"fleet": fleet, "mpc": mpc}
SUTS = {"fleet": (suts.ProgramFleet, suts.ReferenceFleet), "mpc": (suts.ProgramMPC, suts.ReferenceMPC)}
FORBIDDEN = ("jax", "jaxlib", "flax", "altro_tpu")
# the control's arithmetic: the nearest precision below the configurations'
# float32
CONTROL_DTYPE = torch.bfloat16


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    t_start: float
    device: torch.device
    dtype: torch.dtype = torch.float32
    window: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    records: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    trace: object = None  # the device-only traced stretch
    trace_named: object = None  # the host-and-device one
    attempted: int = 0
    failed: int = 0
    t_window: float = 0.0
    setup_s: float = 0.0
    host: dict = dataclasses.field(default_factory=dict)  # `host_facts()` and the window's CPU seconds
    cpu_window: float = 0.0

    def __post_init__(self):
        self.dtype = suts.DTYPES[self.cell.config["dtype"]]
        self.ref_problem = ref_problem.build(self.cell.config["problem"])
        self.x0_canonical = self.ref_problem.x0
        self.shape = KernelShape.from_config(self.cell.config)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_start(self) -> None:
        self.host = host_facts()
        self.sync()
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - self.t_start
        self.cpu_window = time.process_time()


def host_facts() -> dict:
    """What the host offers the run as its window opens: its processor and
    clock, the cores this process may use, the load, and the host time of
    one small PyTorch operation on the CPU (the median of 15 batches of
    1,000), the pace of the host side of a solve: for comparing runs made
    on different machines."""
    cpu = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, val = ln.partition(":")
                key = key.strip()
                if key in ("model name", "Model name", "CPU part", "cpu MHz") and key not in cpu:
                    cpu[key] = val.strip()
    except OSError:
        pass
    a = torch.zeros(8)
    batches = []
    for _ in range(15):
        t = time.perf_counter()
        for _ in range(1000):
            a = a + 1.0
        batches.append((time.perf_counter() - t) / 1000)
    return dict(cpu=cpu, cores=len(os.sched_getaffinity(0)), loadavg_1m=os.getloadavg()[0],
                torch_threads=torch.get_num_threads(), op_us=1e6 * sorted(batches)[7])


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def make_sut(run: Run, control_dtype: torch.dtype | None = None):
    """The program, or the plain reference in its place, computing in
    `control_dtype` with the cell's `control_options` (the control:
    `CONTROL_DTYPE`)."""
    kind = run.cell.traffic["kind"]
    lanes = run.cell.traffic.get("lanes", run.cell.traffic.get("controllers"))
    program, reference = SUTS[kind]
    if control_dtype is not None:
        return reference(run.cell.config, lanes, run.device, Arith(control_dtype),
                         run.cell.limits.get("control_options", {}))
    return program(run.cell.config, lanes, run.device)


def correctness(run: Run) -> tuple[bool, dict, dict]:
    kind = run.cell.traffic["kind"]
    lim = run.cell.limits
    ref = lim["reference"]
    opts = suts.reference_options(ref["options"])
    ar = Arith(suts.DTYPES[ref["dtype"]])
    numbers = (check.fleet_numbers if kind == "fleet" else check.mpc_numbers)(run.cell.config, run.records, opts, ar)
    ok, checks = check.judge(numbers, lim["limits"])
    return ok, checks, numbers


def read_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        v = spec.load_module("metrics", m["name"]).read(run)
        if v is not None:
            out[m["name"]] = dict(value=float(v), unit=m["unit"])
    return out


def execute(cell, seed: int, seconds: float, trace: bool, t_start: float, device=None) -> dict:
    """One run of `cell` (a `spec.Cell` or its name); returns the result's
    line as a dict (its `checks` last)."""
    if isinstance(cell, str):
        cell = spec.load_cell(cell)
    dev = torch.device(device or "cuda")
    run = Run(cell=cell, seed=seed, seconds=seconds, t_start=t_start, device=dev)
    driver = DRIVERS[cell.traffic["kind"]]
    system = make_sut(run)
    driver.warm_up(run, system)
    driver.window(run, system)
    run.host["cpu_s_in_window"] = time.process_time() - run.cpu_window
    if trace:
        driver.trace(run, system)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok, checks, numbers = correctness(run)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package are loaded: {found}")
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    dev_info = dict(platform="gpu", kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                    count=cell.chips, memory_peak_bytes=int(peak))
    line = dict(correct=ok, attempted=int(run.attempted), failed=int(run.failed), metrics=metrics, device=dev_info)
    if trace:
        dev_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = dict(device_ops=run.trace.breakdown()["device_ops"],
                                 idle_gaps=run.trace_named.breakdown()["idle_gaps"])
    line["host"] = run.host
    line["readings"] = numbers
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)

"""The benchmark's three-obstacle cell (`obstacles.fleet4k`) on the CPU:
the plain reference's circle kind against the port's `circle_constraint`
and its AL terms; the reference's canonical kThreeObstacles solve against
altro-cpp's acceptance test; the port's eager path, built as the cell's
configuration builds it, against the reference on lanes of the cell's
traffic; the cell's files and the circle-aware count of the fused backward
kernel; and the readers of the cell's two new metrics on synthetic traces.
Float64, one torch thread."""
import copy
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from altro_tpu_torch import SolverOptions, SolverStatus  # noqa: E402
from altro_tpu_torch.models.problems import THREE_OBSTACLES, UnicycleProblem  # noqa: E402
from altro_tpu_torch.solver.batched import ALSolverBatched  # noqa: E402
from benchmark.harness import spans, spec, sut, traffic, yardstick, yardstick_circles  # noqa: E402
from benchmark.harness.trace import Interval, Trace  # noqa: E402
from benchmark.reference import altro, constraints, problem as ref_problem  # noqa: E402

from _torch_fleet import one_torch_thread, torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "obstacles.fleet4k"
LANES = 4
CLEARANCE_MIN = -1e-3  # metres (altro-cpp example_unicycle_test.cpp:76-83)


@pytest.fixture(scope="module")
def cfg():
    return spec.load_json(spec.BENCH_DIR / "configs" / "obstacles.json")


@pytest.fixture(scope="module")
def fleet(cfg):
    """The first LANES lanes of the cell's first pool member (lane 0 the
    canonical x0), and the reference's solve of them in float64 with the
    options the configuration gives the program."""
    prob = ref_problem.build(cfg["problem"])
    x0 = traffic.pool_x0(spec.load_json(spec.BENCH_DIR / "traffic" / "fleet4k.json"), prob.x0, LANES, 0, "cpu",
                         torch.float64)
    with torch_threads(1):
        ref = altro.Solver(prob, sut.reference_options(cfg["solver"]["options"])).solve(
            x0, prob.initial_controls(LANES))
    return prob, x0, ref


def test_circle_kind_matches_the_ports_circle_rows(cfg):
    """Values, AL cost, gradient and Gauss-Newton Hessian of the circle rows
    at seeded random states (some inside the circles), duals and penalties:
    the reference's kind against the port's `circle_constraint` family as
    its eager solver evaluates it (`ALSolverBatched._con_values`,
    `_con_jacs`, `_al_terms`)."""
    N, B = 12, 16
    defn = UnicycleProblem(scenario=THREE_OBSTACLES, N=N, dtype=torch.float64, device="cpu")
    prob = defn.make_problem().compile()
    solver = ALSolverBatched(prob, SolverOptions(backward_pass="scan", forward_pass="scan"))
    (fam, fp) = [(f, p) for f, p in zip(prob.constraint_families, prob.params.constraints)
                 if f.constraint.label == "Circle Constraint"][0]
    nk, p = len(fam.knots), fam.dim
    g = torch.Generator().manual_seed(20261018)
    X = torch.rand((N + 1, 3, B), generator=g, dtype=torch.float64) * 3.4 - 0.2
    U = torch.rand((N, 2, B), generator=g, dtype=torch.float64) * 2.0 - 1.0
    lam = -torch.rand((nk, p, B), generator=g, dtype=torch.float64) * 5.0
    lam[:, :, ::3] = 0.0
    rho = 10.0 ** (torch.rand((nk, B), generator=g, dtype=torch.float64) * 6.0 - 2.0)
    Xk, Uk = X[fam.knots], U[fam.knots]
    c = solver._con_values(fam, fp, Xk, Uk)
    Cx, Cu = solver._con_jacs(fam, fp, Xk, Uk)
    J, (gx, gu, hxx, hxu, huu) = solver._al_terms(fam, c, Cx, Cu, lam, rho, True)

    kind = constraints.kind("circle")
    data = ref_problem.build(cfg["problem"]).constraints["circle"]
    x = Xk.permute(2, 0, 1)  # lanes first: [B, nk, n]
    lam_r, rho_r = lam.permute(2, 0, 1), rho.permute(1, 0)
    assert kind.rows(data, 3, 2) == p == 3
    c_r = kind.value(data, x, None)
    J_r, terms = kind.al_terms(data, x, None, lam_r, rho_r)
    active = (lam_r - rho_r[..., None] * c_r) <= 0
    assert 0 < int(active.sum()) < active.numel()  # both sides of the orthant
    tight = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(c_r, c.permute(2, 0, 1), **tight)
    torch.testing.assert_close(J_r, J.permute(1, 0), **tight)
    assert set(terms) == {"lx", "lxx"}
    torch.testing.assert_close(terms["lx"], gx.permute(2, 0, 1), **tight)
    torch.testing.assert_close(terms["lxx"], hxx.permute(3, 0, 1, 2), **tight)
    for t in (gu, hxu, huu):  # the rows do not depend on u
        assert not t.any()


def test_reference_canonical_solve_passes_the_upstream_acceptance(fleet):
    """The canonical lane (x0 = 0): SOLVED, every knot's position at least
    −1 mm outside each circle (`example_unicycle_test.cpp:76-83`).  Knot 0,
    where the reference's rows stand and altro-cpp's do not, holds the
    fixed x0 well outside every circle: its rows are inactive and keep
    λ = 0."""
    prob, x0, ref = fleet
    assert torch.equal(x0[0], prob.x0)
    assert int(ref["status"][0]) == altro.SOLVED
    data = prob.constraints["circle"]
    X = ref["X"][0]
    d = torch.sqrt((X[:, None, 0] - data["cx"]) ** 2 + (X[:, None, 1] - data["cy"]) ** 2) - data["r"]
    assert float(d.min()) >= CLEARANCE_MIN
    c0 = constraints.kind("circle").value(data, ref["X"][:, 0], None)
    assert float(c0.max()) < -0.49  # 0.49 m clear: (1.06 - 0.14)² - 0.425² > 0.49
    lam, _ = ref["al"]["circle"]
    assert not lam[:, 0].any()


def test_port_eager_path_matches_the_reference(cfg, fleet):
    """The cell's program (`harness/sut.py:ProgramFleet`, the configuration's
    problem and compaction settings) on its eager passes in float64, without
    the float64 polish (a second solve of the lanes left unconverged, which
    the reference does not have), against the reference on the same lanes:
    the same statuses, the failures included, and the same iterations.  U
    within 1e-7: both compute the same iterations in float64 and differ only
    in the order of their roundings (batch-last eager operations against
    the reference's lanes-first ones), which these solves amplify to a few
    1e-9; a lane that took another step, or ended in another local optimum
    (the other side of an obstacle), would differ by far more."""
    _, x0, ref = fleet
    run_cfg = copy.deepcopy(cfg)
    run_cfg["dtype"] = "float64"
    run_cfg["solver"]["f64_polish"] = False
    run_cfg["solver"]["options"].update(backward_pass="scan", forward_pass="scan")
    program = sut.ProgramFleet(run_cfg, LANES, "cpu")
    res = program.solver.solve(program.params.replace(x0=x0.T.contiguous()), program.Zb)
    status = res["status"].tolist()
    assert status == ref["status"].tolist()
    assert int(SolverStatus.SOLVED) in status
    assert res["stats"].iterations_total.tolist() == ref["iterations_total"].tolist()
    U = res["Z"].U.permute(2, 0, 1)
    assert float((U - ref["U"]).abs().max()) <= 1e-7


def test_cell_loads_and_circle_count_reduces_to_the_frozen_one(cfg):
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.config["name"] == "obstacles" and cell.traffic["lanes"] == 4096
    assert {m["name"] for m in cell.per_layer} >= {"bwd_roofline.obstacles", "polish_share.obstacles"}
    assert "bwd_roofline.fleet" not in {m["name"] for m in cell.per_layer}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "plans_per_s"]
    B, N = 1024, cfg["problem"]["N"]
    parking = spec.load_json(spec.BENCH_DIR / "configs" / "parking.json")
    no_circle = copy.deepcopy(cfg)
    del no_circle["problem"]["constraints"]["circle"]
    for c in (parking, no_circle):
        assert yardstick_circles.circle_rows(c) == 0
        for dtype in ("float32", "float64"):
            frozen = yardstick.fused_backward_work(yardstick.KernelShape.from_config(c), B, dtype)
            assert yardstick_circles.backward_work(c, B, dtype) == frozen
            assert yardstick_circles.least_seconds(c, B, dtype) == yardstick.least_seconds(
                "backward_fused", yardstick.KernelShape.from_config(c), B, dtype)
    k = yardstick_circles.shape(cfg)
    assert (k.Ps, k.Fs, k.Pt, k.Ft) == (7, 2, 3, 1)
    nbytes, flops = yardstick_circles.backward_work(cfg, B, "float32")
    base_bytes, base_flops = yardstick.fused_backward_work(k, B, "float32")
    assert nbytes == base_bytes and flops - base_flops == N * B * 3 * (81 - 8)


def _records(tree):
    """SpanRecord-like records of a (name, start_us, end_us, children)
    tree, in the order they open."""
    out = []

    def walk(node, parent, root):
        name, s, e, kids = node
        r = types.SimpleNamespace(name=name, start_ns=int(s * 1000), end_ns=int(e * 1000), index=len(out),
                                  parent=parent, root=root if root is not None else len(out))
        out.append(r)
        for k in kids:
            walk(k, r.index, r.root)

    walk(tree, -1, None)
    return out


def _trace(t0, t1, device):
    tr = Trace(device=device, ranges=[], host_ops=[], window_s=(t1 - t0) * 1e-6,
               busy_s=sum(d.dur_us for d in device) * 1e-6)
    tr._t0, tr._t1, tr._union = t0, t1, [[d.start_us, d.end_us] for d in device]
    return tr


SOLVE = ("compaction.solve", 0, 200, [
    ("compaction.phase1", 0, 80, []),
    ("compaction.tail_round", 80, 120, []),
    ("sync.final_readback", 120, 122, []),
    ("compaction.polish_stage", 122, 170, [("compaction.polish", 122, 160, []), ("sync.polish_readback", 160, 170, [])]),
    ("compaction.polish_stage", 170, 190, [("compaction.polish", 170, 185, []), ("sync.polish_readback", 185, 190, [])]),
])


def _run(trace, launches=None):
    return types.SimpleNamespace(trace=trace, launches=launches or {},
                                 cell=types.SimpleNamespace(config=spec.load_json(
                                     spec.BENCH_DIR / "configs" / "obstacles.json")))


@pytest.mark.parametrize("stages", [True, False])
def test_polish_share_reads_the_stage_spans(stages, monkeypatch):
    """The union of the `compaction.polish_stage` spans over the solve's
    span: (48 + 20) / 200; nothing from a program whose polish chunks have
    no stage span around them (an older commit)."""
    name, s, e, kids = SOLVE
    if not stages:  # each stage's children directly under the solve
        kids = [k for kid in kids for k in (kid[3] if kid[0] == "compaction.polish_stage" else [kid])]
    tree = (name, s, e, kids)
    monkeypatch.setattr(spans, "_records", lambda: _records(tree))
    read = spec.load_module("metrics", "polish_share.obstacles").read
    got = read(_run(_trace(0, 200, [Interval("k", 0, 50)])))
    assert got == (pytest.approx(100.0 * 68 / 200) if stages else None)


def test_backward_roofline_counts_circle_rows():
    """The circle-aware count's least time of the float32 launches over
    their device time; the float64 polish's launches are not counted, and a
    trace that does not hold each launch once reads nothing."""
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "obstacles.json")
    read = spec.load_module("metrics", "bwd_roofline.obstacles").read
    name = "void backward_fused_kernel<{}, Unicycle>(AltroBackwardArgs)"
    device = ([Interval(name.format("float"), 10 * i, 10 * i + 4) for i in range(3)]
              + [Interval(name.format("double"), 50, 70)])
    launches = dict(backward_fused=[(4096, 2), (1024, 1)])
    least = 2 * yardstick_circles.least_seconds(cfg, 4096, "float32") + yardstick_circles.least_seconds(
        cfg, 1024, "float32")
    assert read(_run(_trace(0, 100, device), launches)) == pytest.approx(100.0 * least / 12e-6)
    assert read(_run(_trace(0, 100, device), dict(backward_fused=[(4096, 2)]))) is None
    assert read(_run(None, launches)) is None

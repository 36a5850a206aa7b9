"""The fleet path's tracer and counted host reads (`altro_tpu_torch/utils/
timer.py`): the off path makes no profiler call and allocates no span; a
traced solve and tick give the span tree the layers promise, with one
`sync.*` span per counted host sync; the spans share torch.profiler's
clock; and every host read of device data in a solve or tick goes through
`host_read`, so `host_syncs` counts each one (but the compaction driver's
final read-back).  Small float32 parking fleets on the CPU, the kernels'
plain versions in the kernels' place."""
import contextlib

import pytest
import torch

from altro_tpu_torch import BatchedMPC, SolverOptions
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.solver.compaction import CompactedALSolver
from altro_tpu_torch.utils import timer

B, N = 8, 24
KERNELS = dict(backward_pass="fused", forward_pass="cuda", line_search_max_iterations=6, max_stall_iterations=3)
# a capped budget leaves lanes unconverged after the tail, so the restart
# cascade and both polish stages run too
COMPACTED = dict(
    device=dict(phase1_iters=4, tail_batch=4, device_tail=True, f64_polish=True, polish_batch=4,
                restart_portfolio=(dict(penalty_scaling=4.0),)),
    host=dict(phase1_iters=4, tail_batch=4, tail_iters=3, max_tail_rounds=2, f64_polish=True, polish_batch=4),
)
CAPPED = dict(max_iterations_total=7)
SOLVES = ["compaction_device", "compaction_host", "batched", "mpc"]


@pytest.fixture(scope="module")
def parking():
    defn = UnicycleProblem(dtype=torch.float32, N=N, device="cpu")
    prob = defn.make_problem().compile()
    x0 = (torch.rand((3, B), generator=torch.Generator().manual_seed(0)) - 0.5) * 0.6
    x0[:, 0] = 0.0
    Z0 = defn.initial_trajectory()
    Zb = BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
                           U=Z0.U[..., None].expand(-1, -1, B).contiguous(), t=Z0.t, h=Z0.h)
    return prob, prob.params.replace(x0=x0), Zb


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _runner(kind, parking):
    """(solver, call): `call()` runs one solve, or one warm tick of a
    controller whose first tick already ran."""
    prob, params, Zb = parking
    if kind.startswith("compaction"):
        s = CompactedALSolver(prob, SolverOptions(**KERNELS, **CAPPED), **COMPACTED[kind.split("_")[1]])
        return s, lambda: s.solve(params, Zb)
    if kind == "batched":
        s = ALSolverBatched(prob, SolverOptions(**KERNELS))
        return s, lambda: s.solve(params, Zb)
    s = BatchedMPC(prob, SolverOptions(**KERNELS, max_iterations_total=3, max_iterations_inner=3))
    state = [s.init(Zb)]

    def tick():
        u, state[0] = s.step(state[0], params.x0)
        return u

    tick()
    return s, tick


def _tree(spans):
    by = {r.index: r for r in spans}

    def up(r):
        return by[r.parent].name if r.parent >= 0 else None

    return by, up


def test_span_off_is_one_shared_object():
    assert not timer._on
    assert timer.span("ilqr.iter") is timer.NO_SPAN
    assert timer.root_span("al.solve") is timer.NO_SPAN
    with timer.span("ilqr.iter") as rec:
        assert rec is None
    assert timer.host_read("inner_exit", lambda: 7) == 7


@pytest.mark.parametrize("kind", SOLVES)
def test_off_path_makes_no_profiler_call_and_no_span(kind, parking, monkeypatch):
    solver, call = _runner(kind, parking)

    def refuse(*a, **k):
        raise AssertionError("the off path made a profiler call or built a span")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(timer, "_Span", refuse)
    monkeypatch.setattr(timer, "SpanRecord", refuse)
    opened = timer._next
    call()
    assert solver.host_syncs > 0
    assert timer._next == opened


# each span's enclosing spans, as the layers promise
PARENTS = {
    "compaction.phase1": {"compaction.solve"},
    "compaction.tail_round": {"compaction.solve"},
    "compaction.restart": {"compaction.solve"},
    "compaction.polish_stage": {"compaction.solve"},
    "compaction.polish": {"compaction.polish_stage"},
    "compaction.gather": {"compaction.tail_round", "compaction.restart", "compaction.polish"},
    "compaction.merge": {"compaction.tail_round", "compaction.restart", "compaction.polish"},
    "al.solve": {None, "compaction.phase1", "compaction.tail_round", "compaction.restart", "compaction.polish",
                 "mpc.step"},
    "al.outer": {"al.solve"},
    "al.duals": {"al.outer"},
    "ilqr.rollout": {"al.outer"},
    "ilqr.iter": {"al.outer"},
    "ilqr.backward": {"ilqr.iter"},
    "ilqr.forward": {"ilqr.iter"},
    "mpc.shift": {"mpc.step"},
    "sync.inner_exit": {"al.outer"},
    "sync.outer_exit": {"al.solve"},
    "sync.line_search": {"ilqr.forward"},
    "sync.plain_search": {"ilqr.forward"},
    "sync.bp_retry": {"ilqr.backward"},
    "sync.tail_round": {"compaction.solve", "compaction.tail_round"},
    "sync.restart": {"compaction.restart"},
    "sync.upload": {"compaction.gather", "compaction.tail_round"},
    "sync.polish_readback": {"compaction.polish_stage"},
    "sync.final_readback": {"compaction.solve"},
}
ROOTS = dict(compaction_device="compaction.solve", compaction_host="compaction.solve", batched="al.solve",
             mpc="mpc.step")
MUST = dict(
    compaction_device={"compaction.phase1", "compaction.tail_round", "compaction.restart", "compaction.polish",
                       "compaction.polish_stage", "compaction.gather", "compaction.merge", "sync.tail_round",
                       "sync.restart", "sync.polish_readback", "sync.final_readback", "sync.upload"},
    compaction_host={"compaction.phase1", "compaction.tail_round", "compaction.polish", "compaction.polish_stage",
                     "sync.tail_round", "sync.polish_readback", "sync.final_readback", "sync.upload"},
    batched={"sync.bp_retry"},
    mpc={"mpc.shift"},
)


@pytest.mark.parametrize("kind", SOLVES)
def test_traced_solve_gives_the_span_tree(kind, parking):
    solver, call = _runner(kind, parking)
    with timer.tracing() as spans:
        call()
    assert not timer._on and timer.open_span() is None
    names = {r.name for r in spans}
    loops = {"al.solve", "al.outer", "al.duals", "ilqr.rollout", "ilqr.iter", "ilqr.backward", "ilqr.forward",
             "sync.inner_exit", "sync.outer_exit"}
    assert loops | MUST[kind] <= names, sorted(loops | MUST[kind] - names)
    # the forward kernel searches each lane on the device: no line-search sync
    assert "sync.line_search" not in names
    by, up = _tree(spans)
    (root,) = [r for r in spans if r.parent < 0]
    assert root.name == ROOTS[kind] and spans[0] is root
    for r in spans:
        assert r.root == root.index
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = by[r.parent]
            assert p.index < r.index and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        if r is not root:
            assert up(r) in PARENTS[r.name], (r.name, up(r))
    syncs = [r for r in spans if r.name.startswith("sync.") and r.name[5:] not in timer.UNCOUNTED]
    assert len(syncs) == solver.host_syncs > 0
    assert sum(r.name == "sync.final_readback" for r in spans) == (1 if kind.startswith("compaction") else 0)
    # one span a sync site: nothing under a host read
    assert not any(by[r.parent].name.startswith("sync.") for r in spans if r.parent >= 0)


@pytest.mark.parametrize("kind", ["compaction_device", "compaction_host"])
def test_polish_stage_spans_enclose_their_chunks(kind, parking):
    """A polish that takes lanes records one `compaction.polish_stage` per
    stage that ran, in order, each holding its own chunks'
    `compaction.polish` spans (one per `polish_batch` lanes) and its one
    `sync.polish_readback`, and no other stage's."""
    solver, call = _runner(kind, parking)
    with timer.tracing() as spans:
        call()
    stages = solver.telemetry["polish"]["stages"]
    assert [s["stage"] for s in stages] == [0, 1]
    by = {r.index: r for r in spans}
    got = [r for r in spans if r.name == "compaction.polish_stage"]
    assert len(got) == len(stages)
    for stage, tel in zip(got, stages):
        kids = [r for r in spans if r.parent == stage.index]
        chunks = [r for r in kids if r.name == "compaction.polish"]
        assert len(chunks) == -(-tel["instances"] // solver.polish_batch)
        assert [r.name for r in kids if r.name.startswith("sync.")] == ["sync.polish_readback"]
        for r in chunks:
            assert stage.start_ns <= r.start_ns and r.end_ns <= stage.end_ns
    assert all(by[r.parent].name == "compaction.polish_stage" for r in spans if r.name == "compaction.polish")


@pytest.mark.parametrize("kind", ["compaction_device", "mpc"])
def test_spans_share_the_profilers_clock(kind, parking):
    """A solve under a benchmark range while torch.profiler records (CPU
    activity): the tracer turns on by itself, and its root span lies inside
    the range, within 1 ms of each end."""
    from torch.profiler import ProfilerActivity, profile

    _, call = _runner(kind, parking)
    # a process's first profiled range pays the profiler's own set-up
    # (about 1 ms on the CPU): a session before the measured one
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function("bench.warm"):
            pass
    first = timer._next
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.fleet.solve"):
            call()
    assert not timer._on
    mine = [r for r in timer.records() if r.index >= first]
    (root,) = [r for r in mine if r.parent < 0]
    assert root.name == ROOTS[kind] and len(mine) > 10
    (rng,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "bench.fleet.solve"]
    assert rng.start_ns() <= root.start_ns and root.end_ns <= rng.end_ns()
    assert root.start_ns - rng.start_ns() < 1_000_000 and rng.end_ns() - root.end_ns < 1_000_000


READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy")


@contextlib.contextmanager
def counted_reads(where: list):
    """Patch every way a tensor's values reach the host to note the span
    open at the call."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def wrap(name, fn):
        def read(self, *a, **k):
            where.append(timer.open_span())
            return fn(self, *a, **k)

        read.__name__ = name
        return read

    try:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, wrap(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("kind", SOLVES)
def test_host_syncs_counts_every_host_read(kind, parking):
    """With every read of tensor values counted, a solve or a tick reads
    the host only inside `host_read`'s spans, and in as many of them as
    `host_syncs`, plus the uncounted sites: the compaction driver's final
    read-back and the stop tests of the forward kernel's plain search,
    which stands in on the CPU for the kernel's search."""
    solver, call = _runner(kind, parking)
    where = []
    with timer.tracing() as spans, counted_reads(where):
        call()
    assert where, "nothing was read"
    outside = [r.name if r is not None else None for r in where if r is None or not r.name.startswith("sync.")]
    assert not outside, f"host reads outside host_read: {sorted(set(map(str, outside)))}"
    read_in = {r.index for r in where}
    syncs = [r for r in spans if r.name.startswith("sync.")]
    uncounted = [r for r in syncs if r.name[5:] in timer.UNCOUNTED]
    # an upload waits for the device but reads no value
    assert all(r.index in read_in for r in syncs if r.name != "sync.upload")
    assert len(syncs) - len(uncounted) == solver.host_syncs
    assert sum(r.name == "sync.final_readback" for r in uncounted) == (1 if kind.startswith("compaction") else 0)
    assert any(r.name == "sync.plain_search" for r in uncounted)


def test_kernel_preparation_counts_its_reads(parking):
    """The fused kernels' host side: `_prepare` misses on a new params
    object (`kernel.prepare`), and reads the shared leaves to the host
    only when they are new objects (the f64 polish's `astype` makes them
    new on every chunk), each read and the descriptor's two uploads a
    counted `kernel_prep` sync."""
    prob, params, _ = parking
    kern = BackwardFusedKernel(prob, SolverOptions(**KERNELS), dtype=torch.float32, device="cpu")
    leaves = sum(torch.is_tensor(leaf) for name, _, _, leaf in kern._iter_params(params))
    rounds = []
    for p in (params, params, params.replace(x0=params.x0 + 0.0), params.astype(torch.float64)):
        reads = timer.host_reads()
        with timer.tracing() as spans:
            kern._prepare(p, B)
        rounds.append(([r.name for r in spans], timer.host_reads() - reads))
    prep = ["kernel.prepare"] + ["sync.kernel_prep"] * (leaves + 2)
    assert rounds[0] == (prep, leaves + 2)
    assert rounds[1] == ([], 0)
    assert rounds[2] == (["kernel.prepare"], 0)
    assert rounds[3] == (prep, leaves + 2)


def test_tracing_nests_and_restores():
    with timer.tracing() as outer:
        with timer.root_span("mpc.step"):
            with timer.tracing() as inner:
                with timer.span("mpc.shift"):
                    pass
            assert timer._on
        assert timer._on
    assert not timer._on
    assert [r.name for r in outer] == ["mpc.step", "mpc.shift"]
    assert [r.name for r in inner] == ["mpc.shift"]
    assert inner[0].parent == outer[0].index == inner[0].root

"""`harness/spans.py` on a synthetic stretch: the device's idle gaps split
by the layer of the innermost program span, against values worked out by
hand, adding up to the stretch's idle time; the per-solve counts and the
straggler share; and nothing (None) from a program without the tracer."""
import types

import pytest

from benchmark.harness import spans
from benchmark.harness.trace import Interval, Trace


def _trace(t0, t1, busy):
    tr = Trace(device=[Interval("k", s, e) for s, e in busy], ranges=[], host_ops=[],
               window_s=(t1 - t0) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6)
    tr._t0, tr._t1, tr._union = t0, t1, [list(b) for b in busy]
    return tr


def _records(tree):
    """SpanRecord-like records of a (name, start_us, end_us, children)
    tree, in the order they open."""
    out = []

    def walk(node, parent, root):
        name, s, e, kids = node
        r = types.SimpleNamespace(name=name, start_ns=int(s * 1000), end_ns=int(e * 1000), index=len(out),
                                  parent=parent, root=root)
        out.append(r)
        for k in kids:
            walk(k, r.index, r.index if root is None else root)
        if root is None:
            r.root = r.index

    walk(tree, -1, None)
    return out


# a tick from 5 to 95 µs of a stretch [0, 100] whose device runs three
# kernels, [10, 20], [40, 50] and [70, 80]
TICK = ("mpc.step", 5, 95, [
    ("al.solve", 8, 90, [
        ("al.outer", 9, 85, [
            ("ilqr.iter", 12, 60, [("sync.line_search", 45, 52, []), ("kernel.prepare", 55, 58, [])]),
            ("sync.inner_exit", 62, 78, []),
        ]),
    ]),
    ("mpc.shift", 91, 94, []),
])
BUSY = [(10, 20), (40, 50), (70, 80)]


def test_idle_split_by_hand():
    tr = _trace(0, 100, BUSY)
    got = spans.idle_split(tr, spans.in_stretch(tr, _records(TICK)))
    # gaps [0,10] [20,40] [50,70] [80,100]: outside 5 + 5, controllers 3 + 5,
    # loops 2 + 20 + 3 + 4 + 10, sync 2 + 8, kernel preparation 3
    want = dict(loops=39, compaction=0, controllers=8, kernel_prep=3, sync=10, outside=10)
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()})


@pytest.mark.parametrize("busy", [BUSY, [(0, 100)], [], [(3, 9), (9, 47), (60, 61), (99, 100)]])
def test_idle_split_adds_up_to_the_idle_time(busy):
    tr = _trace(0, 100, busy)
    got = spans.idle_split(tr, spans.in_stretch(tr, _records(TICK)))
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s, abs=1e-12)
    idle = 100.0 * (1 - tr.busy_s / tr.window_s)
    assert sum(100.0 * v / tr.window_s for v in got.values()) == pytest.approx(idle)


def test_spans_outside_the_stretch_are_left_out():
    tr = _trace(200, 300, [(220, 230)])
    assert spans.in_stretch(tr, _records(TICK)) is None
    got = spans.idle_split(tr, [])
    assert got["outside"] == pytest.approx(90e-6) and sum(got.values()) == pytest.approx(90e-6)


SOLVE = ("compaction.solve", 0, 100, [
    ("compaction.phase1", 1, 40, [("al.solve", 2, 39, [("sync.line_search", 5, 6, []), ("sync.line_search", 7, 8, [])])]),
    ("compaction.tail_round", 41, 60, [("sync.line_search", 45, 46, [])]),
    ("compaction.tail_round", 60, 61, []),
    ("sync.final_readback", 62, 64, []),
    ("compaction.polish", 70, 90, []),
    ("sync.polish_readback", 90, 91, []),
])


def test_straggler_share_and_line_search_syncs():
    recs = _records(SOLVE)
    tr = _trace(0, 100, [(0, 100)])
    stretch = spans.in_stretch(tr, recs)
    # after phase 1 (ends at 40): [41, 61] + [62, 64] + [70, 91] = 43 of 100
    assert spans.straggler_percent(stretch) == pytest.approx(43.0)
    run = types.SimpleNamespace(trace=tr)
    spans_of = spans._records
    try:
        spans._records = lambda: recs
        assert spans.per_root(run, "sync.line_search", ("compaction.solve",)) == 3
        assert spans.per_root(run, "sync.line_search", ("mpc.step",)) is None
        assert spans.idle_percent(run, "loops") == 0.0
    finally:
        spans._records = spans_of


def test_nothing_from_a_program_without_the_tracer(monkeypatch):
    from altro_tpu_torch.utils import timer

    run = types.SimpleNamespace(trace=_trace(0, 100, BUSY))
    monkeypatch.delattr(timer, "records")
    assert spans._records() is None
    assert spans.idle_percent(run, "loops") is None
    assert spans.per_root(run, "sync.line_search", ("mpc.step",)) is None
    monkeypatch.setattr(spans, "_records", lambda: [])
    assert spans.in_stretch(run.trace) is None

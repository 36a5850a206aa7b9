"""The program's own spans over a traced stretch: the records of
`altro_tpu_torch/utils/timer.py`'s tracer, which records while a
torch.profiler session does, stamped on the clock the profiler stamps its
events with (epoch ns), so that a span and a device event of one trace
compare directly.

`idle_split` charges each microsecond of the device's idle gaps to the
layer of the innermost program span open on the host at that moment:

    al.*, ilqr.*     lockstep AL-iLQR loops   (`loops`)
    compaction.*     compaction driver        (`compaction`)
    mpc.*            controllers              (`controllers`)
    kernel.prepare   kernel preparation       (`kernel_prep`)
    sync.*           sync wake-up             (`sync`)
    none             outside the program      (`outside`)

so the layers add up to the stretch's idle time.  A program without the
tracer (an older commit) gives no records, and every reader here returns
None.
"""
from __future__ import annotations

LAYERS = ("loops", "compaction", "controllers", "kernel_prep", "sync", "outside")


def layer_of(name: str) -> str | None:
    """The layer of a span's name; None for a name of no layer."""
    if name.startswith("sync."):
        return "sync"
    if name == "kernel.prepare":
        return "kernel_prep"
    if name.startswith("compaction."):
        return "compaction"
    if name.startswith("mpc."):
        return "controllers"
    if name.startswith(("al.", "ilqr.")):
        return "loops"
    return None


def _records() -> list | None:
    """Every span the program's tracer holds, or None for a program
    without one."""
    try:
        from altro_tpu_torch.utils import timer
    except ImportError:
        return None
    read = getattr(timer, "records", None)
    return None if read is None else read()


def in_stretch(trace, records=None) -> list | None:
    """(name, start_us, end_us, record) of every closed span that overlaps
    the stretch, in the order they opened; None where the program has no
    tracer or recorded nothing there."""
    recs = _records() if records is None else records
    if not recs:
        return None
    t0, t1 = trace._t0, trace._t1  # the stretch on the profiler's clock (µs)
    out = [(r.name, r.start_ns * 1e-3, r.end_ns * 1e-3, r) for r in recs
           if r.end_ns is not None and r.end_ns * 1e-3 > t0 and r.start_ns * 1e-3 < t1]
    return out or None


def innermost(spans, key=layer_of) -> list:
    """The timeline of the innermost span: (start, end, key(name))
    segments, in order, of properly nested (name, start, end, ...) spans
    (those of one thread); a span whose key is None is skipped."""
    out, stack, t = [], [], None
    for name, s, e, *_ in sorted(spans, key=lambda x: (x[1], -x[2])):
        layer = key(name)
        if layer is None:
            continue
        while stack and stack[-1][0] <= s:
            end, lay = stack.pop()
            out.append((t, end, lay))
            t = end
        if stack:
            out.append((t, s, stack[-1][1]))
        stack.append((e, layer))
        t = s
    while stack:
        end, lay = stack.pop()
        out.append((t, end, lay))
        t = end
    return [seg for seg in out if seg[1] > seg[0]]


def idle_split(trace, spans) -> dict:
    """Seconds of the stretch's device idle time by layer (`LAYERS`): each
    idle gap's overlap with the innermost-span timeline, the rest
    `outside`.  The values add up to the stretch's idle time."""
    segs = innermost(spans)
    out = dict.fromkeys(LAYERS, 0.0)
    i = 0
    for gs, ge in trace.idle_gaps():
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        covered = 0.0
        j = i
        while j < len(segs) and segs[j][0] < ge:
            ov = min(segs[j][1], ge) - max(segs[j][0], gs)
            if ov > 0:
                out[segs[j][2]] += ov * 1e-6
                covered += ov
            j += 1
        out["outside"] += (ge - gs - covered) * 1e-6
    return out


def idle_percent(run, layer: str) -> float | None:
    """The share of the device-only traced stretch in which the device
    idles while the host is in `layer`; None without spans."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    spans = in_stretch(tr)
    if spans is None:
        return None
    return 100.0 * idle_split(tr, spans)[layer] / tr.window_s


def per_root(run, name: str, root_names) -> float | None:
    """Spans named `name` in the device-only stretch per top-level span
    named one of `root_names` (a solve, a tick); None without them."""
    tr = run.trace
    spans = None if tr is None else in_stretch(tr)
    if spans is None:
        return None
    n = sum(x[3].parent < 0 and x[0] in root_names for x in spans)
    if n == 0:
        return None
    return sum(x[0] == name for x in spans) / n


# the spans of a compaction solve after its phase 1: the stragglers' work
STRAGGLER = ("compaction.tail_round", "compaction.restart", "compaction.polish", "sync.polish_readback",
             "sync.final_readback")


def straggler_percent(spans) -> float | None:
    """The union of the straggler spans that start after phase 1 ends,
    over the `compaction.solve` spans they lie in (%); None without a
    compaction solve."""
    total = work = 0.0
    for name, s, e, rec in spans:
        if name != "compaction.solve" or rec.parent >= 0:
            continue
        mine = [x for x in spans if x[3].root == rec.index]
        p1 = [x[2] for x in mine if x[0] == "compaction.phase1"]
        after = max(p1) if p1 else s
        union_end = after
        for _, s2, e2, _ in sorted((x for x in mine if x[0] in STRAGGLER and x[1] >= after), key=lambda x: x[1]):
            lo = max(s2, union_end)
            if e2 > lo:
                work += e2 - lo
                union_end = e2
        total += e - s
    return 100.0 * work / total if total > 0 else None

"""polish_share.obstacles: of the traced compaction solve (the device-only
stretch), the share spent in the float64 polish: the union of the
program's `compaction.polish_stage` spans over its `compaction.solve`
span (%).  None where the program has no such span (an older commit) or
no stage ran."""
from benchmark.harness.spans import in_stretch


def read(run):
    spans = None if run.trace is None else in_stretch(run.trace)
    if spans is None:
        return None
    total = work = 0.0
    for name, s, e, rec in spans:
        if name != "compaction.solve" or rec.parent >= 0:
            continue
        total += e - s
        end = s
        for _, s2, e2, _ in sorted((x for x in spans if x[0] == "compaction.polish_stage" and x[3].root == rec.index),
                                   key=lambda x: x[1]):
            lo = max(s2, end)
            if e2 > lo:
                work += e2 - lo
                end = e2
    return 100.0 * work / total if total > 0 and work > 0 else None

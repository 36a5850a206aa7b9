"""straggler_share.fleet: of the traced compaction solve (the device-only
stretch), the share after phase 1 spent in the tail rounds, the restart
cascade, the f64 polish and the read-backs (the program's
`compaction.tail_round`, `compaction.restart`, `compaction.polish`,
`sync.polish_readback` and `sync.final_readback` spans over its
`compaction.solve` span, `harness/spans.py`)."""
from benchmark.harness.spans import in_stretch, straggler_percent


def read(run):
    spans = None if run.trace is None else in_stretch(run.trace)
    return None if spans is None else straggler_percent(spans)

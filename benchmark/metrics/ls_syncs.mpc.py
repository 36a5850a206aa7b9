"""ls_syncs.mpc: the line search's host syncs per traced tick (the
device-only stretch): the program's `sync.line_search` spans per
`mpc.step` span (`harness/spans.py`)."""
from benchmark.harness.spans import per_root


def read(run):
    return per_root(run, "sync.line_search", ("mpc.step",))

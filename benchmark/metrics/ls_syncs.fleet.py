"""ls_syncs.fleet: the line search's host syncs in the traced solve (the
device-only stretch): the program's `sync.line_search` spans per
top-level solve span (`harness/spans.py`)."""
from benchmark.harness.spans import per_root


def read(run):
    return per_root(run, "sync.line_search", ("compaction.solve", "al.solve"))

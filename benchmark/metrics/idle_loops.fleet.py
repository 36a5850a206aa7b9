"""idle_loops.fleet: the share of the traced solve (the device-only
stretch) in which the device idles while the host is in the lockstep
AL-iLQR loops, outside their host reads (the program's `al.*` and `ilqr.*`
spans, `harness/spans.py`)."""
from benchmark.harness.spans import idle_percent


def read(run):
    return idle_percent(run, "loops")

"""tail_rounds.fleet: the compaction driver's tail rounds per solve over the
window (`CompactedALSolver.telemetry["tail_rounds"]`)."""
from benchmark.harness.readers import mean


def read(run):
    return mean(run.counters.get("tail_rounds_per_solve", []))

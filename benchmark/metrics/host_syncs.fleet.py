"""host_syncs.fleet: the solver's host synchronisations per solve over the
window (its `host_syncs` counter)."""
from benchmark.harness.readers import mean


def read(run):
    return mean(run.counters.get("host_syncs_per_solve", []))

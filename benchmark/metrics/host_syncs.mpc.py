"""host_syncs.mpc: the controller's host synchronisations per tick over the
window (`BatchedMPC.host_syncs` after each step)."""
from benchmark.harness.readers import mean


def read(run):
    return mean(run.counters.get("host_syncs_per_tick", []))

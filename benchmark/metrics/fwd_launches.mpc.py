"""fwd_launches.mpc: launches of the fused forward kernel per tick over the
window (the kernel's `launches` counter)."""
from benchmark.harness.readers import mean


def read(run):
    return mean(run.counters.get("fwd_launches_per_tick", []))

"""device_idle.mpc: the share of the traced stretch with no device
activity (torch.profiler)."""
from benchmark.harness.readers import idle_percent


def read(run):
    return idle_percent(run)

"""fwd_roofline.fleet: the fused forward kernel's share of its roofline
over the traced stretch (the frozen count over its device time)."""
from benchmark.harness.readers import roofline_percent


def read(run):
    return roofline_percent(run, "forward", "forward_kernel")

"""bwd_roofline.obstacles: the fused backward kernel's share of its
roofline over the traced stretch, its circle rows counted
(`harness/yardstick_circles.py` over the float32 launches' device time)."""
from benchmark.harness.yardstick_circles import roofline_percent


def read(run):
    return roofline_percent(run)

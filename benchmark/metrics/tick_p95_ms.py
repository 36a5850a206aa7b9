"""tick_p95_ms: the 95th percentile of every tick of the window, each from
the measured states' arrival to the controls on the host (host clock)."""
import statistics


def read(run):
    ticks = run.window["ticks"]
    return 1e3 * statistics.quantiles(ticks, n=100, method="inclusive")[94] if len(ticks) >= 2 else None

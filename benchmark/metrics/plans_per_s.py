"""plans_per_s: SOLVED lanes of every solve in the window over the time from
the window's start to the end of the last of them (host clock)."""


def read(run):
    return run.window["plans"] / run.window["span_s"]

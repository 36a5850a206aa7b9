"""controller_steps_per_s: controllers times ticks over the window's
length, episode resets included (host clock)."""


def read(run):
    return run.window["controllers"] * len(run.window["ticks"]) / run.window["span_s"]

"""Seconds a step: the window over the steps completed in it (the step in
flight at the close finishes and counts)."""


def read(ctx):
    n = len(ctx["latencies"])
    return ctx["window_s"] / n if n else None

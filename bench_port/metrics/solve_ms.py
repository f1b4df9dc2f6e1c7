"""Milliseconds a step spends in the harness's ``solve`` span, totalled
over the window's steps and divided by their number (the profiled steps
left out where there are others)."""


def read(ctx):
    spans = ctx["spans"].get("solve") or []
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

"""The share of the profiled window in which no device operation ran
(busy time: the union of the device events' intervals)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])

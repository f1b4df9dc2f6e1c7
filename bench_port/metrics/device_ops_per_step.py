"""Device operations in the profiled steps, divided by their number."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["steps"]:
        return None
    return len(tr["events"]) / tr["steps"]

"""The device operations that the port's ``product.draw`` spans launched,
for ``draw_device_ms`` and ``draw_roofline_pct``.

A draw span opened on the card records a timing event on its stream as it
begins and as it ends (``incrementalinference_torch.tracing``,
``marks``); the snapshot gives each mark's device time after the end of
the session's marker (``device_us``), the ``spin_kernel`` the recorder
launches first.  Operations on one stream run in the order they were
launched, so the operations launched inside the span are those that run
between its two marks, wherever the host was by then: in a step the
device paces, the host launches ahead and the draw's operations start
inside later host spans, so a device start on the host's clock would put
them there.  An operation belongs to the draws where its middle lies
between the two marks of a draw span, on the device trace's clock: the
marks are read against the marker's end (the harness has already taken
its own marker out of the events, so the program's is the first
``spin_kernel`` left).  The events' clock parts from the trace's by up
to some hundreds of microseconds over a step, which moves only the short
operations at a draw's two edges.

``get(ctx)`` is None where the run was not traced, where the program
records no draw span with marks (a checkout from before them), or where
the trace holds no marker."""

from __future__ import annotations

import bisect

from bench_port.lib import trace as T
from bench_port.lib.program_trace import union

NAME = "product.draw"


def launched(events, origin, marks):
    """The (start, end) of the ``events`` (name, start, end) whose middle
    lies inside one of the ``marks`` (begin, end, microseconds after
    ``origin``), every time on the trace's clock."""
    spans = union([(origin + a, origin + b) for a, b in marks])
    starts = [s for s, _ in spans]
    out = []
    for _, s, e in events:
        mid = 0.5 * (s + e)
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= spans[k][1]:
            out.append((s, e))
    return out


def read(ctx, snap):
    """{"busy_us", "pairs", "spans", "steps"} of ``snap``'s draw spans
    beside ``ctx``'s device trace, or None."""
    tr = ctx.get("trace")
    if not tr or not tr.get("steps"):
        return None
    draws = [s for s in snap["spans"]
             if s["name"] == NAME and s.get("device_us") is not None]
    spins = [e for e in tr["events"] if "spin_kernel" in e[0]]
    if not draws or not spins:
        return None
    marker = min(spins, key=lambda e: e[1])
    ops = launched([e for e in tr["events"] if e is not marker], marker[2],
                   [s["device_us"] for s in draws])
    return {"busy_us": T.device_busy_us(ops), "ops": len(ops),
            "pairs": snap["counters"].get("draw_pairs", 0),
            "spans": draws, "steps": tr["steps"]}


def get(ctx):
    """The run's draw reading, taken once and kept in ``ctx``."""
    if "draw_trace" not in ctx:
        try:
            from incrementalinference_torch import tracing
        except ImportError:
            ctx["draw_trace"] = None
        else:
            ctx["draw_trace"] = read(ctx, tracing.snapshot())
    return ctx["draw_trace"]

"""The port's own spans and counters (``incrementalinference_torch.tracing``)
beside the profiled device trace, for the metrics that split the step by
the program's layers.

The recorder keeps, for the profiler session the harness opens over the
window's first step, every span (name, start and end on
``time.perf_counter_ns``, parent, root, thread, attributes, counters) and
the host time at which its own marker kernel was launched.  The marker is
a ``spin_kernel`` event of the device trace; the harness has already taken
its own out of ``ctx["trace"]["events"]``, so the program's is the first
left.  Its start less its host time is the offset that puts every device
event on the host's clock.  Each device event then belongs, by its start,
to the innermost program span that holds it.

All times here are microseconds on the host's clock.  ``get(ctx)`` is None
where the run was not traced, where the program has no recorder (a
checkout from before it), or where the session recorded nothing; the
device part (``events``) is None where the session launched no marker or
the trace holds none."""

from __future__ import annotations

from bench_port.lib import trace as T

#: the spans whose time ``sweep_self_ms`` takes out of ``solve_tree``
LEAVES = ("graphinit", "tree", "convolve", "product", "bandwidth")


def union(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals):
    return sum(e - s for s, e in intervals)


def overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


class ProgramTrace:
    """One profiled session: spans, counters and the aligned device events
    of ``steps`` steps."""

    def __init__(self, snap, events, steps):
        self.steps = steps
        self.counters = dict(snap["counters"])
        #: (name, start_us, end_us, id, parent) of every span that ended
        self.spans = [(s["name"], s["start_ns"] / 1e3, s["end_ns"] / 1e3,
                       s["id"], s["parent"])
                      for s in snap["spans"] if s["end_ns"] is not None]
        self.by_id = {sp[3]: sp for sp in self.spans}
        self.events = None
        marks = [e for e in events if "spin_kernel" in e[0]]
        if snap["marker_ns"] is not None and marks:
            mark = min(marks, key=lambda e: e[1])
            offset = mark[1] - snap["marker_ns"] / 1e3
            #: (name, start_us, end_us) of every device event but the
            #: marker, on the host's clock
            self.events = [(ev[0], ev[1] - offset, ev[2] - offset)
                           for ev in events if ev is not mark]
        self._unions = {}

    def union_of(self, *names):
        """The sorted disjoint union of the spans of these names."""
        key = tuple(sorted(names))
        if key not in self._unions:
            self._unions[key] = union([(s, e) for n, s, e, _, _ in self.spans
                                       if n in key])
        return self._unions[key]

    def ms_per_step(self, name):
        """Milliseconds a step covered by spans named ``name``."""
        return length(self.union_of(name)) / 1e3 / self.steps

    def self_ms_per_step(self, outer, inner):
        """Milliseconds a step inside ``outer`` spans covered by none of the
        ``inner`` names."""
        out = self.union_of(outer)
        return (length(out) - overlap(out, self.union_of(*inner))) \
            / 1e3 / self.steps

    def innermost(self, times):
        """For each of the sorted host times, the id of the innermost span
        holding it (the latest begun that has not ended), or None."""
        spans = sorted(self.spans, key=lambda sp: sp[1])
        out, stack, k = [], [], 0
        for t in times:
            while k < len(spans) and spans[k][1] <= t:
                stack.append(spans[k])
                k += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            # a span below the top may have ended: the top is still the
            # latest begun of those open
            out.append(stack[-1][3] if stack else None)
        return out

    def within(self, span_id, name):
        """Whether span ``span_id`` is named ``name`` or nests in one."""
        while span_id is not None and span_id in self.by_id:
            sp = self.by_id[span_id]
            if sp[0] == name:
                return True
            span_id = sp[4]
        return False

    def ops_per_step(self, name):
        """Device operations a step whose start falls inside a span named
        ``name``, or within one (None without the device trace)."""
        if self.events is None:
            return None
        owners = self.innermost(sorted(s for _, s, _ in self.events))
        inside = {o: self.within(o, name) for o in set(owners)}
        return sum(inside[o] for o in owners) / self.steps

    def idle_pct(self, name):
        """Percent of the time of spans named ``name`` in which no device
        operation ran (None without the device trace or such spans)."""
        spans = self.union_of(name)
        if self.events is None or not spans:
            return None
        gaps = T.idle_gaps([(s, e) for _, s, e in self.events],
                           spans[0][0], spans[-1][1])
        return 100.0 * overlap(spans, gaps) / length(spans)


def analyse(ctx, snap):
    """The :class:`ProgramTrace` of ``snap`` beside ``ctx``'s device trace,
    or None where either is empty."""
    tr = ctx.get("trace")
    if not tr or not tr.get("steps") or not snap["spans"]:
        return None
    return ProgramTrace(snap, tr["events"], tr["steps"])


def get(ctx):
    """The run's :class:`ProgramTrace`, taken once and kept in ``ctx``."""
    if "program_trace" not in ctx:
        try:
            from incrementalinference_torch import tracing
        except ImportError:
            ctx["program_trace"] = None
        else:
            ctx["program_trace"] = analyse(ctx, tracing.snapshot())
    return ctx["program_trace"]


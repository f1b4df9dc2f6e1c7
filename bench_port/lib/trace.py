"""The profiler's device events reduced to busy time, idle gaps and the
operations that took most time.  The busy merge is a copy of
``chip_smoke.py``'s ``_device_busy_us``."""

from __future__ import annotations


def device_busy_us(spans):
    """Microseconds covered by the union of (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(spans, start, end):
    """The (start, end) intervals of [start, end] that no span covers."""
    gaps, cur = [], start
    for s, e in sorted(spans):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]


def label_at(t, host_spans):
    """The name of the host span (name, start, end) that holds time t."""
    for name, s, e in host_spans:
        if s <= t < e:
            return name
    return "between steps"


def top_ops(events, k=10):
    """[[name, seconds], ...] of the k device operations with the most
    total time; ``events`` are (name, start_us, end_us)."""
    tot = {}
    for name, s, e in events:
        tot[name] = tot.get(name, 0.0) + (e - s)
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:200], us / 1e6] for name, us in ranked]


def top_gaps(gaps, host_spans, k=10):
    """[[host span, seconds], ...] of the k longest idle gaps, each named
    by the host span its middle falls in."""
    ranked = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
    return [[label_at(0.5 * (s + e), host_spans), (e - s) / 1e6]
            for s, e in ranked]

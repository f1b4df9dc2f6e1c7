"""The readers of the port's own spans and counters
(``bench_port/lib/program_trace.py`` and its metrics) on a synthetic
session: the marker's offset, the unions of the spans of a name, and the
device events each span holds."""

import sys

import pytest

import incrementalinference_torch as it
from incrementalinference_torch import tracing

from bench_port.lib import program_trace, registry

METRICS = ("convolve_ms", "product_ms", "bandwidth_ms", "graphinit_ms",
           "sweep_self_ms", "jacobian_passes_per_step",
           "convolve_ops_per_step", "convolve_idle_pct")


def synthetic():
    """A snapshot and a device trace of two steps: the program's marker
    launched at host 1,000 µs, seen at device 5,000 µs (offset 4,000)."""
    def sp(i, name, s, e, parent=None, counts=None):
        return {"id": i, "name": name, "start_ns": int(s * 1e3),
                "end_ns": int(e * 1e3), "parent": parent, "root": 0,
                "thread": 1, "attrs": {}, "counts": counts or {}}

    spans = [sp(0, "solve_tree", 1000, 2000),
             sp(1, "graphinit", 1010, 1100, 0),
             sp(2, "convolve", 1020, 1080, 1),
             sp(3, "tree", 1100, 1120, 0),
             sp(4, "sweep.up", 1150, 1900, 0),
             sp(5, "update", 1180, 1700, 4),
             sp(6, "convolve", 1200, 1500, 5, {"jacobian_passes": 48}),
             sp(7, "product", 1500, 1600, 5),
             sp(8, "bandwidth", 1600, 1650, 5)]
    snap = {"spans": spans, "counters": {"jacobian_passes": 48},
            "marker_ns": 1_000_000, "marker_device": "cuda:0"}

    def dev(name, s, e):                       # host times → device clock
        return (name, s + 4000.0, e + 4000.0)

    events = [dev("spin_kernel", 1000, 1000.5),      # the program's marker
              dev("add", 1030, 1040),                # convolve in graphinit
              dev("mul", 1250, 1300), dev("neg", 1280, 1350),
              dev("log", 1400, 1420),
              dev("gemm", 1490, 1510),               # starts in convolve
              dev("row_lse", 1520, 1590),            # product
              dev("spin_kernel", 1595, 1596),        # a later spin, in product
              dev("copy", 1950, 1960)]               # the sweep's own
    ctx = {"trace": {"events": events, "steps": 2, "busy_us": 0.0,
                     "window_us": 1.0, "problems": 0}}
    return ctx, snap


def read_all(ctx):
    return {m: registry.module("metrics", m).read(ctx) for m in METRICS}


def test_metric_readers_on_a_synthetic_session(monkeypatch):
    ctx, snap = synthetic()
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    got = read_all(ctx)
    # unions of the spans of a name: convolve 60 + 300 µs
    assert got["convolve_ms"] == pytest.approx(0.360 / 2)
    assert got["product_ms"] == pytest.approx(0.100 / 2)
    assert got["bandwidth_ms"] == pytest.approx(0.050 / 2)
    assert got["graphinit_ms"] == pytest.approx(0.090 / 2)
    # solve_tree 1,000 µs less the leaves [1010, 1120] and [1200, 1650]
    assert got["sweep_self_ms"] == pytest.approx(0.440 / 2)
    assert got["jacobian_passes_per_step"] == 24
    # by aligned start: add, mul, neg, log, gemm (the marker left out)
    assert got["convolve_ops_per_step"] == 5 / 2
    # busy inside convolve: 10 + 100 + 20 + 10 (gemm clipped) of 360 µs
    assert got["convolve_idle_pct"] == pytest.approx(100 * 220 / 360)
    pt = program_trace.get(ctx)
    # sweep.up [1150, 1900]: busy 1250-1350, 1400-1420, 1490-1510,
    # 1520-1590 and the later spin 1595-1596, 211 of 750 µs
    assert pt.idle_pct("sweep.up") == pytest.approx(100 * 539 / 750)
    assert pt.idle_pct("nothing") is None


def test_metric_readers_without_a_session(monkeypatch):
    ctx, snap = synthetic()
    assert all(v is None for v in read_all({"trace": None}).values())
    monkeypatch.setattr(tracing, "snapshot", lambda: dict(snap, spans=[]))
    assert all(v is None for v in read_all(dict(ctx)).values())
    # a session without the marker reads its spans, not the device
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: dict(snap, marker_ns=None))
    got = read_all(dict(ctx))
    assert got["convolve_ms"] == pytest.approx(0.18)
    assert got["convolve_ops_per_step"] is None
    assert got["convolve_idle_pct"] is None
    # a checkout whose port has no recorder: nothing, and no error
    monkeypatch.delattr(it, "tracing")
    monkeypatch.setitem(sys.modules, "incrementalinference_torch.tracing",
                        None)
    assert all(v is None for v in read_all(dict(ctx)).values())


"""The port's recorder (incrementalinference_torch/tracing.py) and the spans
and counters at its layer boundaries.

The recorder records while a ``torch.profiler`` session records and at no
other time; these tests open CPU sessions.  The one test marked ``card``
needs an NVIDIA card and skips here; on the card:
``python -m pytest --noconftest tests/test_torch_tracing.py -m card``.
The benchmark's readers of the recorder are tested in
``bench_port/tests/test_bench_port_program_trace.py``.
"""

from __future__ import annotations

import inspect
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import incrementalinference_torch as it
from incrementalinference_torch import tracing
from incrementalinference_torch.parallel.scheduler import CliqueTrace

LEAF_SPANS = {"graphinit", "tree", "sweep.up", "sweep.down", "clique.up",
              "clique.down", "gibbs", "update", "convolve", "bandwidth",
              "product", "product.draw", "message", "kde_logpdf"}


def cpu_session():
    """A CPU profiler session, after one boundary outside any: the first
    span inside begins a session of its own."""
    with tracing.span("outside"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def se2_pair(n=24, seed=5):
    """Two SE(2) poses as bench_port/graphs/se2pair.py builds them."""
    M = it.SE2()
    vt = it.VariableType("Pose2", M)
    fg = it.initfg(it.SolverParams(N=n, graphinit=True, batch_cliques=False,
                                   seed=seed), device="cpu")
    fg.add_variable("x0", vt)
    fg.add_variable("x1", vt)
    fg.add_factor(["x0"], it.ManifoldPrior(
        M, np.zeros(3, np.float32), it.MvNormal([0.0] * 3, [0.01] * 3)))
    fg.add_factor(["x0", "x1"], it.ManifoldFactor(
        M, it.MvNormal([10.0, 0.0, np.pi / 2], [0.5, 0.5, 0.05])))
    return fg


def by_id(snap):
    return {s["id"]: s for s in snap["spans"]}


def test_nothing_recorded_without_a_profiler(monkeypatch):
    """Outside a session a boundary reads the flag and nothing else: no
    clock, no span, no counter; the last session stays as it was."""
    with cpu_session():
        with tracing.span("before"):
            tracing.count("c", 2)
    before = tracing.snapshot()
    assert [s["name"] for s in before["spans"]] == ["before"]

    def no_clock():
        raise AssertionError("a clock read outside a session")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    with tracing.span("off", torch.device("cpu")) as sp:
        assert sp is None
        tracing.count("c", 5)
    monkeypatch.undo()
    fg = se2_pair(n=16)
    it.solve_tree(fg)
    it.set_ppe(fg, "x1")
    assert tracing.snapshot() == before


def test_spans_nest_and_each_api_call_is_a_root():
    with cpu_session():
        with tracing.span("a") as a:
            a.attrs["k"] = 1
            with tracing.span("b") as b:
                with tracing.span("c") as c:
                    pass
            with tracing.span("d") as d:
                pass
        fg = se2_pair(n=16)
        it.solve_tree(fg)
    snap = tracing.snapshot()
    spans = by_id(snap)
    assert spans[b.id]["parent"] == a.id and spans[c.id]["parent"] == b.id
    assert spans[d.id]["parent"] == a.id
    assert {spans[x.id]["root"] for x in (a, b, c, d)} == {a.id}
    assert spans[a.id]["attrs"] == {"k": 1}
    assert all(s["start_ns"] <= s["end_ns"] for s in snap["spans"])
    roots = [s["name"] for s in snap["spans"] if s["parent"] is None]
    assert roots == ["a", "add_variable", "add_variable", "add_factor",
                     "add_factor", "solve_tree"]
    # every span of the solve shares the solve's root, and nests inside
    # its parent's interval
    solve = next(s for s in snap["spans"] if s["name"] == "solve_tree")
    inside = [s for s in snap["spans"] if s["root"] == solve["id"]]
    assert {s["name"] for s in inside} >= {"tree", "sweep.up", "convolve"}
    for s in inside:
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_a_session_restarts_cleanly():
    with cpu_session():
        with tracing.span("first"):
            tracing.count("n", 3)
    with tracing.span("between"):
        tracing.count("n", 100)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("second"):
            tracing.count("n", 4)
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["second"]
    assert snap["counters"] == {"n": 4}
    assert snap["spans"][0]["parent"] is None
    assert snap["marker_ns"] is None           # a CPU session: no marker


def test_back_to_back_sessions_with_a_snapshot_between():
    """Two sessions with no port call between them, each read after its
    ``with``: the snapshot taken with the flag clear ends the first, so
    the second holds its own spans alone."""
    with cpu_session():
        with tracing.span("first"):
            tracing.count("n", 3)
    first = tracing.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("second"):
            tracing.count("n", 4)
    second = tracing.snapshot()
    assert [s["name"] for s in first["spans"]] == ["first"]
    assert first["counters"] == {"n": 3}
    assert [s["name"] for s in second["spans"]] == ["second"]
    assert second["counters"] == {"n": 4}
    # a snapshot inside a session does not end it
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            pass
        tracing.snapshot()
        with tracing.span("b"):
            pass
    assert [s["name"] for s in tracing.snapshot()["spans"]] == ["a", "b"]


def test_a_spanned_function_keeps_its_signature_and_reads_args_only_on():
    """``spanned`` wraps a function without changing what it takes or
    gives; its attributes and device are read only while a session
    records, and a root span's device is the one it names."""
    calls = []

    def attrs(x, y=2):
        calls.append("attrs")
        return {"x": x, "y": y}

    @tracing.spanned("f", attrs, device=lambda x, y=2: torch.device("cpu"))
    def f(x, y=2):
        """f's doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "f's doc"
    assert list(inspect.signature(f).parameters) == ["x", "y"]
    assert f(1) == 3 and calls == []
    with cpu_session():
        assert f(1, y=5) == 6
    assert calls == ["attrs"]
    (sp,) = tracing.snapshot()["spans"]
    assert sp["name"] == "f" and sp["attrs"] == {"x": 1, "y": 5}
    assert sp["end_ns"] is not None


def test_counters_land_in_the_innermost_span():
    with cpu_session():
        tracing.count("loose")
        with tracing.span("outer") as outer:
            tracing.count("x")
            with tracing.span("inner") as inner:
                tracing.count("x", 2)
                tracing.count("y")
            tracing.count("x", 4)
    spans = by_id(tracing.snapshot())
    assert spans[outer.id]["counts"] == {"x": 5}
    assert spans[inner.id]["counts"] == {"x": 2, "y": 1}
    assert tracing.snapshot()["counters"] == {"loose": 1, "x": 7, "y": 1}


def test_two_threads_solving_at_once_keep_separate_stacks():
    fgs = [se2_pair(n=16, seed=s) for s in (1, 2)]
    errors = []
    gate = threading.Barrier(2, timeout=60)

    def solve(fg):
        try:
            gate.wait()
            it.solve_tree(fg)
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    with cpu_session():
        threads = [threading.Thread(target=solve, args=(fg,)) for fg in fgs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    snap = tracing.snapshot()
    spans = by_id(snap)
    roots = [s for s in snap["spans"] if s["parent"] is None]
    assert [s["name"] for s in roots] == ["solve_tree", "solve_tree"]
    assert roots[0]["thread"] != roots[1]["thread"]
    for s in snap["spans"]:
        root = spans[s["root"]]
        assert root["name"] == "solve_tree"
        assert s["thread"] == root["thread"]
        if s["parent"] is not None:
            assert spans[s["parent"]]["thread"] == s["thread"]
    # the two solves overlapped, so only separate stacks keep them apart
    a, b = roots
    assert a["start_ns"] < b["end_ns"] and b["start_ns"] < a["end_ns"]


def test_counter_totals_lose_no_update_across_threads():
    """Eight threads at a short switch interval count 2,000 each."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_session():
            def work():
                with tracing.span("w"):
                    for _ in range(2000):
                        tracing.count("hits")

            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = tracing.snapshot()
    assert snap["counters"] == {"hits": 16000}
    assert [s["counts"] for s in snap["spans"]] == [{"hits": 2000}] * 8


def test_cpu_se2_solve_records_every_leaf_span(monkeypatch):
    """Every span of the step's layers, and the Jacobian passes counted as
    the LM loops make them (each pass is one call of the jacrev'd
    residual under vmap; no closed-form factor on SE(2))."""
    from incrementalinference_torch.ops import convolve

    passes = [0]
    real = convolve.jacrev

    def counting_jacrev(fn, **kw):
        inner = real(fn, **kw)

        def call(*a, **k):
            passes[0] += 1
            return inner(*a, **k)
        return call

    monkeypatch.setattr(convolve, "jacrev", counting_jacrev)
    with cpu_session():
        fg = se2_pair(n=24)
        it.solve_tree(fg)
        it.set_ppe(fg, "x0")
    snap = tracing.snapshot()
    names = {s["name"] for s in snap["spans"]}
    assert LEAF_SPANS | {"solve_tree", "set_ppe", "add_factor"} <= names
    c = snap["counters"]
    assert passes[0] > 0 and c["jacobian_passes"] == passes[0]
    # no closed-form factor on SE(2): one pass an LM iteration, and the
    # residuals before and after each; on the CPU every solve (8 LM
    # iterations each) is eager, and so is the estimate read of x0 (its
    # 24 x 24 pairs)
    assert set(c) == {"jacobian_passes", "conv_eager_solves", "draw_pairs",
                      "kde_eager_pairs"}
    assert c["jacobian_passes"] == 8 * c["conv_eager_solves"]
    assert c["kde_eager_pairs"] == 24 * 24
    # every product's column draw in a span of its own, nested in the
    # product, which counts the pairs it weighs
    ids = by_id(snap)
    draws = [s for s in snap["spans"] if s["name"] == "product.draw"]
    assert draws
    assert all(ids[s["parent"]]["name"] == "product" for s in draws)
    assert sum(s["counts"]["draw_pairs"] for s in draws) == c["draw_pairs"]
    assert c["draw_pairs"] == sum(s["attrs"]["members"] * s["attrs"]["rows"]
                                  * s["attrs"]["nb"] for s in draws)
    convs = [s for s in snap["spans"] if s["name"] == "convolve"]
    assert {s["attrs"]["factor"] for s in convs} == {"ManifoldPrior",
                                                     "ManifoldFactor"}
    assert sum(s["counts"].get("jacobian_passes", 0) for s in convs) \
        == c["jacobian_passes"]
    cliques = [s for s in snap["spans"] if s["name"] == "clique.up"]
    assert cliques and all("cid" in s["attrs"] for s in cliques)


def test_clique_traces_stamp_the_recorder_clock(tmp_path):
    t0 = time.perf_counter()
    tr = CliqueTrace(1)
    tr.log("a", "b")
    assert t0 <= tr.events[0][0] <= time.perf_counter()
    unkept = CliqueTrace(2, keep=False)
    unkept.log("a")
    assert unkept.events == []

    fg = se2_pair(n=16)
    fg.params = fg.params.replace(record_cliques=True,
                                  logpath=str(tmp_path))
    w0 = time.time()
    tree = it.solve_tree(fg)
    w1 = time.time()
    assert tree.traces and 0.0 <= tree.build_time <= w1 - w0
    with open(tmp_path / "HistoryAll_0.txt") as f:
        stamps = [float(line.split("\t")[0]) for line in f]
    # wall-clock seconds, as the files always held (3 decimals)
    assert stamps and all(w0 - 1e-3 <= s <= w1 + 1e-3 for s in stamps)

    # a solve without record_cliques hands its cliques unkept traces
    fg2 = se2_pair(n=16)
    assert it.solve_tree(fg2).traces == {}


@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_longest_idle_gap_lies_in_the_sleeping_span(card):
    from torch.autograd import DeviceType

    x = torch.randn(2048, 2048, device=card)
    # first calls load cuBLAS and the kernels on the host, with the device
    # idle: done here, so that the sleep makes the longest gap
    torch.tanh(x @ x * 1e-3) + 1.0
    torch.cuda.synchronize()
    with tracing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("work", card):
            for _ in range(20):
                x = torch.tanh(x @ x * 1e-3)
        with tracing.span("sleeping"):
            x = x + 1.0
            time.sleep(0.05)
            x = x + 1.0
        torch.cuda.synchronize()
    events = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA)
    snap = tracing.snapshot()
    # the marker is the recorder's only device work, and puts the device
    # events on the spans' clock (microseconds)
    marks = [e for e in events if "spin_kernel" in e[2]]
    assert len(marks) == 1 and snap["marker_ns"] is not None
    offset = marks[0][0] - snap["marker_ns"] / 1e3
    busy_end, gaps = None, []
    for s, e, _ in events:
        if busy_end is not None and s > busy_end:
            gaps.append((busy_end - offset, s - offset))
        busy_end = e if busy_end is None else max(busy_end, e)
    lo, hi = max(gaps, key=lambda g: g[1] - g[0])
    assert hi - lo > 4e4                      # the 50 ms sleep
    mid_ns = 500.0 * (lo + hi)
    holding = [sp["name"] for sp in snap["spans"]
               if sp["start_ns"] <= mid_ns <= sp["end_ns"]]
    assert holding == ["sleeping"]

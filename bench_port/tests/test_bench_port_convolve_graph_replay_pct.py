"""The reader of ``convolve_graph_replay_pct`` on a synthetic session: the
replays' share of the three solve counters, and nothing where the program
counts none of them (a checkout from before the counters)."""

import pytest

from incrementalinference_torch import tracing

from bench_port.lib import registry
from bench_port.tests.test_bench_port_program_trace import synthetic


def read(monkeypatch, counters):
    ctx, snap = synthetic()
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: dict(snap, counters=counters))
    return registry.module("metrics", "convolve_graph_replay_pct").read(ctx)


@pytest.mark.parametrize("counters,want", [
    ({"conv_graph_replays": 27}, 100.0),
    ({"conv_graph_replays": 21, "conv_graph_captures": 2,
      "conv_eager_solves": 4, "jacobian_passes": 216}, 100.0 * 21 / 27),
    ({"conv_eager_solves": 27}, 0.0),
    ({"jacobian_passes": 216}, None),
    ({}, None)])
def test_replay_share_of_the_solve_counters(monkeypatch, counters, want):
    got = read(monkeypatch, counters)
    assert got == (want if want is None else pytest.approx(want))


def test_nothing_without_a_session(monkeypatch):
    reader = registry.module("metrics", "convolve_graph_replay_pct")
    assert reader.read({"trace": None}) is None

"""The metrics' arithmetic on synthetic profiler events."""

import pytest

from bench_port.lib import trace as T
from bench_port.metrics import (device_idle_pct, device_ops_per_step,
                                pair_lse_roofline_pct as R, solve_ms)


def test_busy_merge_counts_each_covered_microsecond_once():
    spans = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 41)]
    assert T.device_busy_us(spans) == 15 + 11 + 1
    assert T.device_busy_us([]) == 0


def test_idle_gaps_and_their_labels():
    gaps = T.idle_gaps([(2, 4), (3, 6), (8, 9)], 0, 12)
    assert gaps == [(0, 2), (6, 8), (9, 12)]
    host = [("build", 0, 5), ("solve", 5, 10)]
    assert T.top_gaps(gaps, host, k=2) == [["between steps", 3e-6],
                                           ["build", 2e-6]]


def test_idle_share_and_operations_a_step():
    tr = {"events": [("a", 0, 10), ("b", 5, 15), ("c", 50, 60)],
          "busy_us": T.device_busy_us([(0, 10), (5, 15), (50, 60)]),
          "window_us": 100.0, "steps": 2, "problems": 0}
    ctx = {"trace": tr, "spans": {"solve": [0.5, 1.5]}}
    assert device_idle_pct.read(ctx) == pytest.approx(75.0)
    assert device_ops_per_step.read(ctx) == 1.5
    assert solve_ms.read(ctx) == pytest.approx(1000.0)
    assert R.read(ctx) is None          # no problem: nothing to read
    assert device_idle_pct.read({"trace": None}) is None


def test_the_exponential_bound_binds_at_the_cells_shapes():
    for dof in (1, 3, 6):
        b = R.least_seconds(12, 50_000, dof)
        assert b["exp"] == max(b.values())
    # one problem of 50k x 50k: 2.5e9 exponentials over the lanes and SFUs
    lanes = 132 * 128 * 1.98e9
    sfu = 132 * 16 * 1.98e9
    assert R.least_seconds(1, 50_000, 3)["exp"] == pytest.approx(
        2.5e9 / (lanes + sfu))


def test_the_roofline_reads_100_at_the_bound_and_never_more_below_it():
    n, dof, problems = 50_000, 3, 12
    t = max(R.least_seconds(problems, n, dof).values())
    per = t / 2 * 1e6
    events = [("row_lse_partial(float const*)", 0.0, per),
              ("row_lse_combine(float const*)", per, 2 * per),
              ("some other kernel", 0.0, 1e6)]
    ctx = {"cfg": {"N": n, "dof": dof},
           "trace": {"events": events, "problems": problems}}
    assert R.read(ctx) == pytest.approx(100.0)
    ctx["trace"]["events"] = [(a, s, e * 1.6) for a, s, e in events]
    assert R.read(ctx) < 100.0
    # the section 6 bound (one exp a pair on the SFUs alone) is slower than
    # this one: a kernel at it reads under 100 %
    sfu_only = problems * n * n / (132 * 16 * 1.98e9)
    ctx["trace"]["events"] = [("row_lse_partial", 0.0, sfu_only * 1e6)]
    assert R.read(ctx) < 100.0

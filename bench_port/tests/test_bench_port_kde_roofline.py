"""``kde_roofline_pct``: the KDE read kernel's share of its roofline, on
synthetic traces: its work and least time for known counts, nothing to
read where the kernel read no pair, and never above 100 % for any count
and time the kernel could give."""

import pytest

from bench_port.metrics import kde_roofline_pct as R

RATE = 132 * 1.98e9


def _span(n, q, pairs):
    return {"name": "kde_logpdf", "attrs": {"N": n, "Q": q},
            "counts": {"kde_pairs": pairs} if pairs else {}}


def _ctx(events, point_dim=3, dof=3):
    return {"trace": {"events": events, "steps": 1},
            "cfg": {"point_dim": point_dim, "dof": dof}}


def test_the_least_time_of_two_50k_reads_by_hand():
    """2 x 50,000^2 pairs over 132 SMs x (128 lanes + 16 SFUs) x 1.98 GHz,
    133 us; the bytes of one SE(2) read, 4 x (3 x 100,000 + 3 + 50,000),
    are 0.42 us at 3.35 TB/s."""
    assert R.read_bytes(1, 50_000, 50_000, 3, 3) == 1_400_012
    assert R.read_bytes(4, 10, 2, 1, 1) == 4 * 4 * (12 + 1 + 2)
    b = R.least_seconds(5e9, 2 * R.read_bytes(1, 50_000, 50_000, 3, 3))
    assert b["exp"] == pytest.approx(5e9 / (RATE * 144))
    assert b["exp"] == pytest.approx(132.9e-6, rel=1e-3)
    assert b["bytes"] == pytest.approx(2 * 1_400_012 / 3.35e12)


def test_the_share_of_a_traced_step():
    """Two reads (x0 and x1) of 50k x 50k; the kernel's three kernels, by
    name among others, take 10 ms in all."""
    events = [("spin_kernel", 0.0, 10.0),
              ("void (anonymous namespace)::kde_lse_prep<SE2>(...)",
               10.0, 20.0),
              ("void (anonymous namespace)::kde_lse_partial<SE2>(...)",
               20.0, 4_970.0),
              ("void (anonymous namespace)::kde_lse_combine(...)",
               4_970.0, 5_010.0),
              ("void (anonymous namespace)::row_lse_partial<3>(...)",
               5_010.0, 9_000.0),
              ("void (anonymous namespace)::kde_lse_prep<SE2>(...)",
               9_000.0, 9_010.0),
              ("void (anonymous namespace)::kde_lse_partial<SE2>(...)",
               9_010.0, 13_960.0),
              ("void (anonymous namespace)::kde_lse_combine(...)",
               13_960.0, 14_000.0)]
    pairs = 50_000 * 50_000
    snap = {"counters": {"kde_pairs": 2 * pairs},
            "spans": [_span(50_000, 50_000, pairs),
                      _span(50_000, 50_000, pairs),
                      _span(100, 7, 0)]}
    assert R.kernel_seconds(events) == pytest.approx(10e-3)
    want = 100 * (2 * pairs / (RATE * 144)) / 10e-3
    assert R.compute(_ctx(events), snap) == pytest.approx(want)
    assert R.compute(_ctx(events), snap) == pytest.approx(1.329, rel=1e-3)


def test_nothing_to_read_without_the_kernels_pairs():
    events = [("void kde_lse_partial<SE2>", 0.0, 10.0)]
    eager = {"counters": {"kde_eager_pairs": 5e9},
             "spans": [_span(50_000, 50_000, 0)]}
    assert R.compute(_ctx(events), eager) is None
    assert R.compute(_ctx(events), {"counters": {}, "spans": []}) is None
    counted = {"counters": {"kde_pairs": 100},
               "spans": [_span(10, 10, 100)]}
    assert R.compute({"trace": None, "cfg": {}}, counted) is None
    assert R.compute(_ctx([("elementwise", 0.0, 5.0)]), counted) is None


@pytest.mark.parametrize("members,n,q", [
    (1, 50_000, 50_000), (2, 50_000, 50_000), (1, 50_000, 1),
    (8, 4096, 4096), (1, 300, 997), (64, 100, 100)])
@pytest.mark.parametrize("point_dim,dof", [(1, 1), (3, 3), (8, 8)])
def test_never_above_100_for_a_time_the_kernel_could_give(members, n, q,
                                                          point_dim, dof):
    """The kernel spends one ex2 a pair on the SFUs, so it takes at least
    pairs over the SFU rate, and at least the bytes' time: at that least
    time, and above it, the share is at most 100 % (16 / 144 of it where
    the exponentials bind)."""
    pairs = members * n * q
    nbytes = R.read_bytes(members, n, q, point_dim, dof)
    fastest = max(pairs / (RATE * 16), nbytes / 3.35e12)
    snap = {"counters": {"kde_pairs": pairs},
            "spans": [_span(n, q, pairs)]}
    for t in (fastest, 1.5 * fastest, 10 * fastest):
        events = [("kde_lse_partial<M>", 0.0, t * 1e6)]
        got = R.compute(_ctx(events, point_dim, dof), snap)
        assert 0 < got <= 100.0 * (1 + 1e-9), (t, got)
    if nbytes / 3.35e12 <= pairs / (RATE * 144):
        events = [("kde_lse_partial<M>", 0.0, fastest * 1e6)]
        assert R.compute(_ctx(events, point_dim, dof), snap) \
            == pytest.approx(100 * 16 / 144)

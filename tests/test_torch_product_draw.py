"""The pair products' column draws against the plain product of two
kernel densities (``bench_port/reference/pair_product.py``), and the span
and counters each route's draws record.

Each route's drawn pairs are read back from its output: in dimension 0
both sides constrain the pair and decide its weight; dimension 1 is free
in B, so the merged component keeps A's value there, the row's index;
dimension 2 is free in A and keeps B's, the column's.  The pair weights
depend on dimension 0 alone.

The tests marked ``card`` need an NVIDIA card and skip here; on the card
(the large route there draws its columns by the kernel of
``ops/kernels/pair_draw.py``): ``python -m pytest --noconftest
tests/test_torch_product_draw.py -m card``."""

from __future__ import annotations

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port.reference import pair_product as ref
from incrementalinference_torch import keys as _keys
from incrementalinference_torch import tracing
from incrementalinference_torch.ops import product

NA = NB = 48
N_OUT = 4096
CALLS = 16
ROUTES = ("materialised", "condensed", "large")


def _inputs(route, members=1, device="cpu"):
    """(muA, precA, muB, precB, logwB) with a leading member axis; B's
    precision row is shared by its components (a kernel density's
    bandwidth, and the condensed route's clusters here), so the plain
    law's overlap normaliser is one constant."""
    g = torch.Generator().manual_seed(17)
    muA = torch.zeros(members, NA, 3)
    muA[..., 0] = torch.randn(members, NA, generator=g)
    muA[..., 1] = torch.arange(NA, dtype=torch.float32)
    muB = torch.zeros(members, NB, 3)
    muB[..., 0] = 0.5 + torch.randn(members, NB, generator=g)
    muB[..., 2] = torch.arange(NB, dtype=torch.float32)
    precA = torch.tensor([4.0, 1.0, 0.0]).expand(members, NA, 3).clone()
    precB = torch.tensor([4.0, 0.0, 1.0]).expand(members, NB, 3).clone()
    logwB = (0.7 * torch.randn(members, NB, generator=g)
             if route == "condensed" else None)
    return tuple(None if t is None else t.to(device)
                 for t in (muA, precA, muB, precB, logwB))


def _draw(route, key, members=1, device="cpu"):
    """(mu, prec) of one call of the route, every member keyed."""
    muA, precA, muB, precB, logwB = _inputs(route, members, device)
    ks = [_keys.make_key(key, m) for m in range(members)]
    if route == "materialised":
        return product.pair_product_tangent(muA, precA, muB, precB, ks,
                                            N_OUT)
    if route == "condensed":
        return product.pair_product_tangent_weighted(
            muA, precA, muB, precB, logwB, ks, N_OUT)
    return product.pair_product_tangent_large(muA, precA, muB, precB, ks,
                                              N_OUT)


def _tv_and_bar(route, device="cpu"):
    """The total-variation distance between the drawn pairs' frequencies
    and the plain law, and its bar: 1.5 times the sum over the pairs of
    half a multinomial count's standard deviation (the distance's mean is
    about 0.8 of that sum, its spread a few hundredths of it)."""
    muA, precA, muB, precB, logwB = _inputs(route)
    law = ref.pair_law(muA[0], precA[0], muB[0], precB[0],
                       None if logwB is None else logwB[0]).reshape(-1)
    counts = torch.zeros(NA * NB, dtype=torch.float64)
    for c in range(CALLS):
        mu, _ = _draw(route, 1000 + c, device=device)
        mu = mu.cpu()
        i = torch.round(mu[0, :, 1]).long()
        j = torch.round(mu[0, :, 2]).long()
        counts += torch.bincount(i * NB + j, minlength=NA * NB).double()
    n = counts.sum()
    tv = 0.5 * float((counts / n - law).abs().sum())
    bar = 1.5 * 0.5 * float(torch.sqrt(law * (1 - law) / n).sum())
    return tv, bar


@pytest.mark.parametrize("route", ROUTES)
def test_drawn_pairs_follow_the_plain_product(route):
    tv, bar = _tv_and_bar(route)
    assert tv < bar, (route, tv, bar)


@pytest.mark.parametrize("route", ROUTES)
def test_negated_row_partitions_fail_the_bar(route, monkeypatch):
    """The planted fault: the rows drawn by their negated log-partitions
    (the row draw is each route's one call of ``keys.categorical``)."""
    real = _keys.categorical
    monkeypatch.setattr(product._keys, "categorical",
                        lambda key, logits, n: real(key, -logits, n))
    tv, bar = _tv_and_bar(route)
    assert tv > 3 * bar, (route, tv, bar)


@pytest.mark.parametrize("route", ROUTES)
def test_uniform_columns_fail_the_bar(route, monkeypatch):
    """The planted column fault: the rows drawn right, each row's column
    drawn uniformly, its weights ignored (the column draw is the
    materialised and condensed routes' call of ``keys.categorical_rows``,
    and the large route's ``pair_column_draw``, whose weights are zeroed by
    zeroing the row terms).  A sound draw reads about half the bar; this
    one 2.6 times it on the materialised and large routes (the right row
    already narrows the columns a pair can take) and more on the
    condensed."""
    if route == "large":
        real = product.pair_column_draw
        monkeypatch.setattr(
            product, "pair_column_draw",
            lambda a2, iva, ivmuA, muB, u: real(0.0 * a2, 0.0 * iva,
                                                0.0 * ivmuA, muB, u))
    else:
        real = _keys.categorical_rows
        monkeypatch.setattr(product._keys, "categorical_rows",
                            lambda key, logits: real(key, 0.0 * logits))
    tv, bar = _tv_and_bar(route)
    assert tv > 2 * bar, (route, tv, bar)


def test_the_plain_law_is_the_normalised_pair_weights():
    muA, precA, muB, precB, logwB = _inputs("condensed")
    lw = ref.log_weights(muA[0], precA[0], muB[0], precB[0], logwB[0])
    law = ref.pair_law(muA[0], precA[0], muB[0], precB[0], logwB[0])
    torch.testing.assert_close(law, torch.softmax(lw.reshape(-1), 0)
                               .reshape(NA, NB))
    # one pair by hand: the overlap in dimension 0 only, and B's weight
    a, b = float(muA[0, 3, 0]), float(muB[0, 5, 0])
    var = 1 / 4 + 1 / 4
    want = (-0.5 * (a - b) ** 2 / var - 0.5 * math.log(2 * math.pi * var)
            + float(logwB[0, 5]))
    assert float(lw[3, 5]) == pytest.approx(want, rel=1e-12)


def _session():
    with tracing.span("outside"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("members", [1, 2])
def test_one_draw_span_a_call_counts_its_pairs(route, members):
    with _session():
        _draw(route, 7, members)
    snap = tracing.snapshot()
    draws = [s for s in snap["spans"] if s["name"] == "product.draw"]
    assert len(draws) == 1
    assert draws[0]["attrs"] == {"route": route, "members": members,
                                 "rows": N_OUT, "na": NA, "nb": NB,
                                 "dof": 3}
    assert draws[0]["device_us"] is None          # no marks on the CPU
    want = {"draw_pairs": members * N_OUT * NB}
    assert snap["counters"] == want and draws[0]["counts"] == want
    # outside a session nothing is recorded
    _draw(route, 8, members)
    assert tracing.snapshot() == snap


@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_stream_marks_hold_the_operations_the_span_launched(card):
    """The host launches a marked span's three kernels while the device is
    still busy with earlier work, so each starts after the span has ended
    on the host's clock; between the span's two marks on the device's
    clock lie those three and nothing else, and the first begins within
    200 us of the first mark.

    The marks are timing events, read against the trace's clock through
    the marker's end; the two clocks part by up to 600 parts per million
    over a session and by some tens of microseconds between sessions, so
    each kernel here is long (about 0.7 ms, a gigabyte read and written)
    next to that, as a draw's block operations are: an operation belongs
    to the span by its middle."""
    from torch.autograd import DeviceType

    x = torch.randn(4096, 4096, device=card)
    y = torch.randn(1 << 28, device=card)
    (x @ x).sum()
    torch.sin(y), torch.cos(y), torch.exp(y)
    torch.cuda.synchronize()
    with tracing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("work", card):
            for _ in range(10):
                x = torch.tanh(x @ x * 1e-3)
            with tracing.span("marked", card, marks=True):
                torch.sin(y)
                torch.cos(y)
                torch.exp(y)
            x = torch.tanh(x @ x * 1e-3)
        torch.cuda.synchronize()
    snap = tracing.snapshot()
    events = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA)
    # the session's marker: its start puts the spans on the trace's clock,
    # its end is the origin of the marks
    [marker] = [e for e in events if "spin_kernel" in e[2]]
    offset = marker[0] - snap["marker_ns"] / 1e3
    span = [s for s in snap["spans"] if s["name"] == "marked"][0]
    lo, hi = (marker[1] + t for t in span["device_us"])
    inside = [e for e in events if lo <= 0.5 * (e[0] + e[1]) <= hi]
    assert len(inside) == 3
    assert all(any(w in e[2] for w in ("sin", "cos", "exp")) for e in inside)
    assert abs(inside[0][0] - lo) < 200.0
    # by their device start they lie after the host span had ended
    assert inside[0][0] - offset > span["end_ns"] / 1e3


@pytest.mark.card
def test_the_large_route_follows_the_plain_product_on_the_card(card):
    """The pair-frequency bar of the CPU routes, with the rows drawn on the
    card and the columns by the draw kernel."""
    from incrementalinference_torch.ops.kernels import pair_draw

    pair_draw.reset_counts()
    tv, bar = _tv_and_bar("large", device=card)
    assert pair_draw.counts["launches"] == CALLS
    assert tv < bar, (tv, bar)

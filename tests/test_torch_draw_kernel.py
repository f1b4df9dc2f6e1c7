"""The large pair product's column draw (``ops/kernels/pair_draw.py``,
``csrc/pair_draw.cu``): the plain version on the CPU, and on the card the
kernel held to it on the same uniforms.

On the CPU: a row whose mass lies in one column draws it whatever its
uniforms; a column of weight 0 is never drawn; a target at or above the
scanned total gives the last column of positive weight; a member drawn
alone is the member drawn in a batch, bit for bit; one key gives one draw;
and the plain version's columns are those of a float64 inverse CDF on the
same uniforms, except where a uniform lies within ``TOL`` of a boundary of
the column drawn.  The source makes no random number and uses no atomics.

The tests marked ``card`` need an NVIDIA card and skip here; on the card:
``python -m pytest --noconftest tests/test_torch_draw_kernel.py -m card``.
There the kernel and the plain version (run on the card) draw with the same
uniforms at dof 1, 3 and 8, Nb 300, 4,096 and 50,000, one member and three,
at the spreads of the benchmark's two cells and a far-apart bimodal pair:
the columns agree on at least 99.99 % of rows, and wherever they part both
lie within ``TOL`` of the uniforms in the float64 law of the kernel's own
log2-weights.  Two launches give the same bits, and a large call counts
``draw_kernel_pairs`` equal to ``draw_pairs``.  This file imports no JAX.
"""

from __future__ import annotations

import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from incrementalinference_torch import keys as _keys
from incrementalinference_torch import tracing
from incrementalinference_torch.ops import product
from incrementalinference_torch.ops.kernels import pair_draw as P
from incrementalinference_torch.ops.kernels.row_lse import pair_row_terms

#: how far (in the normalised CDF) a uniform may lie from the boundary of
#: the interval of the column drawn: the in-split sums round at most 101
#: times on the way to a target (5 in a chunk's butterfly, 64 across the
#: chunks, 32 inside the chunk), 101 x 2^-24 = 6.0e-6 of the split's mass;
#: ex2.approx errs by 2^-22 = 2.4e-7 a weight; the float32 expanded
#: log-weight (|l2| <= 64 at the columns that carry mass here) by 64 x
#: 2^-24 x ln 2 = 2.6e-6 a weight.  Twice their sum, rounded up.
TOL = 2e-5


def _terms(spread, dof, na, nb, gen, members=1):
    """(a2, iva, ivmuA at drawn rows, muB) float32 with a member axis, for
    ``na`` selected rows against ``nb`` columns, in tangent coordinates
    about the pooled mean as the cascade hands them.  ``line2``: the
    line2-n50k cell's products (a prior's kernels, sigma 1 at bandwidth
    0.12, against a sigma-10 message's at 1.2); ``se2``: the se2pair-n50k
    cell's x0 product (the sigma-0.01 prior's kernels at bandwidth 0.0013
    against the message's spread 0.5, 0.5, 0.05 at 0.06, 0.06, 0.006),
    cycled over the dimensions; ``bimodal``: two modes 8 apart on each
    side, kernels at bandwidth 0.5; ``far``: the modes 40 apart, where the
    expanded form's float32 log-weight rounds at 1e-4 (the kernel and the
    plain version share that rounding, and only on the card are they held
    to each other there)."""
    if spread == "line2":
        sa, ba = torch.ones(dof), torch.full((dof,), 0.12)
        sb, bb = torch.full((dof,), 10.0), torch.full((dof,), 1.2)
    elif spread == "se2":
        cyc = torch.tensor([0.5, 0.5, 0.05])[torch.arange(dof) % 3]
        sa, ba = torch.full((dof,), 0.01), torch.full((dof,), 0.0013)
        sb, bb = cyc, 0.12 * cyc
    else:
        sa = sb = torch.ones(dof)
        ba = bb = torch.full((dof,), 0.5)
    muA = torch.randn(members, na, dof, generator=gen) * sa
    muB = torch.randn(members, nb, dof, generator=gen) * sb
    if spread in ("bimodal", "far"):
        half = 4.0 if spread == "bimodal" else 20.0
        muA[:, : na // 2] += half
        muA[:, na // 2:] -= half
        muB[:, : nb // 3] += half
        muB[:, nb // 3:] -= half
    precA = (1.0 / ba ** 2).expand(members, na, dof)
    precB = (1.0 / bb ** 2).expand(members, nb, dof)
    a2, iva, ivmuA = pair_row_terms(muA, precA, muB, precB)
    return a2.contiguous(), iva.contiguous(), ivmuA.contiguous(), \
        muB.contiguous()


def _uniforms(rows, gen, members=1):
    return torch.rand(members, rows, 2, generator=gen)


def _law(l2):
    """The two-stage law in float64 of log2-weights ``l2`` (rows, nb): the
    splits' CDF F (rows, splits + 1) and each split's column CDF G (rows,
    splits, SPLIT_COLS + 1), normalised, each from 0."""
    rows, nb = l2.shape
    splits = -(-nb // P.SPLIT_COLS)
    w = torch.exp2(l2 - l2.amax(dim=1, keepdim=True))
    w = torch.cat([w, w.new_zeros(rows, splits * P.SPLIT_COLS - nb)], 1)
    w = w.view(rows, splits, P.SPLIT_COLS)
    zero = w.new_zeros(rows, splits, 1)
    G = torch.cat([zero, torch.cumsum(w, 2)], 2)
    F = torch.cat([zero[:, 0], torch.cumsum(G[..., -1], 1)], 1)
    return F / F[:, -1:], G / G[..., -1:].clamp(min=1e-300)


def _draw64(l2, u):
    """The columns of the two-stage inverse CDF in float64 on ``u``."""
    F, G = _law(l2)
    rows = l2.shape[0]
    k = (F[:, 1:] <= u[:, :1].double()).sum(1).clamp(max=F.shape[1] - 2)
    g = G[torch.arange(rows), k]
    j = (g[:, 1:] <= u[:, 1:].double()).sum(1).clamp(max=P.SPLIT_COLS - 1)
    return k * P.SPLIT_COLS + j


def _gaps(l2, u, cols):
    """How far each row's uniforms lie outside the intervals of the split
    and the column ``cols`` in the float64 law of ``l2`` (0 inside)."""
    F, G = _law(l2)
    at = torch.arange(l2.shape[0])
    k, j = cols // P.SPLIT_COLS, cols % P.SPLIT_COLS
    u0, u1 = u[:, 0].double(), u[:, 1].double()
    g = G[at, k]

    def outside(x, lo, hi):
        return torch.clamp(torch.maximum(lo - x, x - hi), min=0.0)

    return torch.maximum(outside(u0, F[at, k], F[at, k + 1]),
                         outside(u1, g[at, j], g[at, j + 1]))


def _l2_exact(a2, iva, ivmuA, muB):
    """log2-weights in float64 from the terms: the law the draw stands
    for."""
    a2, iva, ivmuA, muB = (t.double() for t in (a2, iva, ivmuA, muB))
    logw = -0.5 * (a2[:, None] + iva @ (muB.T ** 2) - 2.0 * ivmuA @ muB.T)
    return logw / torch.log(torch.tensor(2.0, dtype=torch.float64))


def _l2_kernel(a2, iva, ivmuA, muB):
    """The kernel's float32 log2-weights, which the plain version
    computes operation for operation."""
    return P._log2_weights(a2 * P._NEG_HALF_LOG2E, iva * P._NEG_HALF_LOG2E,
                           ivmuA * P._LOG2E, muB)


# -- the plain version, on the CPU -------------------------------------------

@pytest.mark.parametrize("nb", [1, 48, 300, 2048, 5000])
def test_a_row_with_all_its_mass_in_one_column_draws_it(nb):
    """Every other column lies so far that its weight is 0 in float32 (and
    in any precision); the uniforms run over [0, 1), both ends included,
    and 1 itself."""
    gen = torch.Generator().manual_seed(nb)
    rows, dof = 257, 2
    hot = nb // 2
    muB = 1e3 + torch.rand(1, nb, dof, generator=gen)
    muA = torch.randn(1, rows, dof, generator=gen) * 0.1
    muB[0, hot] = muA[0, 0] + 0.01
    prec = torch.full((1, 1, dof), 4.0)
    a2, iva, ivmuA = pair_row_terms(muA, prec.expand(1, rows, dof), muB,
                                    prec.expand(1, nb, dof))
    u = _uniforms(rows, gen)
    u[0, :4] = torch.tensor([[0.0, 0.0], [1 - 2 ** -24, 1 - 2 ** -24],
                             [1.0, 1.0], [0.0, 1.0]])
    cols = P.pair_column_draw(a2.contiguous(), iva.contiguous(),
                              ivmuA.contiguous(), muB, u)
    assert bool((cols == hot).all()), cols[cols != hot]


@pytest.mark.parametrize("nb", [300, 5000])
def test_a_column_of_weight_zero_is_never_drawn(nb):
    """Two columns in three lie far off (weight 0), the rest near; the
    uniforms include 0, 1 - 2^-24 and 1 in either place."""
    gen = torch.Generator().manual_seed(3)
    rows, dof = 4000, 1
    muB = torch.randn(1, nb, dof, generator=gen)
    far = torch.rand(nb, generator=gen) < 2 / 3
    muB[0, far] += 1e4
    muA = torch.randn(1, rows, dof, generator=gen)
    prec = torch.full((1, 1, dof), 4.0)
    a2, iva, ivmuA = pair_row_terms(muA, prec.expand(1, rows, dof), muB,
                                    prec.expand(1, nb, dof))
    u = _uniforms(rows, gen)
    ends = torch.tensor([0.0, 1 - 2 ** -24, 1.0])
    u[0, :9] = torch.cartesian_prod(ends, ends)
    cols = P.pair_column_draw(a2.contiguous(), iva.contiguous(),
                              ivmuA.contiguous(), muB, u)
    assert not bool(far[cols[0]].any())
    l2 = _l2_kernel(a2[0], iva[0], ivmuA[0], muB[0])
    assert bool(torch.isfinite(l2[torch.arange(rows), cols[0]]).all())


def test_a_target_at_the_total_gives_the_last_column_of_positive_weight():
    """u = 1 puts each target at its running sum's end, which no partial
    sum passes: the last split of positive mass, and in it the last column
    of positive weight (u1 = 1) or the first (u1 = 0)."""
    gen = torch.Generator().manual_seed(4)
    nb, rows, dof = 3 * P.SPLIT_COLS + 100, 64, 1
    muB = 1e4 + torch.randn(1, nb, dof, generator=gen)
    near = torch.tensor([5, 700, P.SPLIT_COLS + 3, 2 * P.SPLIT_COLS + 40,
                         2 * P.SPLIT_COLS + 41, 2 * P.SPLIT_COLS + 1999])
    muB[0, near, 0] = torch.linspace(-0.5, 0.5, len(near))
    muA = torch.randn(1, rows, dof, generator=gen) * 0.1
    prec = torch.full((1, 1, dof), 4.0)
    a2, iva, ivmuA = pair_row_terms(muA, prec.expand(1, rows, dof), muB,
                                    prec.expand(1, nb, dof))
    args = (a2.contiguous(), iva.contiguous(), ivmuA.contiguous(), muB)
    last = P.pair_column_draw(*args, torch.ones(1, rows, 2))
    assert bool((last == 2 * P.SPLIT_COLS + 1999).all()), last
    u = torch.ones(1, rows, 2)
    u[..., 1] = 0.0
    first = P.pair_column_draw(*args, u)
    assert bool((first == 2 * P.SPLIT_COLS + 40).all()), first


@pytest.mark.parametrize("nb", [300, 5000])
def test_a_member_alone_is_the_member_in_a_batch(nb):
    gen = torch.Generator().manual_seed(6)
    a2, iva, ivmuA, muB = _terms("line2", 2, 700, nb, gen, members=3)
    u = _uniforms(700, gen, members=3)
    batch = P.pair_column_draw(a2, iva, ivmuA, muB, u)
    for b in range(3):
        alone = P.pair_column_draw(a2[b], iva[b], ivmuA[b], muB[b], u[b])
        assert torch.equal(alone, batch[b]), b
    # and a row's column does not depend on the block of rows it was in
    small = P.pair_column_draw_plain(a2, iva, ivmuA, muB, u,
                                     max_elems=64 * 3 * P.SPLIT_COLS)
    assert torch.equal(small, batch)


def test_one_key_gives_one_draw():
    gen = torch.Generator().manual_seed(8)
    muA = torch.randn(2, 300, 3, generator=gen)
    muB = torch.randn(2, 5000, 3, generator=gen) + 0.3
    prec = torch.full((2, 1, 3), 9.0)
    args = (muA, prec.expand(2, 300, 3), muB, prec.expand(2, 5000, 3))
    ks = [_keys.make_key(31, m) for m in range(2)]
    one = product.pair_product_tangent_large(*args, ks, 1000)
    two = product.pair_product_tangent_large(*args, ks, 1000)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    other = product.pair_product_tangent_large(
        *args, [_keys.make_key(32, m) for m in range(2)], 1000)
    assert not torch.equal(one[0], other[0])


@pytest.mark.parametrize("nb", [300, 4096, 6000])
@pytest.mark.parametrize("spread,dof", [("line2", 1), ("se2", 3),
                                        ("bimodal", 1), ("se2", 8)])
def test_the_plain_draw_is_the_float64_inverse_cdf(spread, dof, nb):
    """Columns equal to a float64 inverse CDF of the exact log-weights on
    the same uniforms, except where a uniform lies within TOL of a boundary
    of the column the plain version drew."""
    gen = torch.Generator().manual_seed(nb + dof)
    rows = 2000
    a2, iva, ivmuA, muB = (t[0] for t in _terms(spread, dof, rows, nb, gen))
    u = _uniforms(rows, gen)[0]
    cols = P.pair_column_draw(a2, iva, ivmuA, muB, u)
    l2 = _l2_exact(a2, iva, ivmuA, muB)
    want = _draw64(l2, u)
    parted = cols != want
    gaps = _gaps(l2, u, cols)
    print(f"{spread} dof {dof} Nb {nb}: {int(parted.sum())} of {rows} rows "
          f"parted, largest gap {float(gaps.max()):.2e}")
    assert float(gaps.max()) <= TOL
    assert float(parted.double().mean()) <= 1e-3


def test_the_wrapper_checks_its_inputs_and_counts_calls():
    gen = torch.Generator().manual_seed(2)
    a2, iva, ivmuA, muB = (t[0] for t in _terms("se2", 3, 10, 40, gen))
    u = _uniforms(10, gen)[0]
    with pytest.raises(TypeError):
        P.pair_column_draw(a2.double(), iva, ivmuA, muB, u)
    with pytest.raises(ValueError):
        P.pair_column_draw(a2, iva, ivmuA, muB, u[:, :1])
    with pytest.raises(ValueError):
        P.pair_column_draw(a2, iva[:, :2], ivmuA, muB, u)
    P.reset_counts()
    cols = P.pair_column_draw(a2, iva, ivmuA, muB, u)
    assert cols.dtype == torch.int64 and cols.shape == (10,)
    assert P.counts == {"launches": 0, "problems": 0, "calls": 1}


def test_the_source_draws_no_random_number_and_adds_no_atomics():
    """The kernel's randomness is the caller's uniforms; its sums are in a
    fixed order.  Its split width and chunk count are the plain version's."""
    src = open(P.LIBRARY.src).read()
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.search(r"atomic|curand|philox|clock", code, re.I)
    assert int(re.search(r"kSplitCols = (\d+);", code).group(1)) \
        == P.SPLIT_COLS
    assert re.search(r"kChunks = kSplitCols / 32;", code)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    P.build()
    return torch.device("cuda", 0)


def _on(card, *ts):
    return tuple(t.to(card) for t in ts)


@pytest.mark.card
@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("nb", [300, 4096, 50_000])
@pytest.mark.parametrize("spread,dof", [
    ("line2", 1), ("se2", 3), ("line2", 8), ("se2", 8), ("far", 1)])
def test_kernel_draws_the_plain_versions_columns(card, spread, dof, nb,
                                                 members):
    gen = torch.Generator().manual_seed(nb * 10 + dof)
    rows = 20_000
    args = _on(card, *_terms(spread, dof, rows, nb, gen, members),
               _uniforms(rows, gen, members))
    P.reset_counts()
    got = P.pair_column_draw(*args)
    assert P.counts == {"launches": 1, "problems": members, "calls": 1}
    want = P.pair_column_draw_plain(*args, max_elems=1 << 26)
    parted = (got != want).nonzero().tolist()
    share = len(parted) / (members * rows)
    worst = 0.0
    for b, r in parted:
        a2, iva, ivmuA, muB, u = (t[b] for t in args)
        l2 = _l2_kernel(a2[r:r + 1], iva[r:r + 1], ivmuA[r:r + 1], muB)
        for cols in (got[b, r:r + 1], want[b, r:r + 1]):
            worst = max(worst, float(_gaps(l2.double().cpu(),
                                           u[r:r + 1].cpu(), cols.cpu())[0]))
    print(f"{spread} dof {dof} Nb {nb} x{members}: {len(parted)} of "
          f"{members * rows} rows parted, largest gap {worst:.2e}")
    assert share <= 1e-4, (len(parted), parted[:10])
    assert worst <= TOL


@pytest.mark.card
@pytest.mark.parametrize("nb", [4096, 50_000])
def test_two_launches_and_a_member_alone_give_the_same_bits(card, nb):
    gen = torch.Generator().manual_seed(nb)
    args = _on(card, *_terms("se2", 3, 50_000, nb, gen, members=3),
               _uniforms(50_000, gen, members=3))
    first = P.pair_column_draw(*args)
    assert torch.equal(first, P.pair_column_draw(*args))
    for b in range(3):
        alone = P.pair_column_draw(*(t[b].contiguous() for t in args))
        assert torch.equal(alone, first[b]), b


@pytest.mark.card
@pytest.mark.parametrize("members", [1, 2])
def test_a_large_call_counts_its_kernel_pairs(card, members):
    gen = torch.Generator().manual_seed(members)
    muA = torch.randn(members, 5000, 3, generator=gen).to(card)
    muB = torch.randn(members, 7000, 3, generator=gen).to(card)
    prec = torch.full((members, 1, 3), 9.0, device=card)
    args = (muA, prec.expand(members, 5000, 3), muB,
            prec.expand(members, 7000, 3))
    ks = [_keys.make_key(5, m) for m in range(members)]
    with tracing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        product.pair_product_tangent_large(*args, ks, 4000)
        torch.cuda.synchronize()
    snap = tracing.snapshot()
    [draw] = [s for s in snap["spans"] if s["name"] == "product.draw"]
    want = members * 4000 * 7000
    assert snap["counters"]["draw_pairs"] == want
    assert snap["counters"]["draw_kernel_pairs"] == want
    assert draw["counts"] == {"draw_pairs": want, "draw_kernel_pairs": want}

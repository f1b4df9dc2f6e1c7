"""The KDE read's kernel (``ops/kernels/kde_lse.py``, ``csrc/kde_lse.cu``)
and the route ``beliefs.kde_logpdf`` takes to it.

On the CPU: which manifolds and tensors reach the kernel (Euclidean(1..8),
SE2 and SE3, float32 CUDA tensors, no gradient asked; never SO(3), the
circle, the sphere, a product or a CPU tensor), what each route counts
(``kde_pairs``, ``kde_eager_pairs``), the wrapper's checks, and the kernel's
SE(2) arithmetic: its two polynomials, read from the source, against the
functions they stand for, and a float32 model of its pair expressions
against the port's ``SE2.log`` in float64.

The tests marked ``card`` need an NVIDIA card and skip here; on the card:
``python -m pytest --noconftest tests/test_torch_kde_kernel.py -m card``.
There the kernel is held against the plain chunked route computed in
float64, bit for bit against itself (a row read alone, two reads), and on
the ``se2pair-n50k`` cell's own particles for the estimate's chosen
particle.  This file imports no JAX.
"""

from __future__ import annotations

import math
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import incrementalinference_torch as it
from incrementalinference_torch import beliefs, manifolds, tracing
from incrementalinference_torch.manifolds import lie
from incrementalinference_torch.ops.kernels import kde_lse

SOURCE = kde_lse.LIBRARY.src
LOG2E = 1.0 / math.log(2.0)


def _coefficients(name: str) -> list[float]:
    text = open(SOURCE).read()
    body = re.search(name + r"\[7\] = \{([^}]*)\}", text).group(1)
    return [float(x.strip().rstrip("f")) for x in body.split(",")]


def _fma(a, b, c):
    """float32 fused multiply-add, by float64 (exact products of float32
    numbers) rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _horner(c, u):
    acc = torch.full_like(u, c[-1])
    for ck in reversed(c[:-1]):
        acc = _fma(acc, u, torch.full_like(u, ck))
    return acc


def _wrap(t):
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / two_pi
    return t - two_pi * torch.round(t * inv)


def se2_pair_model(q, p, bw):
    """The kernel's SE(2) pair, expression by expression in float32: the
    log2-weight -log2(e)/2 * sum_d (log_p(q)_d / bw_d)^2 of each (q, p)."""
    sinc, vers = _coefficients("kSinc"), _coefficients("kVers")
    w = torch.tensor(math.sqrt(LOG2E / 2), dtype=torch.float32) / bw
    theta_p = p[..., 2]
    c, s = torch.cos(_wrap(-theta_p)), torch.sin(_wrap(-theta_p))
    dx, dy = q[..., 0] - p[..., 0], q[..., 1] - p[..., 1]
    tx = _fma(c, dx, -(s * dy))
    ty = _fma(s, dx, c * dy)
    phi = _wrap(q[..., 2] - theta_p)
    u = phi * phi
    A = _horner(sinc, u)
    B = phi * _horner(vers, u)
    small = ~(phi.abs() > 1e-8)
    A = torch.where(small, 1.0 - u * torch.tensor(1 / 6, dtype=torch.float32),
                    A)
    B = torch.where(small, 0.5 * phi, B)
    inv = 1.0 / torch.clamp(_fma(B, B, A * A), min=1e-8)
    rx = _fma(A, tx, B * ty)
    ry = _fma(A, ty, -(B * tx))
    z = [(rx * inv) * w[0], (ry * inv) * w[1], phi * w[2]]
    acc = torch.zeros_like(phi)
    for zd in z:
        acc = _fma(-zd, zd, acc)
    return acc


def _se2_points(n, gen, angle=None, spread=(0.5, 0.5, 0.6)):
    X = torch.randn(n, 3, generator=gen, dtype=torch.float64) \
        * torch.tensor(spread, dtype=torch.float64)
    pts = it.SE2().exp(torch.tensor([10.0, 0.0, math.pi / 2],
                                    dtype=torch.float64)[None], X)
    if angle is not None:
        pts[:, 2] = angle(n, gen)
    return pts


def _reference_log2_weight(q, p, bw):
    X = it.SE2().log(p.double(), q.double())
    z = X / bw.double()
    return -0.5 * LOG2E * torch.sum(z * z, dim=-1)


# -- which calls reach the kernel ------------------------------------------

@pytest.mark.parametrize("make,code", [
    (lambda: it.Euclidean(1), (0, 1)), (lambda: it.Euclidean(3), (0, 3)),
    (lambda: it.Euclidean(8), (0, 8)), (lambda: it.SE2(), (1, 3)),
    (lambda: it.Euclidean(9), None), (lambda: it.SE3(), (2, 6)),
    (lambda: it.SO3(), None), (lambda: it.SO2(), None),
    (lambda: it.Circular.manifold, None), (lambda: manifolds.Sphere2(), None),
    (lambda: manifolds.Product(it.Euclidean(2), it.SO2()), None)],
    ids=["E1", "E3", "E8", "SE2", "E9", "SE3", "SO3", "SO2", "Circle",
         "Sphere2", "Product"])
def test_the_kernel_computes_euclidean_and_se2_only(make, code):
    M = make()
    assert kde_lse.manifold_code(M) == code
    pts = M.exp(M.identity()[None].expand(4, -1),
                0.1 * torch.ones(4, M.dof))
    bw = torch.full((M.dof,), 0.2)
    # a CPU tensor never takes the kernel, whatever the manifold
    assert not kde_lse.takes(M, pts, pts, bw)


class _SE2Like(lie.SE2):
    """A subclass may redefine ``log``: it keeps the eager route."""


def test_a_subclass_keeps_the_eager_route():
    assert kde_lse.manifold_code(_SE2Like()) is None


@pytest.mark.parametrize("make", [
    lambda: it.Euclidean(2), lambda: it.SE2(), lambda: it.SE3(),
    lambda: it.Circular.manifold], ids=["E2", "SE2", "SE3", "Circle"])
def test_cpu_reads_never_reach_the_wrapper(make, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU read reached the kernel's wrapper")

    monkeypatch.setattr(kde_lse, "kde_row_logsumexp", refuse)
    M = make()
    gen = torch.Generator().manual_seed(3)
    pts = M.exp(M.identity()[None].expand(64, -1),
                0.5 * torch.randn(64, M.dof, generator=gen))
    b = it.make_belief(M, pts)
    lp = it.kde_logpdf(M, b, pts[:5])
    assert lp.shape == (5,) and bool(torch.isfinite(lp).all())
    est = it.ppe(M, b)
    assert bool(torch.isfinite(est["max"]).all())


def test_the_eager_route_counts_its_pairs():
    M = it.SE2()
    gen = torch.Generator().manual_seed(4)
    pts = M.exp(M.identity()[None].expand(2, 40, -1),
                0.3 * torch.randn(2, 40, 3, generator=gen))
    bw = torch.full((2, 3), 0.2)
    with tracing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        beliefs.kde_logpdf(M, beliefs.Belief(pts, bw, bw), pts[:, :7])
    snap = tracing.snapshot()
    assert snap["counters"] == {"kde_eager_pairs": 2 * 7 * 40}
    span, = [s for s in snap["spans"] if s["name"] == "kde_logpdf"]
    assert span["attrs"] == {"N": 40, "Q": 7, "manifold": "SE2"}
    assert span["counts"] == {"kde_eager_pairs": 2 * 7 * 40}


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    pts = torch.zeros(8, 3)
    bw = torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        kde_lse.kde_row_logsumexp(it.SE2(), pts, pts, bw)
    with pytest.raises(ValueError, match="no kernel"):
        kde_lse.kde_row_logsumexp(it.SO3(), torch.zeros(8, 4),
                                  torch.zeros(8, 4), torch.ones(3))


@pytest.mark.parametrize("shape,tail,lead,members,copied", [
    ((5, 3), 2, (), 1, False), ((1, 1, 5, 3), 2, (2, 4), 1, False),
    ((2, 4, 5, 3), 2, (2, 4), 8, False), ((4, 5, 3), 2, (2, 4), 8, True),
    ((2, 1, 3), 1, (2, 4), 8, True), ((3,), 1, (2, 4), 1, False)])
def test_members_share_or_flatten(shape, tail, lead, members, copied):
    t = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    flat, m = kde_lse._members(t, lead, tail, "t")
    assert m == members
    assert flat.shape == (members,) + shape[len(shape) - tail:]
    assert flat.is_contiguous()
    assert (flat.data_ptr() != t.data_ptr()) == copied
    want = t.expand(tuple(lead) + shape[len(shape) - tail:]).reshape(
        (-1,) + shape[len(shape) - tail:])
    assert torch.equal(flat, want[:members])


def test_members_refuse_a_strided_input():
    t = torch.zeros(3, 8).t()
    with pytest.raises(ValueError, match="contiguous"):
        kde_lse._members(t, (), 2, "query")


# -- the kernel's SE(2) arithmetic, modelled on the CPU ----------------------

def test_the_polynomials_stand_for_sinc_and_versine():
    """The source's float32 coefficients: within 1e-7 and 2e-8 of
    sin(phi)/phi and (1 - cos(phi))/phi^2 on |phi| <= 1.001 pi, and within
    2e-7 and 6e-8 in float32 Horner form (about an ulp of 1); below 1e-8
    they give the Taylor forms' values."""
    sinc, vers = _coefficients("kSinc"), _coefficients("kVers")
    u = torch.linspace(0.0, (1.001 * math.pi) ** 2, 200_001,
                       dtype=torch.float64)
    phi = torch.sqrt(u)
    safe = torch.where(u > 0, phi, torch.ones_like(phi))
    A = torch.where(u > 0, torch.sin(safe) / safe, torch.ones_like(u))
    C = torch.where(u > 1e-6, (1 - torch.cos(safe)) / torch.where(
        u > 1e-6, u, torch.ones_like(u)), 0.5 - u / 24 + u * u / 720)

    def poly64(c):
        return sum(ck * u ** k for k, ck in enumerate(c))

    assert float((poly64(sinc) - A).abs().max()) < 1e-7
    assert float((poly64(vers) - C).abs().max()) < 2e-8
    u32 = u.float()
    phi32 = torch.sqrt(u32.double())
    safe32 = torch.where(u32 > 0, phi32, torch.ones_like(phi32))
    A32 = torch.where(u32 > 0, torch.sin(safe32) / safe32,
                      torch.ones_like(phi32))
    C32 = torch.where(u32.double() > 1e-6, (1 - torch.cos(safe32)) / torch.where(
        u32.double() > 1e-6, u32.double(), torch.ones_like(phi32)),
        0.5 - u32.double() / 24)
    assert float((_horner(sinc, u32).double() - A32).abs().max()) < 2e-7
    assert float((_horner(vers, u32).double() - C32).abs().max()) < 6e-8
    tiny = torch.tensor([0.0, 1e-12, 3e-9, 1e-8], dtype=torch.float32)
    assert torch.equal(_horner(sinc, tiny * tiny), 1.0 - tiny * tiny / 6.0)
    assert torch.equal(tiny * _horner(vers, tiny * tiny), 0.5 * tiny)


@pytest.mark.parametrize("case", ["cell", "near_pi", "nearly_equal",
                                  "wide"])
def test_the_se2_pair_model_matches_the_log_map(case):
    """The kernel's pair expressions (in float32) against the port's
    ``SE2.log`` in float64: the log2-weight within 2e-6 x max(1, |l2|)
    wherever a kernel weighs (l2 > -200), plus, for a pair across the
    +-pi cut, what float32 angles allow there: theta_q - theta_p near 2 pi
    rounds at 2.4e-7 and 2 pi itself is 1.7e-7 off in float32, so phi
    carries up to 5e-7 and l2 log2(e) |z_theta| 5e-7 / bw_theta (the eager
    float32 route wraps by the same expressions).  Angles near +-pi put
    most pairs across the cut; nearly equal angles put phi at 1e-9..1e-3,
    the Taylor branch and the small-angle digits of A and B."""
    gen = torch.Generator().manual_seed(11)
    n = 400
    bw = torch.tensor([0.1, 0.1, 0.02])
    if case == "cell":
        pts = _se2_points(n, gen, spread=(0.5, 0.5, 0.05))
    elif case == "near_pi":
        pts = _se2_points(n, gen, angle=lambda m, g: lie.wrap_angle(
            math.pi + 0.2 * torch.randn(m, generator=g, dtype=torch.float64)))
    elif case == "nearly_equal":
        base = 0.7
        pts = _se2_points(n, gen, angle=lambda m, g: base + 10.0 ** (
            -9 + 6 * torch.rand(m, generator=g, dtype=torch.float64)))
        bw = torch.tensor([0.1, 0.1, 1e-3])
    else:
        pts = _se2_points(n, gen, spread=(3.0, 3.0, 2.0))
        pts[:, 2] = lie.wrap_angle(pts[:, 2])
        bw = torch.tensor([1.0, 1.0, 0.8])
    pts32 = pts.float()
    q, p = pts32[:, None, :], pts32[None, :, :]
    got = se2_pair_model(q, p, bw).double()
    ref = _reference_log2_weight(q.double(), p.double(), bw)
    live = ref > -200
    assert int(live.sum()) > n
    phi = lie.wrap_angle(q[..., 2].double() - p[..., 2].double())
    cut = (LOG2E * (phi / bw[2].double()).abs() * 5e-7 / float(bw[2])
           * ((q[..., 2] - p[..., 2]).abs() > math.pi).double())
    err = ((got - ref).abs() - cut) / ref.abs().clamp(min=1.0)
    assert float(err[live].max()) < 2e-6, float(err[live].max())


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    kde_lse.build()
    return torch.device("cuda", 0)


#: kernel against the plain chunked route in float64, in log-density:
#: float32 rounds a dominant kernel's exponent (|log k| up to ~30) at
#: ~2e-6 and the result (|log p| up to ~20) at ~1e-6, ex2.approx adds
#: 2^-22 a term, and a pair across SE(2)'s +-pi cut carries the float32
#: wrap's 5e-7 in phi, which the plain route in float32 carries too; the
#: worst reading on an H100 was 6.7e-6 (the plain route's own 9.9e-6),
#: so 2e-5 leaves three times that
BAR = 2e-5

MANIFOLDS = {"E1": lambda: it.Euclidean(1), "E2": lambda: it.Euclidean(2),
             "E3": lambda: it.Euclidean(3), "SE2": lambda: it.SE2()}


def _cloud(name, n, gen, lead=()):
    """Particles (lead..., n, point_dim) in float64 on the CPU: two modes
    on the Euclidean spaces, the cell's x1 spread on SE(2)."""
    M = MANIFOLDS[name]()
    if name == "SE2":
        pts = _se2_points(math.prod(lead) * n, gen, spread=(0.5, 0.5, 0.05))
        return pts.reshape(tuple(lead) + (n, 3))
    x = torch.randn(tuple(lead) + (n, M.dof), generator=gen,
                    dtype=torch.float64)
    x[..., : n // 3, :] += 6.0
    return x


def _plain64(M, pts, bw, query):
    """The plain chunked route in float64 (a float64 read is eager)."""
    return beliefs.kde_logpdf(M, beliefs.Belief(pts.double(), bw.double(),
                                                bw.double()), query.double())


def _plain32(M, pts, bw, query):
    """The plain chunked route in float32 (on the card, ``kde_logpdf``
    would take the kernel)."""
    lse = beliefs._kde_lse_chunked(M, pts, bw, query, ())
    lognorm = torch.sum(torch.log(bw)) + 0.5 * bw.shape[-1] * math.log(
        2.0 * math.pi)
    return lse - math.log(float(pts.shape[-2])) - lognorm


@pytest.mark.card
@pytest.mark.parametrize("n", [300, 4096, 50_000])
@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_kernel_matches_the_plain_route(card, name, n):
    M = MANIFOLDS[name]()
    gen = torch.Generator().manual_seed(n + len(name))
    pts = _cloud(name, n, gen).float().to(card)
    bw = beliefs.loo_bandwidth(M, pts)
    queries = {"one": pts[7:8], "other": _cloud(name, 997, gen).float().to(
        card)}
    if n <= 4096 or name in ("E1", "SE2"):
        queries["self"] = pts
    b = beliefs.Belief(pts, bw, bw)
    for label, q in queries.items():
        kde_lse.reset_counts()
        got = beliefs.kde_logpdf(M, b, q)
        assert kde_lse.counts["launches"] == 1, label
        want = _plain64(M, pts, bw, q)
        err = float((got.double() - want).abs().max())
        f32 = float((_plain32(M, pts, bw, q).double() - want).abs().max())
        print(f"{name} N={n} Q={q.shape[0]} ({label}): kernel "
              f"{err:.2e} from float64, the plain route in float32 {f32:.2e}")
        assert bool(torch.isfinite(got).all())
        assert err <= BAR, (label, err, f32)


@pytest.mark.card
@pytest.mark.parametrize("name", ["E2", "SE2"])
def test_a_batched_lead_reads_each_member(card, name):
    """points (2, 3, N, pd), query (2, 3, Q, pd) and bw (3, dof), shared
    by the first axis: one launch, each member as its own read."""
    M = MANIFOLDS[name]()
    gen = torch.Generator().manual_seed(21)
    pts = _cloud(name, 2048, gen, lead=(2, 3)).float().to(card)
    q = _cloud(name, 130, gen, lead=(2, 3)).float().to(card)
    bw = torch.stack([beliefs.loo_bandwidth(M, pts[0, j]) for j in range(3)])
    kde_lse.reset_counts()
    got = beliefs.kde_logpdf(M, beliefs.Belief(pts, bw, bw), q)
    assert got.shape == (2, 3, 130)
    assert kde_lse.counts == {"launches": 1, "problems": 6, "calls": 1}
    for i in range(2):
        for j in range(3):
            want = _plain64(M, pts[i, j], bw[j], q[i, j])
            assert float((got[i, j].double() - want).abs().max()) <= BAR


@pytest.mark.card
@pytest.mark.parametrize("case", ["near_pi", "nearly_equal"])
def test_se2_angles_at_the_cut_and_nearly_equal(card, case):
    gen = torch.Generator().manual_seed(5)
    n = 4096
    if case == "near_pi":
        pts = _se2_points(n, gen, angle=lambda m, g: lie.wrap_angle(
            math.pi + 0.05 * torch.randn(m, generator=g,
                                         dtype=torch.float64)))
    else:
        pts = _se2_points(n, gen, angle=lambda m, g: 0.3 + 10.0 ** (
            -9 + 5 * torch.rand(m, generator=g, dtype=torch.float64)))
    M = it.SE2()
    pts = pts.float().to(card)
    bw = beliefs.loo_bandwidth(M, pts)
    got = beliefs.kde_logpdf(M, beliefs.Belief(pts, bw, bw), pts)
    want = _plain64(M, pts, bw, pts)
    assert float((got.double() - want).abs().max()) <= BAR


@pytest.mark.card
@pytest.mark.parametrize("n", [4096, 50_000])
@pytest.mark.parametrize("name", ["E1", "SE2"])
def test_a_row_alone_is_the_row_of_the_full_read(card, name, n):
    """The split depends on N only and each row's arithmetic on nothing
    else: the same bits alone, in a slice, in the full read, and twice."""
    M = MANIFOLDS[name]()
    gen = torch.Generator().manual_seed(9)
    pts = _cloud(name, n, gen).float().to(card)
    bw = beliefs.loo_bandwidth(M, pts)
    b = beliefs.Belief(pts, bw, bw)
    full = beliefs.kde_logpdf(M, b, pts)
    assert torch.equal(full, beliefs.kde_logpdf(M, b, pts))
    for i in (0, 1, 7, 63, 64, 1000, n - 1):
        alone = beliefs.kde_logpdf(M, b, pts[i:i + 1])
        assert torch.equal(alone[0], full[i]), i
        lo = max(0, i - 3)
        part = beliefs.kde_logpdf(M, b, pts[lo:i + 5])
        assert torch.equal(part[i - lo], full[i]), i


@pytest.mark.card
def test_the_cells_estimates_choose_the_plain_particle(card):
    """``ppe``'s max on the ``se2pair-n50k`` cell's x0 and x1 after one
    solve: the plain route's particle, or one within 1e-5 of it in float64
    log-density (float32 ties)."""
    import json
    import os

    from bench_port.graphs import se2pair

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "bench_port", "configs",
                           "se2pair-n50k.json")) as f:
        cfg = json.load(f)
    fg, _ = se2pair.build(cfg, 3_000_000_011, 1, card, True)
    it.solve_tree(fg)
    M = it.SE2()
    for lbl in ("x0", "x1"):
        b = fg.get_belief(lbl)
        got = it.ppe(M, b)["max"]
        lp = beliefs._kde_lse_chunked(M, b.points, b.bw, b.points, ())
        want = b.points[lp == lp.max()].mean(0)
        if not torch.equal(got, want):
            two = torch.stack([got, want])
            lp64 = _plain64(M, b.points, b.bw, two)
            assert float((lp64[0] - lp64[1]).abs()) <= 1e-5, lbl


@pytest.mark.card
def test_counts_and_counters_say_what_ran(card):
    gen = torch.Generator().manual_seed(2)
    se2 = it.SE2()
    pts = _cloud("SE2", 3000, gen, lead=(2,)).float().to(card)
    bw = torch.full((2, 3), 0.1, device=card)
    se3 = it.SE3()
    p3 = se3.exp(se3.identity(card)[None].expand(500, -1),
                 0.2 * torch.randn(500, 6, device=card))
    bw3 = torch.full((6,), 0.1, device=card)
    so3 = it.SO3()
    q3 = so3.exp(so3.identity(card)[None].expand(300, -1),
                 0.2 * torch.randn(300, 3, device=card))
    bwq = torch.full((3,), 0.1, device=card)
    kde_lse.reset_counts()
    with tracing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CUDA]):
        beliefs.kde_logpdf(se2, beliefs.Belief(pts, bw, bw), pts[:, :100])
        beliefs.kde_logpdf(se3, beliefs.Belief(p3, bw3, bw3), p3[:40])
        beliefs.kde_logpdf(so3, beliefs.Belief(q3, bwq, bwq), q3[:20])
        beliefs.kde_logpdf(se2, beliefs.Belief(pts.double(), bw.double(),
                                               bw.double()), pts[:, :5].double())
    snap = tracing.snapshot()
    assert snap["counters"] == {"kde_pairs": 2 * 100 * 3000 + 40 * 500,
                                "kde_eager_pairs": 20 * 300 + 2 * 5 * 3000}
    assert kde_lse.counts == {"launches": 2, "problems": 3, "calls": 2}
    # a strided query is made contiguous by kde_logpdf, refused by the
    # wrapper itself
    q = pts[0].t().contiguous().t()
    beliefs.kde_logpdf(se2, beliefs.Belief(pts[0], bw[0], bw[0]), q)
    with pytest.raises(ValueError, match="contiguous"):
        kde_lse.kde_row_logsumexp(se2, pts[0], q, bw[0])

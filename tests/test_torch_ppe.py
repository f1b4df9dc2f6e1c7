"""The port's posterior estimates against the JAX package, on the CPU.

The KDE read-out (``kde_logpdf``, and through it ``ppe`` and
``ppe_batched``) takes its query rows in chunks of
``beliefs._KDE_CHUNK_PAIRS`` (query, kernel) pairs.  Here the constant is
patched down so that N=300 particles go through in 7-row chunks, on
R¹, R², SE(2), SE(3) and the Circular variable's manifold: the chunked
results against the JAX functions on the same points and bandwidths (mean
1e-5, max 1e-4, log-density 1e-5, the bars of
``test_ppe_batched_matches_ppe_and_jax``), against the port's own
one-chunk form (bit for bit), a spy on ``manifold.log`` holding every
call to one chunk, and the bytes a read holds at once, counted op by op.  Then ``LazyPPE``'s comparison, pickle and deepcopy and
``solve_graph_parametric``'s ``init_from_belief`` against the JAX
package's, and the cases of tests/test_distributions.py (the KDE and PPE
ones) and tests/test_manual_init.py on the port, at their own bars, from
numpy inputs.
"""

import copy
import math
import pickle
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from torch_port_helpers import jax_graph_to_arrays, rng, t

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import beliefs as jb
from incrementalinference.jl_tpu import manifolds as jm
from incrementalinference_torch import beliefs as tb
from incrementalinference_torch import manifolds as tm

CPU = "cpu"
N = 300
ROWS = 7

MANIFOLDS = {
    "Euclidean1": (lambda: jm.Euclidean(1), lambda: tm.Euclidean(1)),
    "Euclidean2": (lambda: jm.Euclidean(2), lambda: tm.Euclidean(2)),
    "SE2": (jm.SE2, tm.SE2),
    "SE3": (jm.SE3, tm.SE3),
    "Circular": (lambda: jl.Circular.manifold, lambda: it.Circular.manifold),
}


def particles(name: str, seed: int, n: int = N, batch=()) -> np.ndarray:
    """Particle sets (*batch, n, point_dim) from a numpy seed: two modes on
    the coordinate manifolds, exp of numpy tangents on the groups."""
    r = rng(seed)
    shape = tuple(batch) + (n,)
    if name in ("SE2", "SE3"):
        M = MANIFOLDS[name][1]()
        X = r.normal(scale=0.6, size=shape + (M.dof,)).astype(np.float32)
        X[..., : n // 3, : M.dof // 2] += 4.0
        return M.exp(M.identity()[None], t(X)).numpy()
    if name == "Circular":
        return r.uniform(-math.pi, math.pi, size=shape + (1,)).astype(
            np.float32)
    d = 1 if name == "Euclidean1" else 2
    x = r.normal(size=shape + (d,))
    x[..., : n // 3, :] += 6.0
    return x.astype(np.float32)


def bandwidth(name: str, pts: np.ndarray) -> np.ndarray:
    """The port's LOO bandwidth, handed to both packages."""
    return tb.loo_bandwidth(MANIFOLDS[name][1](), t(pts)).numpy()


@pytest.fixture
def chunked(monkeypatch):
    """Patch the chunk to ROWS rows of N kernels for one belief; returns a
    setter for other batch sizes."""
    def rows(per_row_pairs=N):
        monkeypatch.setattr(tb, "_KDE_CHUNK_PAIRS", ROWS * per_row_pairs)
    rows()
    return rows


def whole(fn, *args):
    """``fn`` with the chunk wide enough for one pass over every row, the
    reference for the chunked read-out."""
    saved = tb._KDE_CHUNK_PAIRS
    tb._KDE_CHUNK_PAIRS = 1 << 62
    try:
        return fn(*args)
    finally:
        tb._KDE_CHUNK_PAIRS = saved


# -- chunked read-outs against the JAX package and the one-pass form ---------

@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_chunked_ppe_and_kde_logpdf_match_jax(name, chunked):
    mj, mt = MANIFOLDS[name][0](), MANIFOLDS[name][1]()
    pts = particles(name, seed=1)
    q = particles(name, seed=2, n=41)
    bw = bandwidth(name, pts)
    mu, pmax = tb._ppe_core(mt, t(pts), t(bw))
    mu_j, pmax_j = jb._ppe_core(mj, pts, bw)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(pmax.numpy(), np.asarray(pmax_j), atol=1e-4)
    for query in (pts, q):
        lp = tb.kde_logpdf(mt, tb.Belief(t(pts), t(bw), t(bw)), t(query))
        lp_j = jb.kde_logpdf(mj, jb.Belief(pts, bw, bw), query)
        assert lp.shape == (query.shape[0],)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), atol=1e-5)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_chunked_ppe_batched_matches_jax(name, chunked):
    mj, mt = MANIFOLDS[name][0](), MANIFOLDS[name][1]()
    pts = particles(name, seed=3, batch=(3,))
    chunked(3 * N)
    bts = [tb.make_belief(mt, t(p)) for p in pts]
    bjs = [jb.make_belief(mj, p, bw=b.bw.numpy()) for p, b in zip(pts, bts)]
    for got, want in zip(tb.ppe_batched(mt, bts), jb.ppe_batched(mj, bjs)):
        np.testing.assert_allclose(got["mean"].numpy(),
                                   np.asarray(want["mean"]), atol=1e-5)
        for k in ("max", "suggested"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-4)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_chunked_read_out_equals_one_pass(name, chunked):
    """Each row goes through the same expressions in a chunk as in one
    pass, and on the CPU a row's logsumexp does not depend on how many rows
    share its tensor: the chunked results are bit-equal to the one-pass
    ones, single and batched, and choose the same particles."""
    mt = MANIFOLDS[name][1]()
    pts = t(particles(name, seed=4))
    bw = tb.loo_bandwidth(mt, pts)
    b = tb.Belief(pts, bw, bw)
    lp, lp1 = tb.kde_logpdf(mt, b, pts), whole(tb.kde_logpdf, mt, b, pts)
    assert torch.equal(lp, lp1)
    assert torch.equal(lp == lp.max(), lp1 == lp1.max())
    for got, want in zip(tb._ppe_core(mt, pts, bw),
                         whole(tb._ppe_core, mt, pts, bw)):
        assert torch.equal(got, want)
    stacked = t(particles(name, seed=5, batch=(2,)))
    bws = tb.loo_bandwidth(mt, stacked)
    chunked(2 * N)
    for got, want in zip(tb._ppe_core(mt, stacked, bws),
                         whole(tb._ppe_core, mt, stacked, bws)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_no_log_call_gets_more_than_one_chunk(name, chunked, monkeypatch):
    mt = MANIFOLDS[name][1]()
    pts = t(particles(name, seed=6))
    bel = tb.make_belief(mt, pts)
    shapes = []
    log = mt.log

    def spy(p, q):
        shapes.append(torch.broadcast_shapes(p.shape, q.shape)[:-1])
        return log(p, q)

    monkeypatch.setattr(mt, "log", spy)
    reads = (                       # (read, query rows, batch dims)
        (lambda: tb.ppe(mt, bel), N, ()),
        (lambda: tb.kde_logpdf(mt, bel, pts[:50]), 50, ()),
        (lambda: tb.ppe_batched(mt, [bel, bel]), N, (2,)),
    )
    for read, rows, batch in reads:
        chunked(math.prod(batch) * N)
        shapes.clear()
        read()
        pairs = [math.prod(s) for s in shapes]
        assert max(pairs) <= tb._KDE_CHUNK_PAIRS, (shapes, batch)
        # the KDE's calls are (*batch, rows, N); the Karcher mean's (*batch, N)
        kde = [s for s in shapes if len(s) == len(batch) + 2]
        assert all(s[:-2] == batch and s[-1] == N and s[-2] <= ROWS
                   for s in kde), shapes
        assert sum(s[-2] for s in kde) == rows, shapes
        assert len(kde) == -(-rows // ROWS)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_a_batch_past_one_chunk_goes_in_groups(name, monkeypatch):
    """Five beliefs where one row of all five is more than a chunk (2 x N
    pairs): the beliefs go through two at a time, no ``manifold.log`` call
    gets more than a chunk, and the read equals the one-pass form bit for
    bit, for ``_ppe_core`` and for ``kde_logpdf`` at a shared (unbatched)
    query."""
    mt = MANIFOLDS[name][1]()
    n, nb = 60, 5
    pts = t(particles(name, seed=8, n=n, batch=(nb,)))
    bws = tb.loo_bandwidth(mt, pts)
    q = t(particles(name, seed=9, n=13))
    b = tb.Belief(pts, bws, bws)
    monkeypatch.setattr(tb, "_KDE_CHUNK_PAIRS", 2 * n)
    shapes = []
    log = mt.log

    def spy(p, x):
        shapes.append(torch.broadcast_shapes(p.shape, x.shape)[:-1])
        return log(p, x)

    monkeypatch.setattr(mt, "log", spy)
    got = tb._ppe_core(mt, pts, bws) + (tb.kde_logpdf(mt, b, q),)
    # the KDE's calls are (group, rows, n); the Karcher mean's (nb, n)
    kde = [s for s in shapes if len(s) == 3]
    assert max(math.prod(s) for s in kde) <= 2 * n, set(kde)
    assert max(s[0] for s in kde) == 2, set(kde)
    assert tb.kde_logpdf(mt, b, q).shape == (nb, 13)
    want = (whole(tb._ppe_core, mt, pts, bws)
            + (whole(tb.kde_logpdf, mt, b, q),))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _LiveBytes(TorchDispatchMode):
    """The most bytes of tensor storage made inside the mode and alive at
    once (inputs made before it are not counted)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = set()

    def _freed(self, key, n):
        self.live -= n
        self._seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_flatten(out)[0]:
            if not isinstance(x, torch.Tensor):
                continue
            st = x.untyped_storage()
            key, n = st.data_ptr(), st.nbytes()
            if n and key not in self._seen:
                self._seen.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._freed, key, n)
        return out


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_a_read_holds_one_chunk(name, monkeypatch):
    """The tensors one estimate read holds at once, counted op by op: under
    ``_KDE_BYTES_PER_PAIR`` a pair of one chunk (the bar chip_smoke.py's
    phase_ppe holds the card's peak to), where the one-pass form holds the
    whole N x N."""
    mt = MANIFOLDS[name][1]()
    n, rows = 2000, 128
    bel = tb.make_belief(mt, t(particles(name, seed=7, n=n)))
    monkeypatch.setattr(tb, "_KDE_CHUNK_PAIRS", rows * n)
    counts = {}
    for form, read in (("chunked", lambda: tb.ppe(mt, bel)),
                       ("one pass", lambda: whole(tb.ppe, mt, bel))):
        with _LiveBytes() as mode:
            read()
        counts[form] = mode.peak
    per_pair = counts["chunked"] / (rows * n)
    print(f"{name}: one read holds {per_pair:.1f} B a pair of a chunk; "
          f"the one-pass form {counts['one pass'] / n**2:.1f} B a pair of "
          f"all N x N")
    assert (counts["chunked"]
            <= tb._KDE_BYTES_PER_PAIR * tb._KDE_CHUNK_PAIRS), per_pair
    assert counts["one pass"] > 4 * counts["chunked"]


# -- LazyPPE and the parametric keyword against the JAX package --------------

def _one_variable(pkg):
    """A prior on one scalar variable, initialized by graphinit at N=100:
    its estimate is a LazyPPE nobody has read."""
    fg = (pkg.initfg(pkg.SolverParams(N=100), device=CPU) if pkg is it
          else pkg.initfg(pkg.SolverParams(N=100)))
    fg.add_variable("a", pkg.ContinuousScalar)
    fg.add_factor(["a"], pkg.Prior(pkg.Normal(3.0, 0.5)))
    lz = fg.var("a").ppe["default"]
    assert type(lz).__name__ == "LazyPPE" and not lz._done
    return fg, lz


@pytest.mark.parametrize("pkg", [jl, it], ids=["jax", "port"])
def test_unread_lazy_ppe_compares_as_its_estimate(pkg):
    fg, lz = _one_variable(pkg)
    assert (lz == {}) is False
    assert lz == {k: lz[k] for k in ("mean", "max", "suggested")}
    with pytest.raises(TypeError):
        hash(lz)


def test_unread_lazy_ppe_reads_itself_for_not_equal():
    """``!=`` reads the estimate as ``==`` does; the JAX class compares its
    still-empty dict there, so its unread estimate is neither ``== {}`` nor
    ``!= {}`` (a departure of the port, listed in docs/API_torch.md)."""
    _, lz = _one_variable(it)
    assert (lz != {}) is True
    _, lz = _one_variable(it)
    est = dict(tb.ppe(lz._manifold, lz._belief))
    assert (lz != est) is False
    _, lj = _one_variable(jl)
    assert (lj != {}) is False and (lj == {}) is False


@pytest.mark.parametrize("pkg", [jl, it], ids=["jax", "port"])
def test_lazy_ppe_pickles_and_deepcopies_as_a_plain_dict(pkg):
    fg, lz = _one_variable(pkg)
    back = pickle.loads(pickle.dumps(lz))
    fg2, lz2 = _one_variable(pkg)
    dup = copy.deepcopy(lz2)
    for got in (back, dup):
        assert type(got) is dict
        assert set(got) == {"mean", "max", "suggested"}
    for got, src in ((back, lz), (dup, lz2)):
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(src[k]))
    graph_copy = copy.deepcopy(fg2)
    assert type(graph_copy.var("a").ppe["default"]) is dict


def test_lazy_ppe_reads_agree_between_the_packages():
    fj, lj = _one_variable(jl)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    lt = tb.LazyPPE(ft.var("a").manifold, ft.get_belief("a"))
    want = pickle.loads(pickle.dumps(lj))
    got = pickle.loads(pickle.dumps(lt))
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(want["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["max"].numpy(), np.asarray(want["max"]),
                               atol=1e-4)


def test_solve_graph_parametric_takes_init_from_belief():
    """The keyword in the JAX position, ignored as there: the same points
    as the JAX package's solve (atol 1e-4, tests/test_torch_parametric.py's
    bar) and as the port's solve without it."""
    from incrementalinference.jl_tpu.parametric import solver as js
    fj = jl.canonical.generate_line_step(8, graphinit=True)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    ref = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    res = it.solve_graph_parametric(ft, 50, 2, True, compute_cov=False)
    it.solve_graph_parametric(ref, compute_cov=False)
    js.solve_graph_parametric(fj, init_from_belief=True, compute_cov=False)
    assert set(res) == set(ft.ls()) | {"_cost"}
    for v in ft.ls():
        got = ft.var(v).parametric_point
        assert torch.equal(got, ref.var(v).parametric_point), v
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(fj.var(v).parametric_point),
                                   atol=1e-4, err_msg=v)
    res = it.solve_graph_parametric(ft, init_from_belief=False)
    assert float(res["_cost"]) < 1e-6


# -- tests/test_distributions.py (KDE, PPE) on the port ------------------------

def test_kde_logpdf_and_sample_roundtrip():
    M = tm.Euclidean(1)
    pts = t(5.0 + rng(0).normal(size=(200, 1)))
    b = tb.make_belief(M, pts)
    s = tb.kde_sample(M, b, it.keys.generator(0, CPU), 2000)[:, 0].numpy()
    assert abs(s.mean() - 5.0) < 0.2
    lp = tb.kde_logpdf(M, b, t([[5.0], [50.0]]))
    assert float(lp[0]) > float(lp[1]) + 10.0


def test_ppe_fields():
    M = tm.Euclidean(2)
    b = tb.make_belief(M, t(rng(0).normal(size=(100, 2))))
    est = tb.ppe(M, b)
    for k in ("mean", "max", "suggested"):
        assert est[k].shape == (2,)
        assert bool(torch.isfinite(est[k]).all())


# -- tests/test_manual_init.py on the port -------------------------------------

def _fg():
    fg = it.initfg(it.SolverParams(N=64, graphinit=False), device=CPU)
    fg.add_variable("x0", it.ContinuousScalar)
    return fg


def test_init_from_points():
    fg = _fg()
    it.init_variable(fg, "x0", rng(0).normal(7.0, 0.5, (64, 1)))
    assert fg.var("x0").is_initialized()
    assert abs(float(fg.points("x0").mean()) - 7.0) < 0.5


def test_init_from_distribution():
    fg = _fg()
    it.init_variable(fg, "x0", it.Normal(-3.0, 0.5))
    assert fg.var("x0").is_initialized()
    assert abs(float(fg.points("x0").mean()) + 3.0) < 0.5


def test_init_from_belief_and_broadcast_point():
    fg = _fg()
    b = tb.make_belief(fg.var("x0").manifold,
                       torch.full((64, 1), 2.5, dtype=torch.float32))
    it.init_variable(fg, "x0", b)
    assert abs(float(fg.points("x0").mean()) - 2.5) < 1e-5
    # one point is repeated N times
    fg.add_variable("x1", it.ContinuousScalar)
    it.init_variable(fg, "x1", np.asarray([4.0], np.float32))
    assert fg.points("x1").shape == (64, 1)
    assert abs(float(fg.points("x1").mean()) - 4.0) < 1e-5


def test_named_key_manual_init():
    fg = _fg()
    it.init_variable(fg, "x0", it.Normal(1.0, 0.1), solve_key="manual")
    assert fg.var("x0").is_initialized("manual")
    assert not fg.var("x0").is_initialized("default")


def test_set_ppe_stores_estimates():
    fg = _fg()
    fg.params = fg.params.replace(graphinit=True)
    fg.add_factor(["x0"], it.Prior(it.Normal(5.0, 1.0)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)))
    it.solve_tree(fg)
    est = it.set_ppe(fg, "x1")
    stored = fg.var("x1").ppe["default"]
    assert set(est) >= {"mean", "max", "suggested"}
    assert float(torch.linalg.norm(stored["suggested"]
                                   - est["suggested"])) == 0
    assert abs(float(est["mean"][0]) - 15.0) < 2.5
    est2 = it.set_ppe(fg, "x0")
    assert abs(float(est2["mean"][0]) - 5.0) < 2.0

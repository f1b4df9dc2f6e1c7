"""The port's exact pair-product cascade (ops/product.py) against the JAX
package: the deterministic pieces on identical inputs, the sampled ones
statistically (the two packages' random streams differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import rng, t

from incrementalinference.jl_tpu.ops import product as jp
from incrementalinference_torch.ops import product as tp


@pytest.mark.parametrize("partial", [False, True])
def test_pair_logW_matches_jax(partial):
    r = rng(1)
    muA = r.normal(size=(120, 3)).astype(np.float32)
    muB = (r.normal(size=(90, 3)) * 2).astype(np.float32)
    precA = (np.abs(r.normal(size=(120, 3))) + 0.2).astype(np.float32)
    rowB = np.asarray([4.0, 0.5, 2.0], np.float32)
    if partial:
        precA[:, 1] = 0.0
        rowB[2] = 0.0
    precB = np.broadcast_to(rowB, (90, 3)).copy()
    got = tp._pair_logW(t(muA), t(precA), t(muB), t(precB)).numpy()
    ref = np.asarray(jp._pair_logW(jnp.asarray(muA), jnp.asarray(precA),
                                   jnp.asarray(muB), jnp.asarray(precB)))
    # identical float32 formula, summed in another order: |logW| < ~50
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_condense_mixture_matches_jax():
    # 16 well-separated clusters of 128 points, in order, so the strided
    # start puts one centroid in each and no point sits near an
    # assignment boundary where a last-bit difference could flip it
    r = rng(2)
    centers = np.repeat(np.arange(-8, 8, dtype=np.float32) * 5.0, 128)
    mu = (centers[:, None]
          + r.normal(size=(2048, 1)) * 0.3).astype(np.float32)
    prec = np.full((2048, 1), 4.0, np.float32)
    got = tp.condense_mixture(t(mu), t(prec), 0, k=16)
    ref = jp.condense_mixture(jnp.asarray(mu), jnp.asarray(prec),
                              jax.random.PRNGKey(0), k=16)
    means, precs, logw = (g.numpy() for g in got)
    # the same Lloyd steps; sums over a cluster in another order
    np.testing.assert_allclose(means, np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(logw, np.asarray(ref[2]))
    # var = E[x^2] - mean^2 cancels in float32: another summation order
    # moves it by a few ulp(mean^2) ~ 1e-4 against var ~ 0.09
    np.testing.assert_allclose(precs, np.asarray(ref[1]), rtol=5e-3)


def test_large_pair_product_matches_small_path():
    """The kernel-backed large-N pair product agrees statistically with
    the materialised path (the scenario of tests/test_pallas_kernels.py)."""
    r = rng(3)
    muA = np.concatenate([r.normal(size=(100, 2)),
                          10.0 + r.normal(size=(100, 2))]).astype(np.float32)
    muB = muA + 0.1
    prec = np.full((200, 2), 4.0, np.float32)
    mu1, p1 = tp.pair_product_tangent(t(muA), t(prec), t(muB), t(prec),
                                      5, 400)
    mu2, p2 = tp.pair_product_tangent_large(t(muA), t(prec), t(muB),
                                            t(prec), 5, 400)
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    for mu in (mu1, mu2):
        # both bimodal with a similar mass split (binomial sd ~0.025)
        m0 = float((torch.linalg.norm(mu, dim=1) < 5).float().mean())
        assert 0.25 < m0 < 0.75, m0


def test_condensed_cascade_matches_gaussian_product():
    """Nb >= CONDENSE_MIN_NB takes the condensed path: the product of
    N(0,1) and N(2,1) particle clouds is near N(1, 1/2)."""
    r = rng(4)
    n = 2000
    a = r.normal(size=(n, 1)).astype(np.float32)
    b = (2.0 + r.normal(size=(n, 1))).astype(np.float32)
    bw = 0.25
    precs = [t(np.full((n, 1), 1 / bw ** 2)), t(np.full((n, 1), 1 / bw ** 2))]
    samples, _ = tp.product_cascade_tangent([t(a), t(b)], precs, 11, n)
    m, s = float(samples.mean()), float(samples.std())
    # kernel bandwidth adds ~bw^2/2 to the variance; 2000 draws give a
    # mean standard error of ~0.02
    assert abs(m - 1.0) < 0.1, m
    assert 0.6 < s < 0.85, s


def _condense_index_add(mu, prec, k, iters=tp._CONDENSE_ITERS):
    """condense_mixture as it was written before its cluster sums became
    one-hot products: scatter-adds by ``index_add_``, which add with
    atomics on CUDA.  Returns its outputs and the final labels."""
    n = mu.shape[0]
    lam = prec[0]
    x = mu * (lam > 0).to(mu.dtype)
    stride = max(1, n // k)
    c = x[::stride][:k]
    if c.shape[0] < k:
        c = torch.cat([c, x[:k - c.shape[0]]], dim=0)
    x2 = torch.sum(x * x, 1)

    def assign(c):
        d2 = x2[:, None] - 2.0 * (x @ c.T) + torch.sum(c * c, 1)[None, :]
        return torch.argmin(d2, dim=1)

    def stats(lab, v):
        s = torch.zeros((k, v.shape[1]), dtype=v.dtype)
        return s.index_add_(0, lab, v)

    ones = torch.ones((n, 1), dtype=mu.dtype)
    for _ in range(iters):
        lab = assign(c)
        cnt = stats(lab, ones)
        c = torch.where(cnt > 0, stats(lab, x) / torch.clamp(cnt, min=1.0),
                        c)
    lab = assign(c)
    cnt = stats(lab, ones)
    mean = stats(lab, mu) / torch.clamp(cnt, min=1.0)
    var = torch.clamp(stats(lab, mu * mu) / torch.clamp(cnt, min=1.0)
                      - mean * mean, min=0.0)
    prec_c = torch.where(lam[None, :] > 0,
                         1.0 / (1.0 / torch.clamp(lam[None, :], min=1e-30)
                                + var), torch.zeros_like(var))
    cnt = cnt[:, 0]
    logw = torch.where(cnt > 0, torch.log(torch.clamp(cnt, min=1.0)),
                       torch.full_like(cnt, -1e30))
    return (mean, prec_c, logw), lab


def _condense_inputs(dof):
    """16 separated clusters, the last 5 points longer than the rest, so N
    (2101) is not a multiple of k and the strided start still puts one
    centroid in each cluster: no point lies near an assignment boundary.
    At dof 3 the middle dimension carries no precision.  The kernels are
    wider than the clusters, as where the cascade condenses: a cluster's
    variance E[x^2] - mean^2 cancels in float32 (to ~1e-4 at means of 23),
    and another summation order moves it that much in either package."""
    r = rng(30 + dof)
    sizes = [131] * 15 + [136]
    centers = r.uniform(-0.5, 0.5, size=(16, dof)) \
        + np.arange(16)[:, None] * 3.0 - 22.5
    mu = np.concatenate([c + r.normal(size=(s, dof)) * 0.3
                         for c, s in zip(centers, sizes)]).astype(np.float32)
    row = np.asarray([0.01, 0.0, 0.0025][:dof], np.float32)
    return mu, np.broadcast_to(row, mu.shape).copy()


def _no_scatter(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("condense_mixture used a scatter-add")

    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add",
                 "scatter_reduce_", "scatter_reduce", "index_put_"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("dof", [1, 3])
def test_condense_one_hot_sums_match_jax_and_the_scatter_form(dof,
                                                              monkeypatch):
    mu, prec = _condense_inputs(dof)
    k = 16
    assert mu.shape[0] % k != 0
    (om, op, ow), olab = _condense_index_add(t(mu), t(prec), k)
    ref = jp.condense_mixture(jnp.asarray(mu), jnp.asarray(prec),
                              jax.random.PRNGKey(0), k=k)
    _no_scatter(monkeypatch)
    got = tp.condense_mixture(t(mu), t(prec), 0, k=k)
    lam = t(prec)[0]
    A = tp._condense_assignment(t(mu) * (lam > 0).float(), k,
                                tp._CONDENSE_ITERS)
    monkeypatch.undo()
    # the assignments exactly: labels against the scatter form, cluster
    # sizes (the log-weights) against both
    np.testing.assert_array_equal(A.argmax(1).numpy(), olab.numpy())
    np.testing.assert_array_equal(A.sum(0).numpy(),
                                  np.bincount(olab.numpy(), minlength=k))
    np.testing.assert_array_equal(got[2].numpy(), ow.numpy())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    # the sums over a cluster in another order
    for g, o, j in zip(got, (om, op, ow), ref):
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5)


def test_condense_dead_clusters_keep_a_finite_weight():
    """k above the distinct points: the clusters no point chose keep the
    JAX package's -1e30, not -inf."""
    mu = np.repeat(np.asarray([[1.0], [5.0]], np.float32), 50, axis=0)
    prec = np.full_like(mu, 4.0)
    got = tp.condense_mixture(t(mu), t(prec), 0, k=4)
    ref = jp.condense_mixture(jnp.asarray(mu), jnp.asarray(prec),
                              jax.random.PRNGKey(0), k=4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert np.isfinite(got[2].numpy()).all()
    assert (np.sort(got[2].numpy())[:2] == np.float32(-1e30)).all()

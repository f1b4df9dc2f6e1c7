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

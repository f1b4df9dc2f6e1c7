"""Beliefs, convolution, distributions and manifolds of the port against
the JAX package on identical numpy-made inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import rng, t

from incrementalinference.jl_tpu import beliefs as jb
from incrementalinference.jl_tpu import distributions as jd
from incrementalinference.jl_tpu import manifolds as jm
from incrementalinference.jl_tpu.models import factors as jf
from incrementalinference.jl_tpu.ops import convolve as jc
from incrementalinference_torch import beliefs as tb
from incrementalinference_torch import distributions as td
from incrementalinference_torch import manifolds as tm
from incrementalinference_torch.models import factors as tf
from incrementalinference_torch.ops import convolve as tc


def _bimodal(n, dof, seed):
    r = rng(seed)
    half = n // 2
    return np.concatenate([r.normal(size=(half, dof)) * 0.3,
                           8.0 + r.normal(size=(n - half, dof)) * 0.3]
                          ).astype(np.float32)


@pytest.mark.parametrize("n,dof", [(100, 1), (100, 2), (2000, 1)])
def test_loo_bandwidth_picks_the_jax_scale(n, dof):
    """N=2000 exercises the 512-point subset of the scale search."""
    pts = _bimodal(n, dof, seed=n + dof)
    got = tb.loo_bandwidth(tm.Euclidean(dof), t(pts)).numpy()
    ref = np.asarray(jb.loo_bandwidth(jm.Euclidean(dof), jnp.asarray(pts)))
    # the grid scale is a discrete pick; the Silverman base agrees to
    # float32 rounding of the std
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_loo_bandwidth_batched_rows_match_single_calls():
    pts = np.stack([_bimodal(100, 1, seed=s) for s in range(3)])
    batched = tb.loo_bandwidth(tm.Euclidean(1), t(pts))
    for i in range(3):
        torch.testing.assert_close(
            batched[i], tb.loo_bandwidth(tm.Euclidean(1), t(pts[i])))


def test_silverman_and_kde_logpdf_match_jax():
    pts = _bimodal(200, 2, seed=5)
    q = _bimodal(30, 2, seed=6)
    man_t, man_j = tm.Euclidean(2), jm.Euclidean(2)
    np.testing.assert_allclose(
        tb.silverman_bw(man_t, t(pts)).numpy(),
        np.asarray(jb.silverman_bw(man_j, jnp.asarray(pts))), rtol=1e-5)
    bw = np.asarray([0.3, 0.5], np.float32)
    got = tb.kde_logpdf(man_t, tb.Belief(t(pts), t(bw), t(np.ones(2))),
                        t(q)).numpy()
    ref = np.asarray(jb.kde_logpdf(
        man_j, jb.Belief(jnp.asarray(pts), jnp.asarray(bw), jnp.ones(2)),
        jnp.asarray(q)))
    # float32 logsumexp over 200 kernels
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


class _TorchEuclidDistance(tf.FactorModel):
    """The JAX package's EuclidDistance residual (not yet a port model)."""

    def residual(self, meas, x1, x2):
        d = x2 - x1
        return meas - torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)
                                 + 1e-12)


def test_batched_gauss_newton_linear_matches_jax():
    r = rng(7)
    n = 64
    meas = r.normal(size=(n, 2)).astype(np.float32) + 3.0
    x1 = r.normal(size=(n, 2)).astype(np.float32)
    x0 = r.normal(size=(n, 2)).astype(np.float32) * 5
    got = tc.batched_gauss_newton(
        tm.Euclidean(2), tf.LinearRelative(td.MvNormal([0, 0], [1, 1])),
        t(meas), (t(x1),), t(x0), 1, iters=3, linear=True).numpy()
    ref = np.asarray(jc.batched_gauss_newton(
        jm.Euclidean(2), jf.LinearRelative(jd.MvNormal([0, 0], [1, 1])),
        jnp.asarray(meas), (jnp.asarray(x1),), jnp.asarray(x0), 1, iters=3,
        linear=True))
    # one damped closed-form step (damping 1e-6) in float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, x1 + meas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dof,partial", [(1, None), (2, (0,))])
def test_batched_gauss_newton_lm_matches_jax(dof, partial):
    """A range residual: unique optimum in 1-D, and in 2-D with one dim
    pinned (unpinned 2-D minima form a circle)."""
    r = rng(8)
    n = 64
    meas = (5.0 + r.normal(size=(n, 1)) * 0.1).astype(np.float32)
    x1 = r.normal(size=(n, dof)).astype(np.float32) * 0.1
    x0 = (np.asarray([3.0, 1.0][:dof])
          + r.normal(size=(n, dof))).astype(np.float32)
    got = tc.batched_gauss_newton(
        tm.Euclidean(dof), _TorchEuclidDistance(), t(meas), (t(x1),),
        t(x0), 1, iters=25, partial_dims=partial).numpy()
    ref = np.asarray(jc.batched_gauss_newton(
        jm.Euclidean(dof), jf.EuclidDistance(jd.Normal(5.0, 0.1)),
        jnp.asarray(meas), (jnp.asarray(x1),), jnp.asarray(x0), 1,
        iters=25, partial_dims=partial))
    # 25 accepted/rejected LM steps from identical starts; float32
    # rounding of a converged fixed point, |x| ~ 5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if partial is None:
        dist = np.linalg.norm(got - x1, axis=1)
        np.testing.assert_allclose(dist, meas[:, 0], atol=1e-3)
    else:
        np.testing.assert_array_equal(got[:, 1], x0[:, 1])


def test_normal_and_mvnormal_logpdf_match_jax():
    x = rng(9).normal(size=(50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        td.Normal(0.5, 2.0).logpdf(t(x[:, :1])).numpy(),
        np.asarray(jd.Normal(0.5, 2.0).logpdf(jnp.asarray(x[:, :1]))),
        rtol=1e-6, atol=1e-6)
    cov = np.asarray([[2.0, 0.3], [0.3, 0.5]], np.float32)
    # float32 solve + slogdet of a 2x2 covariance
    np.testing.assert_allclose(
        td.MvNormal([1.0, -1.0], cov).logpdf(t(x)).numpy(),
        np.asarray(jd.MvNormal([1.0, -1.0], cov).logpdf(jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_distribution_samples_have_the_moments():
    gen = torch.Generator().manual_seed(3)
    s = td.MvNormal([1.0, -2.0], [0.5, 2.0]).sample(gen, 20000)
    # 20000 draws: standard errors ~0.004 (mean) and ~0.01 (std)
    torch.testing.assert_close(s.mean(0), t([1.0, -2.0]), atol=0.05,
                               rtol=0)
    torch.testing.assert_close(s.std(0), t([0.5, 2.0]), atol=0.05, rtol=0)


@pytest.mark.parametrize("name", ["Euclidean", "Circle"])
def test_manifold_exp_log_mean_match_jax(name):
    r = rng(10)
    p = (r.normal(size=(40, 1)) * 2.5).astype(np.float32)
    q = (r.normal(size=(40, 1)) * 2.5).astype(np.float32)
    X = r.normal(size=(40, 1)).astype(np.float32)
    mt = tm.Euclidean(1) if name == "Euclidean" else tm.Circle()
    mj = jm.Euclidean(1) if name == "Euclidean" else jm.Circle()
    # float32 elementwise ops (wrap_angle: one rounding of 2*pi*round)
    for f in ("exp", "log"):
        b = X if f == "exp" else q
        np.testing.assert_allclose(
            getattr(mt, f)(t(p), t(b)).numpy(),
            np.asarray(getattr(mj, f)(jnp.asarray(p), jnp.asarray(b))),
            rtol=1e-6, atol=1e-6)
    # Karcher mean: 8 fixed iterations on the circle
    np.testing.assert_allclose(mt.mean(t(p)).numpy(),
                               np.asarray(mj.mean(jnp.asarray(p))),
                               rtol=1e-5, atol=1e-5)

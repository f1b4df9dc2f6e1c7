"""The plain references on small inputs."""

import math

import numpy as np
import pytest
import torch

from bench_port.checks.beliefs import _stale, pose_gaps
from bench_port.graphs import se2pair
from bench_port.reference import gaussian, kde
from bench_port.reference.manifolds import SE2, Rn


def _pair(seed=11, step=3):
    cfg = {"graph_params": {"prior_sigma": [0.01, 0.01, 0.01],
                            "step": [10.0, 0.0, math.pi / 2],
                            "sigma": [0.5, 0.5, 0.05]}}
    meas = se2pair.measurements(cfg, seed, step)
    M = SE2()
    x, S = gaussian.posterior(M, meas["labels"], meas["factors"],
                              torch.zeros(2, 3, dtype=torch.float64))
    return M, meas, x, S


def test_laplace_posterior_of_the_two_pose_graph():
    """The point is exact: x0 at the prior's point, x1 at x0 o Exp(z); the
    covariance is the prior's for x0, and for x1 that of the graph's own
    generative draw (x0 from the prior, then the factor's tangent), to the
    Monte Carlo error of 400,000 draws and the linearisation."""
    M, meas, x, S = _pair()
    (_, p0, sp), (_, z, sig) = meas["factors"]
    p0 = torch.tensor(p0, dtype=torch.float64)
    z = torch.tensor(z, dtype=torch.float64)
    torch.testing.assert_close(x[0], p0, atol=1e-10, rtol=0)
    torch.testing.assert_close(x[1], M.exp(p0, z), atol=1e-10,
                               rtol=0)
    torch.testing.assert_close(S[:3, :3], torch.diag(
        torch.tensor(sp, dtype=torch.float64) ** 2), atol=1e-12, rtol=1e-6)
    g = torch.Generator().manual_seed(5)
    n = 400_000
    e0 = torch.randn(n, 3, generator=g, dtype=torch.float64)
    e1 = torch.randn(n, 3, generator=g, dtype=torch.float64)
    x0 = M.exp(p0.expand(n, 3), e0 * torch.tensor(sp, dtype=torch.float64))
    x1 = M.exp(x0, z + e1 * torch.tensor(sig, dtype=torch.float64))
    t = M.log(x[1].expand(n, 3), x1)
    C = torch.cov(t.T, correction=0)
    rel = (C - S[3:, 3:]).abs() / torch.sqrt(
        torch.outer(S[3:, 3:].diagonal(), S[3:, 3:].diagonal()))
    assert float(rel.max()) < 0.02
    assert float((t.mean(0) / S[3:, 3:].diagonal().sqrt()).abs().max()) < 0.05


def test_the_pose_gaps_read_a_shift_and_a_spread():
    M, _, x, S = _pair()
    C = S[3:, 3:]
    L = torch.linalg.cholesky(C)
    g = torch.Generator().manual_seed(6)
    e = torch.randn(50_000, 3, generator=g, dtype=torch.float64)
    pts = M.exp(x[1].expand(50_000, 3), e @ L.T)
    z, sd = pose_gaps(M, pts, x[1], C)
    assert z < 0.03 and sd < 0.02
    shift = L[:, 0]                        # one sigma along an axis
    z, _ = pose_gaps(M, M.exp(x[1].expand(50_000, 3), e @ L.T + shift),
                     x[1], C)
    assert z == pytest.approx(1.0, abs=0.05)
    _, sd = pose_gaps(M, M.exp(x[1].expand(50_000, 3), 2 * e @ L.T), x[1], C)
    assert sd == pytest.approx(math.log(2), abs=0.03)


def test_stale_share_counts_rows_kept_bit_for_bit():
    g = torch.Generator().manual_seed(7)
    init = torch.randn(100, 3, generator=g)
    new = torch.randn(100, 3, generator=g)
    assert _stale(new, init) == 0.0
    assert _stale(torch.cat([new[:60], init[60:]]), init) == 0.4
    assert _stale(init + 1e-7, init) < 0.1
    assert _stale(new, None) == 0.0


def test_se2_exp_and_log_invert_each_other():
    M = SE2()
    g = torch.Generator().manual_seed(3)
    p = torch.randn(50, 3, generator=g, dtype=torch.float64)
    X = 0.7 * torch.randn(50, 3, generator=g, dtype=torch.float64)
    q = M.exp(p, X)
    torch.testing.assert_close(M.log(p, q), X, atol=1e-10, rtol=0)
    assert float(M.log(q, q).abs().max()) < 1e-12
    # the group's Exp of a pure translation is that translation
    t = torch.tensor([1.5, -2.0, 0.0], dtype=torch.float64)
    torch.testing.assert_close(M.Exp(t), t)


def test_karcher_mean_of_a_symmetric_cloud_is_its_centre():
    M = SE2()
    c = torch.tensor([3.0, -1.0, 0.4], dtype=torch.float64)
    d = torch.tensor([[0.2, 0, 0], [0, 0.2, 0], [0, 0, 0.1]],
                     dtype=torch.float64)
    pts = M.exp(c.expand(6, 3), torch.cat([d, -d]))
    torch.testing.assert_close(M.mean(pts), c, atol=1e-9, rtol=0)


def test_loo_bandwidth_picks_the_grid_point_of_best_likelihood():
    g = torch.Generator().manual_seed(1)
    pts = torch.randn(80, 1, generator=g, dtype=torch.float64)
    M = Rn(1)
    bw0, scales, lls = kde.bandwidth_terms(M, pts)
    sd = float(pts.std(correction=0))
    assert float(bw0[0]) == pytest.approx(
        sd * (4 / (3 * 80)) ** 0.2, rel=1e-12)
    # brute force: leave-one-out log-likelihood of each scale
    x = (pts[:, 0] / bw0[0]).numpy()
    best = None
    for j, s in enumerate(scales.numpy()):
        ll = 0.0
        for i in range(80):
            others = np.delete(x, i)
            a = -0.5 * (x[i] - others) ** 2 / s**2
            ll += a.max() + np.log(np.sum(np.exp(a - a.max())))
        ll -= 80 * np.log(s)
        assert ll == pytest.approx(float(lls[j]), rel=1e-9, abs=1e-9)
        best = j if best is None or ll > bestll else best
        bestll = ll if best == j else bestll
    assert float(kde.loo_bandwidth(M, pts)[0]) == pytest.approx(
        float(scales[best] * bw0[0]))


def test_kde_log_density_against_the_direct_sum():
    g = torch.Generator().manual_seed(2)
    pts = torch.randn(40, 3, generator=g, dtype=torch.float64)
    bw = torch.tensor([0.3, 0.4, 0.05], dtype=torch.float64)
    q = pts[:5] + 0.01
    M = SE2()
    got = kde.logdensity(M, pts, bw, q, chunk_pairs=64)
    z = M.log(pts[None], q[:, None]) / bw
    want = (torch.logsumexp(-0.5 * (z * z).sum(-1), -1) - math.log(40)
            - torch.log(bw).sum() - 1.5 * math.log(2 * math.pi))
    torch.testing.assert_close(got, want)
    mean, pmax, lp = kde.estimates(M, pts, bw)
    torch.testing.assert_close(pmax, pts[int(torch.argmax(lp))])

"""Kernel density beliefs: the leave-one-out bandwidth, the density, the
point estimates.

The semantics are upstream's and the JAX package's: a belief is N particles
with a diagonal tangent bandwidth ``bw = s * bw0``.  ``bw0`` is Silverman's
rule, ``sd * (4 / ((d + 2) n))^(1 / (d + 4))``, from the tangent standard
deviations (population form) at the Karcher mean, floored at 1e-5.  ``s``
is the point of a 24-point log grid from 10^-1.5 to 10^0.3 with the highest
leave-one-out log-likelihood, taken on at most 512 particles (every
ceil(n / 512)-th from the first).  The estimates are the Karcher mean and
the particle of highest kernel density (tied particles averaged).
"""

from __future__ import annotations

import math

import torch

from .precision import dtype_of, matmul_mode

LOO_GRID = 24
LOO_LO, LOO_HI = -1.5, 0.3
LOO_MAX_POINTS = 512


def silverman_factor(n: int, d: int) -> float:
    return (4.0 / ((d + 2.0) * n)) ** (1.0 / (d + 4.0))


def loo_subsample(X):
    n = X.shape[-2]
    if n <= LOO_MAX_POINTS:
        return X
    stride = -(-n // LOO_MAX_POINTS)
    return X[..., ::stride, :][..., :LOO_MAX_POINTS, :]


def loo_scales(dtype=torch.float64, device=None):
    return torch.logspace(LOO_LO, LOO_HI, LOO_GRID, dtype=dtype,
                          device=device)


def bandwidth_terms(manifold, points, precision: str = "float64"):
    """(bw0, scales, lls) of one belief's particles ``points`` (n, pd):
    the Silverman base (dof,), the grid (G,) and the leave-one-out
    log-likelihood at each grid point (G,), all in ``precision``."""
    dt = dtype_of(precision)
    with matmul_mode(precision):
        pts = points.to(dt)
        n = pts.shape[0]
        mu = manifold.mean(pts)
        X = manifold.log(mu[None, :], pts)
        d = X.shape[-1]
        sd = X.var(dim=0, correction=0).sqrt()
        bw0 = torch.clamp(sd * silverman_factor(n, d), min=1e-5)
        Z = loo_subsample(X) / bw0
        m = Z.shape[0]
        # the pairwise squared distances as a product, the way a float32
        # program forms them: |a|^2 + |b|^2 - 2 a.b
        z2 = (Z * Z).sum(dim=-1)
        D2 = torch.clamp(z2[:, None] + z2[None, :] - 2.0 * (Z @ Z.T), min=0)
        D2 = D2 + torch.eye(m, dtype=dt, device=D2.device) * 1e12
        scales = loo_scales(dt, pts.device)
        logk = -0.5 * D2[None] / (scales * scales)[:, None, None]
        lls = (torch.logsumexp(logk, dim=-1).sum(dim=-1)
               - m * d * torch.log(scales))
    return bw0, scales, lls


def loo_bandwidth(manifold, points, precision: str = "float64"):
    """The belief's bandwidth (dof,)."""
    bw0, scales, lls = bandwidth_terms(manifold, points, precision)
    return scales[torch.argmax(lls)] * bw0


def logdensity(manifold, points, bw, query, precision: str = "float64",
               chunk_pairs: int = 1 << 23):
    """log p(query) under the Gaussian-kernel KDE of ``points`` with
    bandwidth ``bw``, in chunks of query rows."""
    dt = dtype_of(precision)
    P, B, Q = points.to(dt), bw.to(dt), query.to(dt)
    n, d = P.shape[0], B.shape[-1]
    step = max(1, chunk_pairs // n)
    out = []
    with matmul_mode(precision):
        for r in range(0, Q.shape[0], step):
            z = manifold.log(P[None, :, :], Q[r:r + step, None, :]) / B
            out.append(torch.logsumexp(-0.5 * (z * z).sum(dim=-1), dim=-1))
        lognorm = torch.log(B).sum() + 0.5 * d * math.log(2.0 * math.pi)
        return torch.cat(out) - math.log(n) - lognorm


def estimates(manifold, points, bw, precision: str = "float64"):
    """(mean, max, log-density at every particle): the Karcher mean and
    the particle of highest density, ties averaged."""
    lp = logdensity(manifold, points, bw, points, precision)
    pts = points.to(lp.dtype)
    sel = lp == lp.max()
    pmax = pts[sel].mean(dim=0)
    return manifold.mean(pts), pmax, lp

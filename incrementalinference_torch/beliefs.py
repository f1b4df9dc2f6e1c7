"""Particle/KDE beliefs on manifolds.

Counterpart of ``incrementalinference/jl_tpu/beliefs.py``: a belief is a
particle tensor plus a diagonal tangent-space bandwidth (reference
TreeBelief, src/entities/BeliefTypes.jl:23-34).  Bandwidths come from the
same leave-one-out scale search over a Silverman base as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .manifolds import Manifold


class Belief(NamedTuple):
    """KDE belief: ``points`` (N, point_dim), ``bw`` (dof,) 1-sigma tangent
    bandwidths, ``ipc`` infoPerCoord (dof,)."""

    points: torch.Tensor
    bw: torch.Tensor
    ipc: torch.Tensor

    @property
    def n(self) -> int:
        return self.points.shape[0]


def _silverman_factor(n: int, d: int) -> float:
    return (4.0 / ((d + 2.0) * n)) ** (1.0 / (d + 4.0))


def silverman_bw(manifold: Manifold, points: torch.Tensor,
                 floor: float = 1e-4) -> torch.Tensor:
    """Per-dimension Silverman bandwidth in the tangent space at the mean."""
    mu = manifold.mean(points)
    X = manifold.log(mu[None, :], points)
    sd = torch.std(X, dim=0, correction=0)
    return torch.clamp(sd * _silverman_factor(points.shape[0], X.shape[-1]),
                       min=floor)


# LOO scale selection subsamples above this many points: the grid search
# only corrects mode-vs-global spread, which a few hundred points resolve,
# while the n-dependence stays in the full-N Silverman base (the pairwise
# matrix at N=50k would be 10 GB).
_LOO_MAX_POINTS = 512


def loo_bandwidth(manifold: Manifold, points: torch.Tensor,
                  n_grid: int = 24) -> torch.Tensor:
    """Leave-one-out max-likelihood bandwidth (diagonal, shared scale).

    ``bw = s · bw_silverman`` with the scalar ``s`` picked from a log grid
    by the LOO log-likelihood, all candidates from one pairwise distance
    matrix.  ``points`` may carry leading batch dimensions (..., N, pd): one
    call then selects a bandwidth per batch entry, the batch dimension
    standing where the JAX package vmaps."""
    n = points.shape[-2]
    mu = manifold.mean(points)
    X = manifold.log(mu[..., None, :], points)                # (..., N, dof)
    sd = torch.std(X, dim=-2, correction=0)
    d = X.shape[-1]
    bw0 = torch.clamp(sd * _silverman_factor(n, d), min=1e-5)  # (..., dof)

    m = n
    if n > _LOO_MAX_POINTS:
        stride = -(-n // _LOO_MAX_POINTS)
        X = X[..., ::stride, :][..., :_LOO_MAX_POINTS, :]
        m = X.shape[-2]

    Z = X / bw0[..., None, :]
    z2 = torch.sum(Z * Z, dim=-1)                              # (..., M)
    D2 = z2[..., :, None] + z2[..., None, :] - 2.0 * (Z @ Z.transpose(-1, -2))
    D2 = torch.clamp(D2, min=0.0) + torch.eye(
        m, dtype=D2.dtype, device=D2.device) * 1e12           # mask self

    scales = torch.logspace(-1.5, 0.3, n_grid, dtype=points.dtype,
                            device=points.device)
    s2 = (scales * scales).reshape((n_grid,) + (1,) * D2.dim())
    logk = -0.5 * D2.unsqueeze(0) / s2                   # (G, ..., M, M)
    lls = (torch.logsumexp(logk, dim=-1).sum(dim=-1)
           - m * d * torch.log(scales).reshape((n_grid,) + (1,) * (D2.dim() - 2)))
    s_best = scales[torch.argmax(lls, dim=0)]                  # (...)
    return s_best[..., None] * bw0


_IPC_ONES: dict = {}


def make_belief(manifold: Manifold, points: torch.Tensor,
                bw: torch.Tensor | None = None,
                ipc: torch.Tensor | None = None) -> Belief:
    """Build a ``Belief`` from particles, LOO-selecting ``bw`` if omitted."""
    if bw is None:
        bw = loo_bandwidth(manifold, points)
    if ipc is None:
        k = (int(manifold.dof), str(points.dtype), str(points.device))
        ipc = _IPC_ONES.get(k)
        if ipc is None:
            ipc = _IPC_ONES[k] = torch.ones((manifold.dof,),
                                            dtype=points.dtype,
                                            device=points.device)
    return Belief(points=points, bw=torch.as_tensor(bw, device=points.device),
                  ipc=torch.as_tensor(ipc, device=points.device))


def kde_logpdf(manifold: Manifold, belief: Belief,
               query: torch.Tensor) -> torch.Tensor:
    """log p(query) under the Gaussian-kernel KDE.  query: (Q, point_dim)."""
    X = manifold.log(belief.points[None, :, :], query[:, None, :])
    z = X / belief.bw
    logk = -0.5 * torch.sum(z * z, dim=-1)                     # (Q, N)
    lognorm = (torch.sum(torch.log(belief.bw))
               + 0.5 * belief.bw.shape[-1] * math.log(2.0 * math.pi))
    n = belief.points.shape[0]
    return torch.logsumexp(logk, dim=-1) - math.log(float(n)) - lognorm


def kde_sample(manifold: Manifold, belief: Belief, gen: torch.Generator,
               n: int) -> torch.Tensor:
    """n samples from the KDE: uniform kernel choice plus tangent noise."""
    idx = torch.randint(0, belief.points.shape[0], (n,), generator=gen,
                        device=belief.points.device)
    X = belief.bw * torch.randn((n, belief.bw.shape[-1]), generator=gen,
                                device=belief.points.device)
    return manifold.exp(belief.points[idx], X)


def mean_cov(manifold: Manifold, points: torch.Tensor):
    """On-manifold mean and tangent-space covariance."""
    mu = manifold.mean(points)
    X = manifold.log(mu[None, :], points)
    cov = (X.T @ X) / max(points.shape[0] - 1, 1)
    return mu, cov


def _ppe_core(manifold: Manifold, pts: torch.Tensor, bw: torch.Tensor):
    """Karcher mean and max-density particle of particle sets
    ``pts`` (..., N, point_dim) with bandwidths ``bw`` (..., dof)."""
    mu = manifold.mean(pts)
    X = manifold.log(pts[..., None, :, :], pts[..., :, None, :])
    z = X / bw[..., None, None, :]
    logk = -0.5 * torch.sum(z * z, dim=-1)                     # (..., Q, N)
    lognorm = (torch.sum(torch.log(bw), dim=-1)
               + 0.5 * bw.shape[-1] * math.log(2.0 * math.pi))
    lp = (torch.logsumexp(logk, dim=-1) - math.log(float(pts.shape[-2]))
          - lognorm[..., None])
    sel = (lp == torch.amax(lp, dim=-1, keepdim=True)).to(pts.dtype)
    pmax = ((sel[..., None] * pts).sum(-2)
            / torch.clamp(sel.sum(-1), min=1.0)[..., None])
    return mu, pmax


def ppe(manifold: Manifold, belief: Belief):
    """Posterior point estimates (reference calcPPE → MeanMaxPPE):
    mean = Karcher mean, max = suggested = the particle of highest KDE
    density (ties averaged, as in the JAX package)."""
    mu, pmax = _ppe_core(manifold, belief.points, belief.bw)
    return {"mean": mu, "max": pmax, "suggested": pmax}


def ppe_batched(manifold: Manifold, beliefs):
    """:func:`ppe` of several same-shape beliefs on one manifold, in one
    batched pass (the JAX package's per-clique frontal write-back)."""
    mus, pmaxs = _ppe_core(manifold,
                           torch.stack([b.points for b in beliefs]),
                           torch.stack([b.bw for b in beliefs]))
    return [{"mean": mu, "max": pm, "suggested": pm}
            for mu, pm in zip(mus, pmaxs)]


def is_partial(belief: Belief) -> bool:
    """Whether the belief constrains only a subset of tangent dims: some
    infoPerCoord entries are zero (reference isPartial on beliefs)."""
    return bool((belief.ipc <= 0).any())


class LazyPPE(dict):
    """calcPPE result computed on first access (the JAX package's LazyPPE):
    solves that never read an estimate never pay for its N×N KDE."""

    def __init__(self, manifold: Manifold, belief: Belief):
        super().__init__()
        self._manifold = manifold
        self._belief = belief
        self._done = False

    def _force(self):
        if not self._done:
            self.update(ppe(self._manifold, self._belief))
            self._done = True

    def __getitem__(self, k):
        self._force()
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._force()
        return super().get(k, default)

    def __contains__(self, k):
        self._force()
        return super().__contains__(k)

    def __iter__(self):
        self._force()
        return super().__iter__()

    def keys(self):
        self._force()
        return super().keys()

    def items(self):
        self._force()
        return super().items()

    def values(self):
        self._force()
        return super().values()

    def __len__(self):
        self._force()
        return super().__len__()

    def __repr__(self):
        self._force()
        return dict.__repr__(self)


def spread_estimate(manifold: Manifold, points_a: torch.Tensor,
                    points_b: torch.Tensor) -> torch.Tensor:
    """Mean pairwise distance proxy between two particle clouds — drives the
    entropy-inflation spread (reference
    calcVariableDistanceExpectedFractional)."""
    mu_a = manifold.mean(points_a)
    d = manifold.dist(mu_a[..., None, :], points_b)
    return torch.mean(d, dim=-1) + torch.std(d, dim=-1, correction=0)

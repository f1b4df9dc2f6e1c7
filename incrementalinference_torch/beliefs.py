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

from . import tracing
from .config import full_precision
from .manifolds import Manifold
from .ops.kernels import kde_lse


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

# KDE read-outs on the eager route (kde_logpdf, and through it ppe and
# ppe_batched, wherever the kernel does not read) take their query rows,
# and where one row of every belief is already too many their beliefs, in
# chunks of at most this many (query, kernel) pairs.  Eager
# SE(3), the costliest manifold, holds about 201 B a pair at once, so a
# chunk stays near 3.2 GiB up to N = 2^24 particles a belief (SE(2) 48 B a
# pair, R¹ 16 B; tests/test_torch_ppe.py counts them), under
# _KDE_BYTES_PER_PAIR a pair, the bar the tests and chip_smoke.py hold.
# Fixed, never derived from free memory: a chunk that moved with what else
# the process holds could move the reductions, and with them the chosen
# particle.
_KDE_CHUNK_PAIRS = 1 << 24
_KDE_BYTES_PER_PAIR = 256


@full_precision()
@tracing.spanned("bandwidth",
                 lambda manifold, points, *a, **k: {"N": points.shape[-2]})
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


@tracing.spanned("kde_logpdf", lambda manifold, belief, query: {
    "N": belief.points.shape[-2], "Q": query.shape[-2],
    "manifold": type(manifold).__name__})
def kde_logpdf(manifold: Manifold, belief: Belief,
               query: torch.Tensor) -> torch.Tensor:
    """log p(query) under the Gaussian-kernel KDE.  query: (Q, point_dim);
    ``belief.points`` may carry leading batch dimensions (..., N,
    point_dim), with ``query`` (..., Q, point_dim) and ``belief.bw``
    (..., dof) beside them.

    Two routes, chosen by what the call shows: on ``Euclidean(d)`` (d up
    to ``kde_lse.MAX_DOF``), ``SE2`` and ``SE3``, with float32 CUDA
    tensors and no gradient asked, one hand-written kernel reads every
    (query, kernel) pair in registers (``ops/kernels/kde_lse.py``; counter
    ``kde_pairs``), and a row's value there does not depend on the rest of
    the query.  On ``SE3`` the kernel follows ``SE3.log`` with its
    small-angle forms and clamps, V^-1 taken from the relative
    quaternion's half angle, which keeps in float32 what the eager
    ``SE3.log`` loses there at small relative angles.
    Everywhere else, the CPU included, the query rows go through in chunks
    of at most ``_KDE_CHUNK_PAIRS`` (query, kernel) pairs, each row by the
    same expressions as a whole pass, so the read holds one chunk's
    tangents, never the (Q, N, dof) tensor (counter ``kde_eager_pairs``).
    Where one row of every batch entry is more than a chunk, the entries
    go through in groups, each group in row chunks of its own; only a
    single belief of more than ``_KDE_CHUNK_PAIRS`` particles goes past
    the chunk (one row at a time).  Both routes subtract the same
    normaliser.  The call's span carries ``N``, ``Q`` and ``manifold``,
    the manifold's class name."""
    points, bw = belief.points, belief.bw
    n = points.shape[-2]
    lead = torch.broadcast_shapes(points.shape[:-2], query.shape[:-2],
                                  bw.shape[:-1])
    pairs = math.prod(lead) * query.shape[-2] * n
    if kde_lse.takes(manifold, points, query, bw):
        tracing.count("kde_pairs", pairs)
        lse = kde_lse.kde_row_logsumexp(manifold, points.contiguous(),
                                        query.contiguous(), bw.contiguous())
    else:
        tracing.count("kde_eager_pairs", pairs)
        lse = _kde_lse_chunked(manifold, points, bw, query, lead)
    lognorm = (torch.sum(torch.log(bw), dim=-1)
               + 0.5 * bw.shape[-1] * math.log(2.0 * math.pi))
    return lse - math.log(float(n)) - lognorm[..., None]


def _kde_lse_chunked(manifold: Manifold, points: torch.Tensor,
                     bw: torch.Tensor, query: torch.Tensor,
                     lead) -> torch.Tensor:
    """:func:`kde_logpdf`'s eager route before the normaliser: the kernels'
    logsumexp at every query row, in chunks of at most
    ``_KDE_CHUNK_PAIRS`` pairs (batch entries in groups where one row of
    each is already more)."""
    n = points.shape[-2]
    if math.prod(lead) > 1 and math.prod(lead) * n > _KDE_CHUNK_PAIRS:
        g = max(1, _KDE_CHUNK_PAIRS // n)
        pf = points.expand(lead + points.shape[-2:]).reshape(
            (-1,) + points.shape[-2:])
        qf = query.expand(lead + query.shape[-2:]).reshape(
            (-1,) + query.shape[-2:])
        bf = bw.expand(lead + bw.shape[-1:]).reshape(-1, bw.shape[-1])
        lse = [_kde_lse_chunked(manifold, pf[i:i + g], bf[i:i + g],
                                qf[i:i + g], pf[i:i + g].shape[:-2])
               for i in range(0, pf.shape[0], g)]
        return torch.cat(lse).reshape(lead + query.shape[-2:-1])
    step = max(1, _KDE_CHUNK_PAIRS // max(math.prod(lead) * n, 1))
    P, B = points[..., None, :, :], bw[..., None, None, :]
    # an empty query still makes one (empty) chunk, for the result's shape
    lse = [_kde_row_lse(manifold, P, B, query[..., r:r + step, None, :])
           for r in range(0, query.shape[-2], step) or (0,)]
    return torch.cat(lse, dim=-1)


def _kde_row_lse(manifold: Manifold, P: torch.Tensor, B: torch.Tensor,
                 q: torch.Tensor) -> torch.Tensor:
    """One chunk of :func:`kde_logpdf`: the kernels' logsumexp at query
    rows ``q`` (..., rows, 1, point_dim).  A function of its own, so the
    chunk's tangents are freed before the next chunk's are made."""
    X = manifold.log(P, q)
    z = X / B
    logk = -0.5 * torch.sum(z * z, dim=-1)                    # (..., rows, N)
    return torch.logsumexp(logk, dim=-1)


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
    ``pts`` (..., N, point_dim) with bandwidths ``bw`` (..., dof); the KDE
    at the particles is :func:`kde_logpdf`'s (its kernel or its chunks)."""
    mu = manifold.mean(pts)
    lp = kde_logpdf(manifold, Belief(points=pts, bw=bw, ipc=bw), pts)
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
    solves that never read an estimate never pay for its N×N KDE.  A
    comparison, a pickle or a deepcopy reads it, as in the JAX package;
    ``!=`` reads it too, where the JAX class compares its still-empty dict
    (there an unread estimate is neither ``== {}`` nor ``!= {}``)."""

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

    def __eq__(self, other):
        self._force()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        self._force()
        return dict.__ne__(self, other)

    __hash__ = None

    def __reduce__(self):
        # pickle and deepcopy take the estimate as a plain dict, not the
        # belief it is computed from
        self._force()
        return (dict, (dict(self),))


def spread_estimate(manifold: Manifold, points_a: torch.Tensor,
                    points_b: torch.Tensor) -> torch.Tensor:
    """Mean pairwise distance proxy between two particle clouds — drives the
    entropy-inflation spread (reference
    calcVariableDistanceExpectedFractional)."""
    mu_a = manifold.mean(points_a)
    d = manifold.dist(mu_a[..., None, :], points_b)
    return torch.mean(d, dim=-1) + torch.std(d, dim=-1, correction=0)

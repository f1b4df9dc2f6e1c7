"""Manifolds as coordinate functions on tensors.

Counterpart of ``incrementalinference/jl_tpu/manifolds/base.py``.  A point
is a ``(point_dim,)`` float tensor, a tangent vector its ``(dof,)``
coordinate vector, and every op broadcasts over leading batch dimensions so
particle sets ``(N, dim)`` are plain tensors.  Manifold objects are
stateless and hashable, so they can key plan caches.
"""

from __future__ import annotations

import math

import torch


class Manifold:
    """Base manifold: ``point_dim`` ambient coords, ``dof`` tangent coords."""

    point_dim: int
    dof: int

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self):
        return hash((type(self).__name__, self._key()))

    def _key(self):
        return ()

    def __repr__(self):
        k = self._key()
        return f"{type(self).__name__}{k if k else ''}"

    def identity(self, device=None) -> torch.Tensor:
        raise NotImplementedError

    def exp(self, p: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """Retract tangent coords X at base point p."""
        raise NotImplementedError

    def log(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Tangent coords of q in the chart at p."""
        raise NotImplementedError

    def dist(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        X = self.log(p, q)
        return torch.sqrt(torch.sum(X * X, dim=-1))

    def project(self, p: torch.Tensor) -> torch.Tensor:
        """Re-normalise an ambient point onto the manifold (no-op)."""
        return p

    def compose(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, p: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, points: torch.Tensor, weights: torch.Tensor | None = None,
             iters: int = 8) -> torch.Tensor:
        """(Weighted) Karcher mean of ``points`` (..., N, point_dim) with a
        fixed iteration count, as in the JAX package."""
        n = points.shape[-2]
        w = (torch.full((n,), 1.0 / n, dtype=points.dtype,
                        device=points.device)
             if weights is None else weights / torch.sum(weights))
        p = points[..., 0, :]
        for _ in range(iters):
            X = self.log(p[..., None, :], points)
            p = self.exp(p, torch.sum(w[..., :, None] * X, dim=-2))
        return p


class Euclidean(Manifold):
    """TranslationGroup(n) — ContinuousEuclid{N} / Position{N}."""

    def __init__(self, n: int):
        self.n = int(n)
        self.point_dim = self.n
        self.dof = self.n

    def _key(self):
        return (self.n,)

    def identity(self, device=None):
        return torch.zeros((self.n,), dtype=torch.float32, device=device)

    def exp(self, p, X):
        return p + X

    def log(self, p, q):
        return q - p

    def compose(self, p, q):
        return p + q

    def inverse(self, p):
        return -p

    def mean(self, points, weights=None, iters=0):
        if weights is None:
            return torch.mean(points, dim=-2)
        w = weights / torch.sum(weights)
        return torch.sum(w[..., :, None] * points, dim=-2)


def wrap_angle(t: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return t - 2.0 * math.pi * torch.round(t / (2.0 * math.pi))


class Circle(Manifold):
    """RealCircleGroup — the Circular variable."""

    point_dim = 1
    dof = 1

    def identity(self, device=None):
        return torch.zeros((1,), dtype=torch.float32, device=device)

    def exp(self, p, X):
        return wrap_angle(p + X)

    def log(self, p, q):
        return wrap_angle(q - p)

    def compose(self, p, q):
        return wrap_angle(p + q)

    def inverse(self, p):
        return wrap_angle(-p)

    def project(self, p):
        return wrap_angle(p)

"""The two manifolds the configurations use, in plain PyTorch.

R^n: points and tangents are the coordinates.  SE(2): a point is
(x, y, theta), a tangent (rho_x, rho_y, phi); ``exp(p, X) = p o Exp(X)`` and
``log(p, q) = Log(p^-1 o q)`` (right perturbation, as upstream's
``ManifoldPrior`` and ``ManifoldFactor`` on SpecialEuclidean(2) use it).
"""

from __future__ import annotations

import math

import torch


def _wrap(t):
    return t - 2.0 * math.pi * torch.round(t / (2.0 * math.pi))


def _sinc_terms(phi):
    """sin(phi)/phi and (1 - cos(phi))/phi, with their series near 0."""
    small = phi.abs() < 1e-4
    ph = torch.where(small, torch.ones_like(phi), phi)
    a = torch.where(small, 1.0 - phi * phi / 6.0, torch.sin(ph) / ph)
    b = torch.where(small, 0.5 * phi, (1.0 - torch.cos(ph)) / ph)
    return a, b


class Rn:
    """Euclidean space of ``dof`` coordinates."""

    def __init__(self, dof: int):
        self.dof = dof

    def exp(self, p, X):
        return p + X

    def log(self, p, q):
        return q - p

    def mean(self, points):
        return points.mean(dim=-2)


class SE2:
    """SpecialEuclidean(2)."""

    dof = 3

    @staticmethod
    def _rot(theta, v):
        c, s = torch.cos(theta), torch.sin(theta)
        return torch.stack([c * v[..., 0] - s * v[..., 1],
                            s * v[..., 0] + c * v[..., 1]], dim=-1)

    def compose(self, p, q):
        t = p[..., :2] + self._rot(p[..., 2], q[..., :2])
        return torch.cat([t, _wrap(p[..., 2:] + q[..., 2:])], dim=-1)

    def inverse(self, p):
        th = -p[..., 2]
        return torch.cat([-self._rot(th, p[..., :2]), _wrap(th)[..., None]],
                         dim=-1)

    def Exp(self, X):
        a, b = _sinc_terms(X[..., 2])
        vx, vy = X[..., 0], X[..., 1]
        t = torch.stack([a * vx - b * vy, b * vx + a * vy], dim=-1)
        return torch.cat([t, _wrap(X[..., 2:])], dim=-1)

    def Log(self, p):
        phi = _wrap(p[..., 2])
        a, b = _sinc_terms(phi)
        den = a * a + b * b
        x, y = p[..., 0], p[..., 1]
        rho = torch.stack([(a * x + b * y) / den, (-b * x + a * y) / den],
                          dim=-1)
        return torch.cat([rho, phi[..., None]], dim=-1)

    def exp(self, p, X):
        return self.compose(p, self.Exp(X))

    def log(self, p, q):
        return self.Log(self.compose(self.inverse(p), q))

    def mean(self, points, iters: int = 30):
        """Karcher mean: Gauss-Newton from the first point until it stops
        moving (a fixed count, far more than SE(2) particle clouds need)."""
        p = points[..., 0, :]
        for _ in range(iters):
            p = self.exp(p, self.log(p[..., None, :], points).mean(dim=-2))
        return p


def by_name(name: str, dof: int):
    """The manifold a configuration names."""
    if name == "SE2":
        return SE2()
    if name == "Rn":
        return Rn(dof)
    raise ValueError(f"no reference manifold {name!r}")

"""Product manifolds.

Counterpart of ``incrementalinference/jl_tpu/manifolds/product.py``
(reference ProductManifold): the Cartesian product of component manifolds,
point and tangent coordinates concatenated in component order.
"""

from __future__ import annotations

import torch

from .base import Manifold


class Product(Manifold):
    """Cartesian product of component manifolds; coords are concatenated."""

    def __init__(self, *components: Manifold):
        self.components = tuple(components)
        self.point_dim = sum(c.point_dim for c in self.components)
        self.dof = sum(c.dof for c in self.components)
        # coordinate offsets for slicing
        self._poff, self._toff = [0], [0]
        for c in self.components:
            self._poff.append(self._poff[-1] + c.point_dim)
            self._toff.append(self._toff[-1] + c.dof)

    def _key(self):
        return self.components

    def _psplit(self, p):
        return [p[..., self._poff[i]:self._poff[i + 1]]
                for i in range(len(self.components))]

    def _tsplit(self, X):
        return [X[..., self._toff[i]:self._toff[i + 1]]
                for i in range(len(self.components))]

    def identity(self, device=None):
        return torch.cat([c.identity(device) for c in self.components],
                         dim=-1)

    def exp(self, p, X):
        return torch.cat(
            [c.exp(pp, xx) for c, pp, xx in
             zip(self.components, self._psplit(p), self._tsplit(X))], dim=-1)

    def log(self, p, q):
        return torch.cat(
            [c.log(pp, qq) for c, pp, qq in
             zip(self.components, self._psplit(p), self._psplit(q))], dim=-1)

    def compose(self, p, q):
        return torch.cat(
            [c.compose(pp, qq) for c, pp, qq in
             zip(self.components, self._psplit(p), self._psplit(q))], dim=-1)

    def inverse(self, p):
        return torch.cat(
            [c.inverse(pp) for c, pp in
             zip(self.components, self._psplit(p))], dim=-1)

    def project(self, p):
        return torch.cat(
            [c.project(pp) for c, pp in
             zip(self.components, self._psplit(p))], dim=-1)

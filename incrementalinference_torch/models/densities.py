"""Grid-map densities: heatmap and level-set beliefs.

Counterpart of ``incrementalinference/jl_tpu/models/densities.py``
(reference src/entities/ExtDensities.jl HeatmapGridDensity and
LevelSetGridNormal, ext/HeatmapSampler.jl, and
src/Factors/PartialPriorPassThrough.jl).  Sampling is a categorical draw
over grid cells in proportion to their weight, with uniform jitter inside
the cell.  Grids and weights stay host-side numpy float32, as a
distribution's parameters do; a tensor copy is made once per device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import keys as _keys
from ..distributions import Distribution, _on_device, host32
from .factors import PriorModel, register_factor_model

__all__ = ["HeatmapGridDensity", "LevelSetGridNormal",
           "PartialPriorPassThrough"]


class HeatmapGridDensity(Distribution):
    """Density over R² proportional to a weight grid (an intensity map).

    ``data``: (H, W) weights; ``domain``: (xs (W,), ys (H,)), the cell
    centres.  ``hist_digits`` and ``N`` are the reference's fitting
    parameters, kept for parity."""

    def __init__(self, data, domain: Tuple, hist_digits: int = 5,
                 N: int = 10000):
        self.data = host32(data)
        self.xs = host32(domain[0])
        self.ys = host32(domain[1])
        w = np.maximum(self.data, np.float32(0.0))
        self.weights = (w / np.sum(w)).reshape(-1)
        self.N = N
        self._on: dict = {}

    dim = 2

    def _cell_sizes(self):
        dx = float(self.xs[1] - self.xs[0]) if self.xs.shape[0] > 1 else 1.0
        dy = float(self.ys[1] - self.ys[0]) if self.ys.shape[0] > 1 else 1.0
        return dx, dy

    def _tensors(self, device):
        return _on_device(self._on, device, (self.weights, self.xs, self.ys))

    def sample(self, gen, n):
        w, xs, ys = self._tensors(gen.device)
        idx = torch.multinomial(w, n, replacement=True, generator=gen)
        W = xs.shape[0]
        iy, ix = idx // W, idx % W
        dx, dy = self._cell_sizes()
        jit = torch.rand((n, 2), generator=gen, device=gen.device) - 0.5
        return torch.stack([xs[ix] + jit[:, 0] * dx,
                            ys[iy] + jit[:, 1] * dy], dim=-1)

    def logpdf(self, p):
        """The log weight of the cell ``searchsorted`` (left side, clipped
        to the grid) finds for each point, as in the JAX package."""
        w, xs, ys = self._tensors(p.device)
        ix = torch.searchsorted(xs, p[..., 0].contiguous()).clamp(
            0, xs.shape[0] - 1)
        iy = torch.searchsorted(ys, p[..., 1].contiguous()).clamp(
            0, ys.shape[0] - 1)
        return torch.log(torch.clamp(w[iy * xs.shape[0] + ix], min=1e-30))

    def mean_cov(self):
        """Moments of 1024 draws from a fixed stream (the JAX package draws
        them with PRNGKey(0), which torch cannot reproduce: the two agree in
        distribution)."""
        pts = self.sample(_keys.generator(0, "cpu"), 1024)
        mu = pts.mean(0)
        d = pts - mu
        return mu.numpy(), ((d.T @ d) / pts.shape[0]).numpy()


class LevelSetGridNormal(Distribution):
    """Density concentrated on the ``level`` set of a grid: cell weights in
    proportion to N(level; data, sigma), e.g. a terrain-elevation contour
    likelihood (reference LevelSetGridNormal)."""

    def __init__(self, data, domain: Tuple, level: float, sigma: float,
                 sigma_scale: float = 3.0):
        data = host32(data)
        z = (data - np.float32(level)) / np.float32(sigma)
        w = np.exp(np.float32(-0.5) * z * z)
        self.data = data                  # the raw grid (what convert carries)
        self.level = float(level)
        self.sigma = float(sigma)
        self.heatmap = HeatmapGridDensity(w, domain)

    dim = 2

    def sample(self, gen, n):
        return self.heatmap.sample(gen, n)

    def logpdf(self, p):
        return self.heatmap.logpdf(p)

    def mean_cov(self):
        return self.heatmap.mean_cov()


class PartialPriorPassThrough(PriorModel):
    """Partial prior over a grid density, passed straight to the proposal
    stage without re-convolution (reference PartialPriorPassThrough and the
    calcProposalBelief fast path)."""

    def __init__(self, Z: Distribution, partial: Sequence[int]):
        self.Z = Z
        self.partial = tuple(int(i) for i in partial)

    @property
    def zdim(self):
        return self.Z.dim

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def sample_points(self, gen, n, manifold):
        return self.Z.sample(gen, n)

    def residual(self, meas, x):
        return meas - x[..., list(self.partial)]

    def mean_cov(self):
        return self.Z.mean_cov()


register_factor_model(PartialPriorPassThrough, ("Z",), ("partial",))

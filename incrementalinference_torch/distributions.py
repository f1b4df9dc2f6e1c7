"""Sampleable measurement distributions (the reference's SamplableBelief).

Counterpart of ``incrementalinference/jl_tpu/distributions.py``: Normal,
MvNormal, Uniform, Rayleigh, Categorical, AliasingScalarSampler and the
particle KDE (ManifoldKernelDensity, built by :func:`manikde`).  Parameters
stay host-side numpy float32, as in the JAX package; ``sample`` draws on the
device of the generator it is given and returns ``(n, dim)`` rows;
``mean_cov`` returns host numpy arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def host32(a):
    """A float32 host numpy copy of a tensor (on any device) or an array;
    None stays None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, np.float32)


def _on_device(cache: dict, device, arrays):
    """``arrays`` as tensors on ``device``, made once per device."""
    key = str(device)
    if key not in cache:
        cache[key] = tuple(torch.as_tensor(a, device=device) for a in arrays)
    return cache[key]


def _draw_index(weights: torch.Tensor, gen: torch.Generator,
                n: int) -> torch.Tensor:
    """``n`` indices drawn with replacement in proportion to ``weights``."""
    return torch.multinomial(weights, n, replacement=True, generator=gen)


class Distribution:
    dim: int = 1

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        raise NotImplementedError

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean_cov(self):
        """(mean, covariance) as host numpy arrays."""
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, mu=0.0, sigma=1.0):
        self.mu = np.asarray(mu, np.float32)
        self.sigma = np.asarray(sigma, np.float32)

    dim = 1

    def sample(self, gen, n):
        z = torch.randn((n, 1), generator=gen, device=gen.device)
        return float(self.mu) + float(self.sigma) * z

    def logpdf(self, x):
        z = (x[..., 0] - float(self.mu)) / float(self.sigma)
        return (-0.5 * z * z - float(np.log(self.sigma))
                - 0.5 * math.log(2 * math.pi))

    def mean_cov(self):
        return (np.reshape(self.mu, (1,)),
                np.reshape(self.sigma ** 2, (1, 1)))


class MvNormal(Distribution):
    def __init__(self, mu, cov):
        self.mu = np.atleast_1d(np.asarray(mu, np.float32))
        cov = np.asarray(cov, np.float32)
        if cov.ndim == 1:          # diagonal std-vector convenience
            cov = np.diag(cov ** 2)
        self.cov = cov
        self._chol = np.linalg.cholesky(cov.astype(np.float64)).astype(
            np.float32)
        self._on: dict = {}        # device -> (mu, cov, chol) tensors

    @property
    def dim(self):
        return self.mu.shape[-1]

    def _tensors(self, device):
        return _on_device(self._on, device, (self.mu, self.cov, self._chol))

    def sample(self, gen, n):
        mu, _, L = self._tensors(gen.device)
        z = torch.randn((n, self.dim), generator=gen, device=gen.device)
        return mu + z @ L.T

    def logpdf(self, x):
        mu, cov, _ = self._tensors(x.device)
        d = x - mu
        sol = torch.linalg.solve(cov, d.unsqueeze(-1)).squeeze(-1)
        _, logdet = torch.linalg.slogdet(cov)
        k = self.dim
        return -0.5 * (torch.sum(d * sol, -1) + logdet
                       + k * math.log(2 * math.pi))

    def mean_cov(self):
        return self.mu, self.cov


class Uniform(Distribution):
    def __init__(self, a=0.0, b=1.0):
        self.a = np.asarray(a, np.float32)
        self.b = np.asarray(b, np.float32)

    dim = 1

    def sample(self, gen, n):
        u = torch.rand((n, 1), generator=gen, device=gen.device)
        return float(self.a) + float(self.b - self.a) * u

    def logpdf(self, x):
        r = x[..., 0]
        inside = (r >= float(self.a)) & (r <= float(self.b))
        return torch.where(inside, -math.log(float(self.b - self.a)),
                           -math.inf)

    def mean_cov(self):
        return (np.reshape(0.5 * (self.a + self.b), (1,)),
                np.reshape((self.b - self.a) ** 2 / 12.0, (1, 1)))


class Rayleigh(Distribution):
    def __init__(self, sigma=1.0):
        self.sigma = np.asarray(sigma, np.float32)

    dim = 1

    def sample(self, gen, n):
        u = torch.rand((n, 1), generator=gen, device=gen.device)
        u = 1e-7 + (1.0 - 1e-7) * u
        return float(self.sigma) * torch.sqrt(-2.0 * torch.log(u))

    def logpdf(self, x):
        r = x[..., 0]
        s = float(self.sigma)
        return torch.where(
            r >= 0,
            torch.log(torch.clamp(r, min=1e-30)) - 2 * math.log(s)
            - r * r / (2 * s * s),
            -math.inf)

    def mean_cov(self):
        m = self.sigma * np.sqrt(np.pi / 2.0)
        v = (2.0 - np.pi / 2.0) * self.sigma ** 2
        return (np.reshape(m, (1,)).astype(np.float32),
                np.reshape(v, (1, 1)).astype(np.float32))


class Categorical(Distribution):
    """Discrete distribution over {0..k-1} (hypothesis selection)."""

    def __init__(self, p):
        self.p = np.asarray(p, np.float32)
        self._on: dict = {}

    dim = 1

    def sample(self, gen, n):
        (p,) = _on_device(self._on, gen.device, (self.p,))
        return _draw_index(p, gen, n)[:, None].to(torch.float32)

    def logpdf(self, x):
        (p,) = _on_device(self._on, x.device, (self.p,))
        return torch.log(torch.clamp(p[x[..., 0].to(torch.int64)],
                                     min=1e-30))

    def mean_cov(self):
        idx = np.arange(self.p.shape[0], dtype=np.float32)
        m = np.sum(self.p * idx)
        v = np.sum(self.p * (idx - m) ** 2)
        return np.reshape(m, (1,)), np.reshape(v, (1, 1))


class AliasingScalarSampler(Distribution):
    """Weighted-grid 1-D sampler for intensity maps (reference
    AliasScalarSampling.jl).  Weights below ``quantile(weights, snr_floor)``
    are zeroed before normalisation."""

    def __init__(self, x, weights, snr_floor: float = 0.0):
        x = np.asarray(x, np.float32)
        w = np.asarray(weights, np.float32)
        if snr_floor > 0:
            w = np.where(w >= np.quantile(w, snr_floor), w, 0.0)
        self.x = x
        self.weights = (w / np.sum(w)).astype(np.float32)
        self._on: dict = {}

    dim = 1

    def sample(self, gen, n):
        x, w = _on_device(self._on, gen.device, (self.x, self.weights))
        return x[_draw_index(w, gen, n)][:, None]

    def logpdf(self, x):
        grid, w = _on_device(self._on, x.device, (self.x, self.weights))
        i = torch.argmin(torch.abs(grid - x[..., :1]), dim=-1)  # nearest bin
        return torch.log(torch.clamp(w[i], min=1e-30))

    def mean_cov(self):
        m = np.sum(self.weights * self.x)
        v = np.sum(self.weights * (self.x - m) ** 2)
        return np.reshape(m, (1,)), np.reshape(v, (1, 1))


class ManifoldKernelDensity(Distribution):
    """A particle KDE usable anywhere a measurement distribution goes: a
    Prior's density, a mixture component, a relative measurement (the user
    side of the reference's ``manikde``).

    ``manifold`` must be a coordinate manifold (point_dim == dof), since
    measurement samples are coordinate rows.  As in the JAX package,
    ``belief`` is the KDE's :class:`~.beliefs.Belief`, made once, its
    bandwidth LOO-selected when ``bw`` is omitted: on the
    device of the points it was given (host numpy points make a CPU belief).
    ``points`` and ``bw`` are the belief's tensors.  Draws and densities on
    another device use a copy of that belief there (:meth:`belief_on`)."""

    def __init__(self, manifold, points, bw=None):
        from .beliefs import make_belief
        if manifold.point_dim != manifold.dof:
            raise ValueError("manikde measurement densities need a "
                             "coordinate manifold (point_dim == dof)")
        self.manifold = manifold
        if hasattr(points, "points"):          # already a Belief
            self.belief = points
        else:
            pts = (points.to(torch.float32)
                   if isinstance(points, torch.Tensor)
                   else torch.as_tensor(np.asarray(points, np.float32)))
            if pts.ndim == 1:
                pts = pts[:, None]
            self.belief = make_belief(
                manifold, pts, bw=None if bw is None
                else torch.as_tensor(host32(bw), device=pts.device))
        self._on: dict = {str(self.belief.points.device): self.belief}

    @property
    def dim(self):
        return self.manifold.dof

    @property
    def points(self) -> torch.Tensor:
        return self.belief.points

    @property
    def bw(self) -> torch.Tensor:
        return self.belief.bw

    def belief_on(self, device):
        """:attr:`belief` on ``device``: the same points and bandwidth,
        copied there once."""
        key = str(torch.device(device))
        if key not in self._on:
            b = self.belief
            self._on[key] = type(b)(points=b.points.to(device),
                                    bw=b.bw.to(device), ipc=b.ipc.to(device))
        return self._on[key]

    def sample(self, gen, n):
        from .beliefs import kde_sample
        return kde_sample(self.manifold, self.belief_on(gen.device), gen, n)

    def logpdf(self, x):
        from .beliefs import kde_logpdf
        return kde_logpdf(self.manifold, self.belief_on(x.device), x)

    def mean_cov(self):
        from .beliefs import mean_cov
        mu, cov = mean_cov(self.manifold, self.belief.points)
        return mu.cpu().numpy(), cov.cpu().numpy()


def manikde(vartype_or_manifold, points, bw=None) -> ManifoldKernelDensity:
    """Build a KDE density from points (reference manikde!).  Accepts a
    VariableType (ContinuousScalar, ...) or a Manifold."""
    manifold = getattr(vartype_or_manifold, "manifold", vartype_or_manifold)
    return ManifoldKernelDensity(manifold, points, bw=bw)

"""Sampleable measurement distributions (Normal and MvNormal).

Counterpart of ``incrementalinference/jl_tpu/distributions.py``.  Parameters
stay host-side numpy float32, as in the JAX package; ``sample`` draws on the
device of the generator it is given and returns ``(n, dim)`` rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(torch.as_tensor(a, device=device)
                                  for a in (self.mu, self.cov, self._chol))
        return self._on[key]

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

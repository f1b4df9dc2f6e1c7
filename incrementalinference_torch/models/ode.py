"""ODE-propagation relative factors.

Counterpart of ``incrementalinference/jl_tpu/models/ode.py`` (reference
ext/IncrInfrDiffEqFactorExt.jl DERelative): an n-ary factor whose
prediction integrates user dynamics ẋ = f(t, x, *params) from the first
variable's epoch to the second's, with additive process noise.  Forcing
enters as a static ``data`` payload handed to ``f`` on every call, and any
variables beyond the first two are spliced into ``f``'s parameters per
evaluation.

The residual differentiates through the fixed-step RK4 flow
(``torch.func.jacrev`` in the convolution), so one forward residual solves
any variable: x1 (the forward prediction), x0 (the reference's backward
problem) or a parameter variable.  The backward flow map is still exposed
(:meth:`DERelative.flow` with ``backward=True``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..distributions import Distribution, MvNormal, host32
from .factors import FactorModel, register_factor_model

__all__ = ["DERelative", "rk4_integrate"]


def rk4_integrate(f: Callable, x0: torch.Tensor, t0: float, t1: float,
                  steps: int = 16, *params) -> torch.Tensor:
    """Fixed-step RK4 from t0 to t1; ``f(t, x, *params)``.  Integrates
    backward when t1 < t0.  ``t`` reaches ``f`` as a Python float (the JAX
    package's is a float32 scan value), so an ``f`` that looks ``data`` up
    by ``t`` stays outside ``vmap``'s batching."""
    h = (t1 - t0) / steps
    x = x0
    for i in range(steps):
        t = t0 + i * h
        # scaled sums as ``add(..., alpha=)``: under torch.func's
        # transforms a product with a constant costs more host time than
        # an alpha (a third of a Jacobian pass)
        k1 = f(t, x, *params)
        k2 = f(t + 0.5 * h, torch.add(x, k1, alpha=0.5 * h), *params)
        k3 = f(t + 0.5 * h, torch.add(x, k2, alpha=0.5 * h), *params)
        k4 = f(t + h, torch.add(x, k3, alpha=h), *params)
        s = torch.add(k1 + k4, k2 + k3, alpha=2.0)
        x = torch.add(x, s, alpha=h / 6.0)
    return x


def _tree_map(fn, data):
    """``fn`` on every array leaf of ``data`` (a tuple, list or dict of
    arrays, or one array)."""
    if isinstance(data, (tuple, list)):
        return type(data)(_tree_map(fn, d) for d in data)
    if isinstance(data, dict):
        return {k: _tree_map(fn, v) for k, v in data.items()}
    return fn(data)


class DERelative(FactorModel):
    """x1 = Φ(x0) + z, Φ the RK4 flow of ``f`` over [t0, t1] with
    ``params = (data,) + extra_points`` (``data`` only when given, the
    extra points those of the variables beyond the first two).

    residual(z, x0, x1, *extra) = (Φ(x0; params) + z) − x1.  ``data`` stays
    host-side numpy float32 and reaches ``f`` as a tensor on the residual's
    device (copied there once)."""

    def __init__(self, f: Callable, t0: float, t1: float,
                 Z: Optional[Distribution] = None, dim: int = 1,
                 steps: int = 16, data: Any = None):
        self.f = f
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.Z = Z or MvNormal([0.0] * dim, [1e-2] * dim)
        self.steps = int(steps)
        self.data = None if data is None else _tree_map(host32, data)
        self._on: dict = {}

    @property
    def zdim(self):
        return self.Z.dim

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def _params(self, extra, device):
        if self.data is None:
            return tuple(extra)
        key = str(device)
        if key not in self._on:
            self._on[key] = _tree_map(
                lambda a: torch.as_tensor(a, device=device), self.data)
        return (self._on[key],) + tuple(extra)

    def flow(self, x, *extra, backward: bool = False) -> torch.Tensor:
        """One point through the dynamics: Φ_{t0→t1}(x), or the reference's
        backward problem Φ_{t1→t0}(x) when ``backward``."""
        t0, t1 = (self.t1, self.t0) if backward else (self.t0, self.t1)
        return rk4_integrate(self.f, x, t0, t1, self.steps,
                             *self._params(extra, x.device))

    def residual(self, meas, x0, x1, *extra):
        pred = rk4_integrate(self.f, x0, self.t0, self.t1, self.steps,
                             *self._params(extra, x0.device))
        return (pred + meas) - x1

    def mean_cov(self):
        return self.Z.mean_cov()


# ``f`` is Python code and travels apart from these fields (convert.py)
register_factor_model(DERelative, ("Z", "t0", "t1", "steps", "data"))

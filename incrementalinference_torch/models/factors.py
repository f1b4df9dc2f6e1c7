"""Factor models of the nonparametric main path.

Counterpart of ``incrementalinference/jl_tpu/models/factors.py`` for Prior,
LinearRelative, MsgPrior, MetaPrior and GenericMarginal (the other models
come with later slices).  A model exposes:

- ``sample(gen, n)``: n measurement rows ``(n, zdim)`` drawn with ``gen``;
- ``residual(meas, *points)``: the residual, written with broadcasting
  tensor ops so the convolution can evaluate and differentiate it per
  particle (``torch.func``);
- priors additionally ``sample_points(gen, n, manifold)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..beliefs import Belief, kde_sample, mean_cov as belief_mean_cov
from ..distributions import Distribution
from ..manifolds import Manifold

__all__ = ["FactorModel", "PriorModel", "Prior", "LinearRelative",
           "MsgPrior", "MetaPrior", "GenericMarginal", "MODEL_REGISTRY",
           "register_factor_model"]


class FactorModel:
    is_prior: bool = False
    # tangent dims of the solve target constrained by this factor, or None
    partial: Optional[Tuple[int, ...]] = None

    @property
    def zdim(self) -> int:
        raise NotImplementedError

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        raise NotImplementedError

    def residual(self, meas: torch.Tensor, *points: torch.Tensor):
        raise NotImplementedError

    def mean_cov(self):
        raise NotImplementedError


class PriorModel(FactorModel):
    is_prior = True

    def sample_points(self, gen, n: int, manifold: Manifold) -> torch.Tensor:
        raise NotImplementedError


class Prior(PriorModel):
    """Full-dim prior z ⊖ x (reference src/Factors/DefaultPrior.jl)."""

    def __init__(self, Z: Distribution):
        self.Z = Z

    @property
    def zdim(self):
        return self.Z.dim

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def sample_points(self, gen, n, manifold):
        return self.Z.sample(gen, n)

    def residual(self, meas, x):
        return meas - x

    def mean_cov(self):
        return self.Z.mean_cov()


class LinearRelative(FactorModel):
    """x2 = x1 + z (reference src/Factors/LinearRelative.jl)."""

    # the residual is affine in the solve tangent: one Gauss-Newton step
    # from any start is exact (convolve.batched_gauss_newton linear branch)
    linear_residual = True

    def __init__(self, Z: Distribution):
        self.Z = Z

    @property
    def zdim(self):
        return self.Z.dim

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, x1, x2):
        return meas - (x2 - x1)

    def mean_cov(self):
        return self.Z.mean_cov()


class MsgPrior(PriorModel):
    """Prior carrying a KDE tree message (reference src/Factors/MsgPrior.jl)."""

    def __init__(self, belief: Belief, manifold: Manifold,
                 ipc: torch.Tensor | None = None):
        self.belief = belief
        self.manifold = manifold
        self.ipc = belief.ipc if ipc is None else ipc

    @property
    def zdim(self):
        return self.manifold.dof

    def sample(self, gen, n):
        return kde_sample(self.manifold, self.belief, gen, n)

    def sample_points(self, gen, n, manifold):
        return kde_sample(manifold, self.belief, gen, n)

    def residual(self, meas, x):
        return self.manifold.log(x, meas)

    def mean_cov(self):
        return belief_mean_cov(self.manifold, self.belief.points)


class MetaPrior(PriorModel):
    """Data-only factor, skipped by every solver (reference MetaPrior.jl)."""

    def __init__(self, data=None):
        self.data = data

    zdim = 0

    def sample(self, gen, n):
        return torch.zeros((n, 0), device=gen.device)

    def sample_points(self, gen, n, manifold):
        raise RuntimeError("MetaPrior carries no belief")

    def residual(self, meas, x):
        return torch.zeros((0,), device=x.device)


class GenericMarginal(FactorModel):
    """Chain-rule placeholder inserted during elimination only
    (reference GenericMarginal.jl)."""

    zdim = 0

    def sample(self, gen, n):
        return torch.zeros((n, 0), device=gen.device)

    def residual(self, meas, *points):
        return torch.zeros((0,), device=meas.device)


#: factor type name -> (class, parameter fields): the serialization and
#: convert.py look-up, as the JAX package's MODEL_REGISTRY
MODEL_REGISTRY: dict = {}


def register_factor_model(cls, children: tuple = ("Z",)):
    """Register a user-defined :class:`FactorModel` subclass by name."""
    MODEL_REGISTRY[cls.__name__] = (cls, tuple(children))
    return cls


register_factor_model(Prior, ("Z",))
register_factor_model(LinearRelative, ("Z",))
register_factor_model(MsgPrior, ("belief", "ipc"))
register_factor_model(MetaPrior, ())
register_factor_model(GenericMarginal, ())

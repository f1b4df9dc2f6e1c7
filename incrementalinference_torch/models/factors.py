"""Factor models of the nonparametric solve.

Counterpart of ``incrementalinference/jl_tpu/models/factors.py``: Prior,
LinearRelative, EuclidDistance, the circular pair, Mixture, PartialPrior,
MsgPrior, MetaPrior, GenericMarginal, the on-manifold ManifoldFactor and
ManifoldPrior, MsgRelativeLikelihood, and GaussianJoint (the parametric
tree message).  A model exposes:

- ``sample(gen, n)``: n measurement rows ``(n, zdim)`` drawn with ``gen``;
- ``residual(meas, *points)``: the residual, written with broadcasting
  tensor ops so the convolution can evaluate and differentiate it per
  particle (``torch.func``);
- priors additionally ``sample_points(gen, n, manifold)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import keys as _keys
from ..beliefs import Belief, kde_sample, mean_cov as belief_mean_cov
from ..distributions import Distribution
from ..manifolds import Euclidean, Manifold, wrap_angle

__all__ = ["FactorModel", "PriorModel", "Prior", "LinearRelative",
           "EuclidDistance", "PriorCircular", "CircularCircular", "Mixture",
           "PartialPrior", "MsgPrior", "MetaPrior", "GenericMarginal",
           "ManifoldFactor", "ManifoldPrior", "MsgRelativeLikelihood",
           "GaussianJoint", "MODEL_REGISTRY", "register_factor_model"]


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


class EuclidDistance(FactorModel):
    """Range factor z - |x2 - x1| (reference src/Factors/EuclidDistance.jl):
    a 1-D measurement over endpoints of any dimension, so ring-shaped and
    multimodal posteriors."""

    def __init__(self, Z: Distribution):
        self.Z = Z

    zdim = 1

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, x1, x2):
        d = x2 - x1
        return meas - torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)
                                 + 1e-12)

    def mean_cov(self):
        return self.Z.mean_cov()


class PriorCircular(PriorModel):
    """Prior on an angle (reference src/Factors/Circular.jl)."""

    def __init__(self, Z: Distribution):
        self.Z = Z

    zdim = 1

    def sample(self, gen, n):
        return wrap_angle(self.Z.sample(gen, n))

    def sample_points(self, gen, n, manifold):
        return wrap_angle(self.Z.sample(gen, n))

    def residual(self, meas, x):
        return wrap_angle(meas - x)

    def mean_cov(self):
        return self.Z.mean_cov()


class CircularCircular(FactorModel):
    """Angle difference x2 ⊖ x1 = z on the circle (reference Circular.jl)."""

    linear_residual = True

    def __init__(self, Z: Distribution):
        self.Z = Z

    zdim = 1

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, x1, x2):
        return wrap_angle(meas - wrap_angle(x2 - x1))

    def mean_cov(self):
        return self.Z.mean_cov()


class Mixture(FactorModel):
    """Mixture over any prior or relative (reference src/Factors/Mixture.jl):
    a categorical label per sample chooses the component that generates
    that measurement row; the residual is the mechanics'."""

    def __init__(self, mechanics, components: Sequence[Distribution],
                 diversity: Sequence[float] | None = None):
        """``mechanics``: a FactorModel class (Prior, LinearRelative, ...)
        or instance whose residual is reused; ``components``: the
        measurement distribution of each mode; ``diversity``: the mode
        weights (uniform when omitted)."""
        if isinstance(mechanics, type):
            mechanics = mechanics(components[0])
        self.mechanics = mechanics
        self.components = tuple(components)
        w = (np.full((len(components),), 1.0 / len(components), np.float32)
             if diversity is None else np.asarray(diversity, np.float32))
        self.diversity = w / np.sum(w)
        self.labels = None          # component labels of the last draw
        self._on: dict = {}         # device -> diversity tensor

    @property
    def is_prior(self):
        return self.mechanics.is_prior

    @property
    def linear_residual(self):
        return getattr(self.mechanics, "linear_residual", False)

    @property
    def zdim(self):
        return self.components[0].dim

    @staticmethod
    def select(draws: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Row i of component ``labels[i]``: draws (C, n, z) -> (n, z)."""
        return draws[labels, torch.arange(labels.shape[0],
                                          device=labels.device)]

    def sample(self, gen, n):
        """The label generator and one generator per component are derived
        from ``gen`` in that order (keys.spawn)."""
        g_lab, *g_comp = _keys.spawn(gen, 1 + len(self.components))
        key = str(gen.device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.diversity,
                                            device=gen.device)
        labels = torch.multinomial(self._on[key], n, replacement=True,
                                   generator=g_lab)
        draws = torch.stack([c.sample(g, n)
                             for c, g in zip(self.components, g_comp)])
        self.labels = labels
        return self.select(draws, labels)

    def sample_points(self, gen, n, manifold):
        meas = self.sample(gen, n)
        if hasattr(self.mechanics, "meas_to_points"):
            return self.mechanics.meas_to_points(meas, manifold)
        return meas

    def residual(self, meas, *points):
        return self.mechanics.residual(meas, *points)

    def mixture_mean_cov(self):
        """Per-component (weights, means, covariances), host numpy."""
        mus, covs = zip(*(c.mean_cov() for c in self.components))
        return (self.diversity, np.stack([np.asarray(m) for m in mus]),
                np.stack([np.asarray(c) for c in covs]))

    def mean_cov(self):
        """The moment-matched Gaussian."""
        w, mus, covs = self.mixture_mean_cov()
        m = np.sum(w[:, None] * mus, axis=0)
        d = mus - m
        cov = np.sum(w[:, None, None]
                     * (covs + d[:, :, None] * d[:, None, :]), axis=0)
        return m, cov


class PartialPrior(PriorModel):
    """Prior constraining a subset of tangent dims (reference
    src/Factors/PartialPrior.jl)."""

    def __init__(self, Z: Distribution, partial: Sequence[int]):
        self.Z = Z
        self.partial = tuple(int(i) for i in partial)

    @property
    def zdim(self):
        return self.Z.dim

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def sample_points(self, gen, n, manifold):
        # the caller overlays the sampled sub-dims onto existing points
        return self.Z.sample(gen, n)

    def residual(self, meas, x):
        return meas - x[..., list(self.partial)]

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


class ManifoldFactor(FactorModel):
    """Relative factor on a group manifold: the measurement is a tangent
    vector, residual = log(p1⁻¹∘p2) - z (reference GenericFunctions.jl)."""

    # log-residuals are near-linear in the solve tangent: Newton converges
    # in a handful of steps (make_conv_spec gives them 8 iterations)
    quasi_linear_residual = True

    def __init__(self, manifold: Manifold, Z: Distribution):
        self.manifold = manifold
        self.Z = Z

    @property
    def zdim(self):
        return self.manifold.dof

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, p1, p2):
        return self.manifold.log(p1, p2) - meas

    def mean_cov(self):
        return self.Z.mean_cov()


class ManifoldPrior(PriorModel):
    """Prior at point p0 with tangent noise Z (reference
    GenericFunctions.jl).  ``p0`` stays host-side numpy, like a
    distribution's parameters; a tensor copy is made once per device."""

    quasi_linear_residual = True

    def __init__(self, manifold: Manifold, p0, Z: Distribution):
        self.manifold = manifold
        if isinstance(p0, torch.Tensor):
            p0 = p0.detach().cpu().numpy()
        self.p0 = np.asarray(p0, np.float32)
        self.Z = Z
        self._on: dict = {}         # device -> p0 tensor

    @property
    def zdim(self):
        return self.manifold.dof

    def _p0_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.p0, device=device)
        return self._on[key]

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def meas_to_points(self, meas, manifold):
        p0 = self._p0_on(meas.device)
        return manifold.exp(p0.expand((meas.shape[0],) + p0.shape), meas)

    def sample_points(self, gen, n, manifold):
        return self.meas_to_points(self.Z.sample(gen, n), manifold)

    def residual(self, meas, x):
        return self.residual_with(self.residual_params(meas.device), meas, x)

    def residual_params(self, device) -> tuple:
        """The tensors the residual reads from the model, which a
        parametric factor group stacks across its factors."""
        return (self._p0_on(device),)

    def residual_with(self, params, meas, x):
        """The residual at the point ``params[0]`` in place of ``p0``."""
        target = self.manifold.exp(params[0], meas)
        return self.manifold.log(x, target)

    def mean_cov(self):
        return self.Z.mean_cov()


class MsgRelativeLikelihood(FactorModel):
    """Relative likelihood carried inside a joint up-message: the measured
    quantity is the tangent difference log(x1⁻¹∘x2), with a particle belief
    over it obtained by deconvolving the solved child clique (reference
    addLikelihoodsDifferentialCHILD!, the ``useMsgLikelihoods`` path)."""

    def __init__(self, belief: Belief, manifold: Manifold):
        self.belief = belief        # Belief over tangent differences
        self.manifold = manifold

    @property
    def zdim(self):
        return self.manifold.dof

    def sample(self, gen, n):
        # differences live in a Euclidean chart of the tangent space
        return kde_sample(Euclidean(self.manifold.dof), self.belief, gen, n)

    def residual(self, meas, p1, p2):
        return self.manifold.log(p1, p2) - meas

    def mean_cov(self):
        return belief_mean_cov(Euclidean(self.manifold.dof),
                               self.belief.points)


class GaussianJoint(FactorModel):
    """Joint Gaussian prior over several variables: the parametric tree
    message (reference LikelihoodMessage.cliqueLikelihood::MvNormal carried
    by the parametric CSM, ParametricCSMFunctions.jl:8-97, and
    calculateCoBeliefMessage, ParametricUtils.jl:744-796).

    residual = concat_v log(p0_v, x_v) - z, with the joint covariance
    ``cov`` over the stacked tangent dims and mean zero."""

    def __init__(self, manifolds, p0s, cov):
        self.manifolds = tuple(manifolds)
        self.p0s = tuple(torch.as_tensor(p, dtype=torch.float32)
                         for p in p0s)
        self.cov = torch.as_tensor(cov, dtype=torch.float32)

    @property
    def zdim(self):
        return sum(m.dof for m in self.manifolds)

    def sample(self, gen, n):
        eye = torch.eye(self.zdim, device=self.cov.device)
        L = torch.linalg.cholesky(self.cov + 1e-9 * eye).to(gen.device)
        return torch.randn((n, self.zdim), generator=gen,
                           device=gen.device) @ L.T

    def residual(self, meas, *points):
        return self.residual_with(self.residual_params(meas.device), meas,
                                  *points)

    def residual_params(self, device) -> tuple:
        """The tensors the residual reads from the model."""
        return tuple(p.to(device) for p in self.p0s)

    def residual_with(self, params, meas, *points):
        """The residual at the points ``params`` in place of ``p0s``."""
        logs = [m.log(p0, x) for m, p0, x in
                zip(self.manifolds, params, points)]
        return torch.cat(logs, dim=-1) - meas

    def mean_cov(self):
        return torch.zeros((self.zdim,), device=self.cov.device), self.cov


#: factor type name -> (class, children, aux): the parameter fields of each
#: factor type, read by the packed serialization (serialization/packed.py)
#: and by convert.py, as the JAX package's MODEL_REGISTRY.  There,
#: ``children`` are traced array fields and ``aux`` static structure (a
#: manifold, dims); the port keeps the same split so that a custom model
#: packs to the same document in both packages.
MODEL_REGISTRY: dict = {}


def register_factor_model(cls, children: tuple = ("Z",), aux: tuple = ()):
    """Register a user-defined :class:`FactorModel` subclass by name, so
    that it round-trips through ``save_graph``/``load_graph``: its
    ``children`` (arrays, distributions, beliefs) and ``aux`` (static
    structure) fields are packed by name."""
    MODEL_REGISTRY[cls.__name__] = (cls, tuple(children), tuple(aux))
    return cls


register_factor_model(Prior, ("Z",))
register_factor_model(LinearRelative, ("Z",))
register_factor_model(EuclidDistance, ("Z",))
register_factor_model(PriorCircular, ("Z",))
register_factor_model(CircularCircular, ("Z",))
register_factor_model(Mixture, ("mechanics", "components", "diversity"))
register_factor_model(PartialPrior, ("Z",), ("partial",))
register_factor_model(MsgPrior, ("belief", "ipc"), ("manifold",))
register_factor_model(MetaPrior, (), ("data",))
register_factor_model(GenericMarginal, ())
register_factor_model(ManifoldFactor, ("Z",), ("manifold",))
register_factor_model(ManifoldPrior, ("p0", "Z"), ("manifold",))
register_factor_model(MsgRelativeLikelihood, ("belief",), ("manifold",))
register_factor_model(GaussianJoint, ("p0s", "cov"), ("manifolds",))

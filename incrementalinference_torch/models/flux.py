"""Neural-network-ensemble measurement models.

Counterpart of ``incrementalinference/jl_tpu/models/flux.py`` (reference
ext/IncrInfrFluxFactorsExt.jl FluxModelsDistribution, MixtureFluxModels).
An ensemble is one network function with stacked parameters (a leading
ensemble axis on every tensor); ``torch.func.vmap`` over that axis runs all
members at once, and a draw picks a member per sample.

Layouts: a dense weight is (E, out, in), as in the JAX package; a conv
weight is torch's (E, out, in, k, k), where the JAX package's is HWIO
(E, k, k, in, out) (``convert.ensemble_params_from`` converts).  Images
stay (H, W, C) as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap

from ..distributions import Distribution
from .factors import Mixture

__all__ = ["FluxModelsDistribution", "MixtureFluxModels", "SequentialNet",
           "mlp_init", "mlp_apply", "nn_init"]


def _dense_init(gen, n_models, a, b):
    dev = gen.device
    return (torch.randn((n_models, b, a), generator=gen, device=dev)
            / math.sqrt(a),
            0.01 * torch.randn((n_models, b), generator=gen, device=dev))


def mlp_init(gen: torch.Generator, sizes: Sequence[int], n_models: int = 1):
    """Stacked-ensemble MLP parameters, drawn on ``gen``'s device: a list
    of (W (E, out, in), b (E, out))."""
    return [_dense_init(gen, n_models, a, b)
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params, x):
    """One MLP (a single member of the stack): x (in,) -> (out,)."""
    for i, (W, b) in enumerate(params):
        x = W @ x + b
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def _conv_same(x, W, b):
    """SAME-padded stride-1 conv of an (H, W, C) image with an
    (out, in, k, k) weight: XLA's SAME puts the odd pixel of an even ``k``
    at the high end."""
    k = W.shape[-1]
    lo = (k - 1) // 2
    y = F.pad(x.permute(2, 0, 1)[None], (lo, k - 1 - lo, lo, k - 1 - lo))
    return F.conv2d(y, W)[0].permute(1, 2, 0) + b


def _pool(x, kind, k):
    """k×k stride-k VALID pooling of an (H, W, C) image."""
    y = x.permute(2, 0, 1)[None]
    y = (F.max_pool2d(y, k, stride=k) if kind == "maxpool2d"
         else F.avg_pool2d(y, k, stride=k))
    return y[0].permute(1, 2, 0)


class SequentialNet:
    """A sequential network from a declarative layer spec (the general
    analogue of the reference's serialized Flux chains).

    ``spec`` is a tuple of layer descriptors:

    - ``("dense", in, out)``: affine layer on 1-D activations
    - ``("conv2d", cin, cout, k)``: SAME-padded k×k conv on (H, W, C)
    - ``("maxpool2d", k)`` / ``("avgpool2d", k)``: k×k stride-k pooling
    - ``("flatten",)``: reshape to 1-D (row-major over H, W, C)
    - ``("relu",)`` ``("tanh",)`` ``("sigmoid",)`` ``("softmax",)``

    Instances hash and compare by spec."""

    _PARAM_LAYERS = ("dense", "conv2d")

    def __init__(self, spec: Sequence[Sequence]):
        self.spec = tuple(tuple(layer) for layer in spec)

    def __call__(self, params, x):
        i = 0
        for layer in self.spec:
            kind = layer[0]
            if kind in self._PARAM_LAYERS:
                W, b = params[i]
                i += 1
                x = W @ x + b if kind == "dense" else _conv_same(x, W, b)
            elif kind in ("maxpool2d", "avgpool2d"):
                x = _pool(x, kind, int(layer[1]))
            elif kind == "flatten":
                x = x.reshape(-1)
            elif kind == "relu":
                x = torch.relu(x)
            elif kind == "tanh":
                x = torch.tanh(x)
            elif kind == "sigmoid":
                x = torch.sigmoid(x)
            elif kind == "softmax":
                x = torch.softmax(x, dim=-1)
            else:
                raise ValueError(f"unknown layer kind {kind!r}")
        return x

    def __hash__(self):
        return hash(self.spec)

    def __eq__(self, other):
        return isinstance(other, SequentialNet) and self.spec == other.spec

    def __repr__(self):
        return f"SequentialNet({list(self.spec)})"


def nn_init(gen: torch.Generator, spec, n_models: int = 1):
    """Stacked-ensemble parameters for a :class:`SequentialNet` spec, drawn
    on ``gen``'s device: one (W, b) per parameterized layer."""
    params = []
    dev = gen.device
    for layer in spec:
        if layer[0] == "dense":
            _, a, b = layer
            params.append(_dense_init(gen, n_models, a, b))
        elif layer[0] == "conv2d":
            _, cin, cout, k = layer
            params.append((torch.randn((n_models, cout, cin, k, k),
                                       generator=gen, device=dev)
                           / math.sqrt(k * k * cin),
                           0.01 * torch.randn((n_models, cout), generator=gen,
                                              device=dev)))
    return params


def _float32(a) -> torch.Tensor:
    """A float32 tensor of ``a``, on the device of a tensor; arrays are
    copied."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32)
    return torch.tensor(np.asarray(a, np.float32))


class FluxModelsDistribution(Distribution):
    """Ensemble-of-networks distribution: a draw picks one member and runs
    it on ``data`` (reference FluxModelsDistribution fields models,
    outputDim, data, shuffle).  ``params`` and ``data`` are copied once to
    each device a draw or a density is asked for on."""

    def __init__(self, apply_fn: Callable, params, data, out_dim: int,
                 shuffle: bool = True):
        self.apply_fn = apply_fn    # (one member's params, data) -> (out,)
        self.params = [tuple(_float32(t) for t in layer) for layer in params]
        self.data = _float32(data).cpu()
        self.out_dim = int(out_dim)
        self.shuffle = shuffle
        self._on: dict = {}

    @property
    def dim(self):
        return self.out_dim

    def _n_models(self) -> int:
        return self.params[0][0].shape[0]

    def _on_device(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = ([tuple(t.to(device) for t in layer)
                              for layer in self.params],
                             self.data.to(device))
        return self._on[key]

    def all_outputs(self, device) -> torch.Tensor:
        """Every member's output on ``data``: (E, out)."""
        params, data = self._on_device(device)
        return vmap(lambda p: self.apply_fn(p, data))(params)

    def sample(self, gen, n):
        outs = self.all_outputs(gen.device)
        e = self._n_models()
        if self.shuffle:
            idx = torch.randint(0, e, (n,), generator=gen, device=gen.device)
        else:
            idx = torch.arange(n, device=gen.device) % e
        return outs[idx]

    def logpdf(self, x):
        outs = self.all_outputs(x.device)
        d = x[..., None, :] - outs
        s2 = torch.clamp(torch.var(outs, dim=0, correction=0).mean(),
                         min=1e-6)
        logk = -0.5 * torch.sum(d * d, dim=-1) / s2
        return torch.logsumexp(logk, dim=-1) - math.log(float(outs.shape[0]))

    def mean_cov(self):
        outs = self.all_outputs("cpu")
        mu = outs.mean(0)
        d = outs - mu
        cov = (d.T @ d) / max(outs.shape[0] - 1, 1) + \
            1e-6 * torch.eye(self.out_dim)
        return mu.numpy(), cov.numpy()


def MixtureFluxModels(mechanics, flux_dist: FluxModelsDistribution,
                      other_components: Sequence[Distribution],
                      diversity: Sequence[float]) -> Mixture:
    """A network-ensemble component mixed with analytic ones (reference
    MixtureFluxModels)."""
    return Mixture(mechanics, [flux_dist, *other_components], diversity)

"""Belief products at variables — propagate / local product.

Counterpart of ``incrementalinference/jl_tpu/ops/graphops.py`` (reference
propagateBelief, localProduct, localProductAndUpdate!).
"""

from __future__ import annotations

import functools
from typing import Iterable, Sequence, Tuple

import torch

from ..beliefs import Belief, make_belief
from ..models.factors import GenericMarginal, MetaPrior

__all__ = ["propagate_belief", "local_product", "local_product_and_update",
           "prepare_update", "UpdatePlan"]


@functools.lru_cache(maxsize=4096)
def _ipc_tuple(masks) -> Tuple[float, ...]:
    return tuple(float(sum(m[d] for m in masks))
                 for d in range(len(masks[0])))


def ipc_of(masks, device) -> torch.Tensor:
    """infoPerCoord from static masks: how many proposals constrain each
    tangent dim."""
    return torch.tensor(_ipc_tuple(tuple(masks)), dtype=torch.float32,
                        device=device)


def solvable_factors(fg, labels: Iterable[str]):
    """The factors among ``labels`` that take part in a solve."""
    return [fg.factor(fl) for fl in labels
            if not isinstance(fg.factor(fl).model, (MetaPrior,
                                                    GenericMarginal))
            and fg.factor(fl).solvable > 0]


def canonical_factors(fg, target: str, labels: Iterable[str]):
    """Solvable factors in canonical order (model type, arity, target slot,
    multihypo, nullhypo): the order fixes the cascade and the keys, so
    permutations of one factor set solve alike."""
    factors = solvable_factors(fg, labels)
    factors.sort(key=lambda f: (type(f.model).__name__, len(f.variables),
                                f.variables.index(target)
                                if target in f.variables else -1,
                                f.multihypo or (), f.nullhypo))
    return factors


def conv_entry(fg, f, target: str, nsrp: float):
    """(ConvSpec, dim mask) of factor ``f`` solving for ``target``, cached
    on the factor per solver knobs."""
    from .convolve import make_conv_spec, static_dim_mask

    cache = f.__dict__.setdefault("_conv_cache", {})
    p = fg.params
    pkey = (target, p.inflate_cycles, p.inflation, p.spread_nh,
            p.conv_iters, p.conv_damping, nsrp)
    entry = cache.get(pkey)
    if entry is None:
        spec = make_conv_spec(fg, f, target, null_surplus=nsrp)
        entry = cache[pkey] = (
            spec, static_dim_mask(fg.var(target).manifold,
                                  spec.partial_dims))
    return entry


class UpdatePlan:
    """A prepared variable update: static structure + tensor inputs."""

    def __init__(self, fg, target, manifold, models, nested, old_points,
                 specs, masks, n_out, solve_key):
        self.fg = fg
        self.target = target
        self.manifold = manifold
        self.models = tuple(models)
        self.nested = tuple(tuple(v) for v in nested)
        self.old_points = old_points
        self.specs = tuple(specs)
        self.masks = tuple(masks)
        self.n_out = n_out
        self.solve_key = solve_key

    def ipc(self):
        return ipc_of(self.masks, self.old_points.device)


def prepare_update(fg, target: str, factor_labels: Sequence[str],
                   solve_key: str = "default", n: int | None = None):
    """Prep for one variable update: an UpdatePlan, or a (belief, ipc)
    pass-through when no solvable factor touches the target."""
    from .convolve import _tile_to, null_surplus_map

    v = fg.var(target)
    manifold = v.manifold
    n_out = n or v.N
    factors = canonical_factors(fg, target, factor_labels)
    old_points = _tile_to(fg.points(target, solve_key), n_out)
    if not factors:
        ipc = torch.zeros((manifold.dof,), dtype=torch.float32,
                          device=old_points.device)
        return make_belief(manifold, old_points, ipc=ipc), ipc

    nsrp = null_surplus_map(fg.params, factors)
    specs, masks, models, nested = [], [], [], []
    for f in factors:
        spec, mask = conv_entry(fg, f, target, nsrp[f.label])
        specs.append(spec)
        masks.append(mask)
        models.append(f.model)
        var_points = [fg.points(lbl, solve_key) for lbl in f.variables]
        maxlen = max([n_out] + [p.shape[0] for p in var_points])
        nested.append(tuple(_tile_to(p, maxlen) for p in var_points))
    return UpdatePlan(fg, target, manifold, models, nested, old_points,
                      specs, masks, n_out, solve_key)


def propagate_belief(fg, target: str, factor_labels: Sequence[str],
                     key: int | None = None, solve_key: str = "default",
                     n: int | None = None) -> Tuple[Belief, torch.Tensor]:
    """Product of per-factor proposals at ``target`` (reference
    propagateBelief).  Returns (belief, infoPerCoord)."""
    from .fused import fused_variable_update

    key = key if key is not None else fg.next_key()
    plan = prepare_update(fg, target, factor_labels, solve_key=solve_key,
                          n=n)
    if not isinstance(plan, UpdatePlan):
        return plan
    pts, bw = fused_variable_update(plan.manifold, plan.models, plan.nested,
                                    plan.old_points, plan.specs, plan.masks,
                                    key, plan.n_out)
    ipc = plan.ipc()
    return Belief(points=pts, bw=bw, ipc=ipc), ipc


def local_product(fg, target: str, key: int | None = None,
                  solve_key: str = "default",
                  n: int | None = None) -> Tuple[Belief, torch.Tensor]:
    """Product over all connected factors (reference localProduct)."""
    return propagate_belief(fg, target, fg.factors_of(target), key=key,
                            solve_key=solve_key, n=n)


def local_product_and_update(fg, target: str, key: int | None = None,
                             solve_key: str = "default") -> Belief:
    """Product + write-back (reference localProductAndUpdate!)."""
    belief, ipc = local_product(fg, target, key=key, solve_key=solve_key)
    fg.set_belief(target, belief.points, solve_key=solve_key,
                  bw=belief.bw, ipc=ipc)
    return belief

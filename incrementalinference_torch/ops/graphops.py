"""Belief products at variables — propagate / local product.

Counterpart of ``incrementalinference/jl_tpu/ops/graphops.py`` (reference
propagateBelief, localProduct, localProductAndUpdate!), the factor-path
queries the joint up-messages use, and chained convolutions along a path.
"""

from __future__ import annotations

import copy
import functools
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from .. import keys as _keys
from ..beliefs import Belief, make_belief
from ..config import full_precision
from ..models.factors import MODEL_REGISTRY, GenericMarginal, MetaPrior

__all__ = ["propagate_belief", "local_product", "local_product_and_update",
           "prepare_update", "UpdatePlan", "model_structure",
           "find_shortest_path_dijkstra",
           "is_path_factors_homogeneous", "approx_conv_path",
           "eval_factor_temporary"]


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


def model_structure(x):
    """The structure of a factor model, as the JAX package's
    ``tree_structure`` of it: its type, the structure of its registered
    children and its static fields; tensors and arrays are leaves, and a
    distribution counts by its type.  Models of equal structure batch
    together."""
    if isinstance(x, (torch.Tensor, np.ndarray, float, int)):
        return "leaf"
    if isinstance(x, (list, tuple)):
        return tuple(model_structure(e) for e in x)
    if isinstance(x, Belief):
        return ("Belief", tuple(x.points.shape[1:]))
    entry = MODEL_REGISTRY.get(type(x).__name__)
    if entry is None or entry[0] is not type(x):
        return type(x)

    def static(v):
        try:
            hash(v)
            return v
        except TypeError:
            return repr(v)

    return (type(x), tuple(model_structure(getattr(x, c, None))
                           for c in entry[1]),
            tuple(static(getattr(x, a, None)) for a in entry[2]))


class UpdatePlan:
    """A prepared variable update: static structure + tensor inputs.
    Plans of equal ``structure_key`` run as one batched update."""

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

    @property
    def structure_key(self):
        return (self.manifold, self.specs, self.masks, self.n_out,
                tuple(model_structure(m) for m in self.models),
                tuple(tuple(tuple(p.shape) for p in v) for v in self.nested))

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


@full_precision()
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


def find_shortest_path_dijkstra(fg, frm: str, to: str, type_factors=(),
                                initialized: bool = False,
                                solve_key: str = "default") -> list:
    """Shortest variable–factor–variable path between two variables,
    optionally restricted to factors of given model classes and/or to
    initialized variables (reference findShortestPathDijkstra; used by the
    joint-message machinery).

    Returns the alternating ``[var, factor, var, …]`` label list, or ``[]``
    when no path exists under the restriction.  The graph is handed to
    networkx in the same node and edge order as in the JAX package, so that
    both pick the same one of several shortest paths."""
    import networkx as nx

    type_factors = tuple(type_factors)
    g = nx.Graph()
    for vl in fg.ls():
        if initialized and not fg.var(vl).is_initialized(solve_key):
            continue
        g.add_node(vl)
    for fl in fg.lsf():
        f = fg.factor(fl)
        if type_factors and not isinstance(f.model, type_factors):
            continue
        if any(v not in g for v in f.variables):
            continue
        for v in f.variables:
            g.add_edge(fl, v)
    try:
        return list(nx.shortest_path(g, frm, to))
    except (nx.NetworkXNoPath, nx.NodeNotFound):
        return []


def is_path_factors_homogeneous(fg, frm: str, to: str):
    """Whether every factor on the shortest ``frm``→``to`` path shares one
    model type; returns ``(is_homogeneous, [type_names])`` (reference
    isPathFactorsHomogeneous)."""
    path = find_shortest_path_dijkstra(fg, frm, to)
    uniq = sorted({type(fg.factor(lbl).model).__name__
                   for lbl in path[1::2]})
    return len(uniq) == 1, uniq


def approx_conv_path(fg, start: str, target: str, key: int | None = None,
                     solve_key: str = "default",
                     n: int | None = None) -> Belief:
    """Chained convolution from ``start`` to ``target`` along the shortest
    factor path (reference approxConvBelief(dfg, from, target)), on a
    scratch copy of the variables so the graph is untouched."""
    from .convolve import eval_factor

    path = find_shortest_path_dijkstra(fg, start, target)
    if not path:
        raise ValueError(f"no factor path {start} → {target}")
    key = key if key is not None else fg.next_key()
    scratch = copy.copy(fg)
    scratch.variables = {k: copy.copy(v) for k, v in fg.variables.items()}
    for v in scratch.variables.values():
        v.beliefs = dict(v.beliefs)
        v.initialized = dict(v.initialized)
    pts = scratch.points(start, solve_key)
    for i in range(1, len(path) - 1, 2):
        fl, nxt = path[i], path[i + 1]
        key, sub = _keys.split(key, 2)
        pts, _ = eval_factor(scratch, fl, nxt, key=sub, solve_key=solve_key,
                             n=n)
        scratch.set_belief(nxt, pts, solve_key=solve_key)
    return make_belief(fg.var(target).manifold, pts)


def eval_factor_temporary(factor_model, vartypes, values,
                          key: int | None = None, n: int = 100,
                          solvefor: int = -1, device=None) -> torch.Tensor:
    """Evaluate a factor on a throwaway graph built from variable types and
    one value each (reference _evalFactorTemporary!)."""
    from ..graph import FactorGraph
    from .convolve import eval_factor

    fg = FactorGraph(device=device)
    labels = []
    for i, (vt, val) in enumerate(zip(vartypes, values)):
        lbl = f"x{i + 1}"
        fg.add_variable(lbl, vt, N=n)
        if not isinstance(val, torch.Tensor):
            val = torch.as_tensor(np.asarray(val, np.float32))
        val = val.to(device=fg.device, dtype=torch.float32)
        fg.set_belief(lbl, val.expand((n, vt.manifold.point_dim)).clone())
        labels.append(lbl)
    f = fg.add_factor(labels, factor_model, graphinit=False)
    pts, _ = eval_factor(fg, f.label, labels[solvefor], key=key, n=n)
    return pts

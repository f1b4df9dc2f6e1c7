"""Carry a factor graph's state across as plain arrays.

This system has no weights: its state is the graph — variables with belief
points and bandwidths, factors with their model parameters.
:func:`graph_from_arrays` builds a graph on a device from a dict of plain
numpy and Python values, and :func:`graph_to_arrays` is its inverse.  A
graph from another implementation (the JAX package) converts to the same
dict, so both start from identical particles.

The dict::

    {"params": {SolverParams field: value, ...},          # optional
     "variables": [{"label", "type": "ContinuousScalar" | "ContinuousEuclid<n>"
                            | "Position<n>" | "Circular" | any other name,
                    "manifold": manifold dict (needed for any other name),
                    "N", "solvable", "tags",
                    "points": (N, d) array or None (uninitialized),
                    "bw": (dof,) array or None (LOO-selected),
                    "ipc": (dof,) array or None,
                    "parametric_point": (point_dim,) array or None,
                    "parametric_cov": (dof, dof) array or None}, ...],
     "factors": [{"label", "type": "Prior" | "LinearRelative" | ...,
                  "variables": [labels], "Z": distribution dict,
                  "multihypo", "nullhypo", "solvable", "tags"}, ...]}

A distribution dict is ``{"type": name, field: value, ...}`` with the
fields of ``_DIST_FIELDS`` (``{"type": "Normal", "mu", "sigma"}``,
``{"type": "MvNormal", "mu", "cov"}``, ...); a KDE is
``{"type": "ManifoldKernelDensity", "dof", "points", "bw"}`` on R^dof.  A
Mixture factor has, in place of "Z", ``"mechanics"`` (the name of the
factor type whose residual it uses), ``"components"`` (distribution dicts)
and ``"diversity"`` (weights), and ``"mechanics_fields"`` where the
mechanics take more than a distribution (a ManifoldPrior's manifold and
point).  The other parameter fields a factor type
registers travel under their names: ``"manifold"`` (a manifold dict),
``"p0"`` (ManifoldPrior's point), ``"partial"`` (PartialPrior's dims), and
GaussianJoint's ``"manifolds"`` (manifold dicts), ``"p0s"`` (arrays) and
``"cov"``.
A manifold dict is ``{"type": "SE2"}``, ``{"type": "Euclidean", "n": 2}`` or
``{"type": "Product", "components": [manifold dicts]}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import re

import numpy as np
import torch

from .config import SolverParams
from . import distributions as _d
from . import manifolds as _m
from .graph import (Circular, ContinuousEuclid, ContinuousScalar,
                    FactorGraph, Position, VariableType)
from .manifolds import Euclidean
from .models.factors import MODEL_REGISTRY, Mixture

__all__ = ["graph_from_arrays", "graph_to_arrays", "manifold_from",
           "manifold_to"]

#: manifolds without parameters, by class name
_PLAIN_MANIFOLDS = ("Circle", "SO2", "SE2", "SO3", "SE3", "Sphere2")


def manifold_to(m) -> dict:
    """A manifold as a dict: its class name and what its constructor takes."""
    name = type(m).__name__
    if name == "Euclidean":
        return {"type": name, "n": m.n}
    if name == "Product":
        return {"type": name,
                "components": [manifold_to(c) for c in m.components]}
    if name in _PLAIN_MANIFOLDS:
        return {"type": name}
    raise ValueError(f"unsupported manifold {name}")


def manifold_from(d: dict):
    """The inverse of :func:`manifold_to`."""
    name = d["type"]
    if name == "Euclidean":
        return Euclidean(int(d["n"]))
    if name == "Product":
        return _m.Product(*(manifold_from(c) for c in d["components"]))
    if name in _PLAIN_MANIFOLDS:
        return getattr(_m, name)()
    raise ValueError(f"unsupported manifold {name!r}")


def _vartype(name: str, manifold: dict | None = None):
    if name == "ContinuousScalar":
        return ContinuousScalar
    if name == "Circular":
        return Circular
    m = re.fullmatch(r"(ContinuousEuclid|Position)(\d+)", name)
    if m:
        make = ContinuousEuclid if m.group(1) == "ContinuousEuclid" \
            else Position
        return make(int(m.group(2)))
    if manifold is None:
        raise ValueError(f"variable type {name!r} needs its manifold")
    return VariableType(name, manifold_from(manifold))


#: distribution type name -> constructor fields, in order
_DIST_FIELDS = {"Normal": ("mu", "sigma"), "MvNormal": ("mu", "cov"),
                "Uniform": ("a", "b"), "Rayleigh": ("sigma",),
                "Categorical": ("p",),
                "AliasingScalarSampler": ("x", "weights")}


def _dist_from(d: dict):
    if d["type"] == "ManifoldKernelDensity":
        return _d.ManifoldKernelDensity(Euclidean(int(d["dof"])),
                                        d["points"], bw=d.get("bw"))
    if d["type"] not in _DIST_FIELDS:
        raise ValueError(f"unsupported distribution {d['type']!r}")
    return getattr(_d, d["type"])(*(np.asarray(d[f], np.float32)
                                    for f in _DIST_FIELDS[d["type"]]))


def _dist_to(z) -> dict:
    name = type(z).__name__
    if name == "ManifoldKernelDensity":
        return {"type": name, "dof": z.manifold.dof,
                "points": np.asarray(z.points),
                "bw": None if z.bw is None else np.asarray(z.bw)}
    if name not in _DIST_FIELDS:
        raise ValueError(f"unsupported distribution {name}")
    return {"type": name,
            **{f: np.asarray(getattr(z, f)) for f in _DIST_FIELDS[name]}}


def _model_from(f: dict):
    if f["type"] not in MODEL_REGISTRY:
        raise ValueError(f"unsupported factor type {f['type']!r}")
    cls, _ = MODEL_REGISTRY[f["type"]]
    if cls is Mixture:
        components = [_dist_from(c) for c in f["components"]]
        mechanics = MODEL_REGISTRY[f["mechanics"]][0]
        extra = f.get("mechanics_fields")
        if extra:           # mechanics with more than a distribution
            mechanics = mechanics(Z=components[0], **{
                k: _FIELD_FROM[k](v) for k, v in extra.items()})
        return Mixture(mechanics, components, f["diversity"])
    return cls(**{k: _FIELD_FROM[k](f[k]) for k in _carried(f["type"])})


#: the parameter fields convert carries, each with its two directions; a
#: factor type is carried when all its registered fields are among these
_FIELD_FROM = {"Z": _dist_from, "manifold": manifold_from,
               "p0": lambda a: np.asarray(a, np.float32),
               "partial": lambda t: tuple(int(i) for i in t),
               "manifolds": lambda ms: [manifold_from(m) for m in ms],
               "p0s": lambda ps: [np.asarray(p, np.float32) for p in ps],
               "cov": lambda a: np.asarray(a, np.float32)}
_FIELD_TO = {"Z": _dist_to, "manifold": manifold_to,
             "p0": lambda a: np.asarray(a, np.float32),
             "partial": list,
             "manifolds": lambda ms: [manifold_to(m) for m in ms],
             "p0s": lambda ps: [_host(p) for p in ps],
             "cov": lambda a: _host(a)}


def _host(a):
    """A tensor or array as a float32 numpy array (None stays None)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float32)
    return np.asarray(a, np.float32)


def _carried(type_name: str):
    fields = MODEL_REGISTRY[type_name][1]
    if any(k not in _FIELD_FROM for k in fields):
        raise ValueError(f"factor type {type_name!r} is not carried as "
                         f"arrays (fields {fields})")
    return fields


def _model_to(model) -> dict:
    if isinstance(model, Mixture):
        mech = type(model.mechanics).__name__
        return {"mechanics": mech,
                "mechanics_fields": {
                    k: _FIELD_TO[k](getattr(model.mechanics, k))
                    for k in _carried(mech) if k != "Z"},
                "components": [_dist_to(c) for c in model.components],
                "diversity": np.asarray(model.diversity)}
    return {k: _FIELD_TO[k](getattr(model, k))
            for k in _carried(type(model).__name__)}


def _tensor(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def graph_from_arrays(spec: dict, device=None) -> FactorGraph:
    """Build a :class:`FactorGraph` on ``device`` (CUDA by default) from
    the dict described in the module docstring.  Factors are added without
    graphinit: the beliefs come from the dict."""
    params = SolverParams(**spec.get("params", {}))
    fg = FactorGraph(params, device=device)
    for v in spec["variables"]:
        fg.add_variable(v["label"], _vartype(v["type"], v.get("manifold")),
                        N=v.get("N"),
                        tags=v.get("tags", ()),
                        solvable=v.get("solvable", 1))
        if v.get("points") is not None:
            bw, ipc = v.get("bw"), v.get("ipc")
            fg.set_belief(
                v["label"], _tensor(v["points"], fg.device),
                bw=None if bw is None else _tensor(bw, fg.device),
                ipc=None if ipc is None else _tensor(ipc, fg.device))
        var = fg.var(v["label"])
        for k in ("parametric_point", "parametric_cov"):
            if v.get(k) is not None:
                setattr(var, k, _tensor(v[k], fg.device))
    for f in spec["factors"]:
        fg.add_factor(f["variables"], _model_from(f), multihypo=f.get("multihypo"),
                      nullhypo=f.get("nullhypo", 0.0), label=f["label"],
                      graphinit=False, tags=f.get("tags", ()),
                      solvable=f.get("solvable", 1))
    # later auto-named factors continue the numbering
    fg._factor_counter = itertools.count(len(spec["factors"]))
    return fg


def graph_to_arrays(fg: FactorGraph, solve_key: str = "default") -> dict:
    """The inverse of :func:`graph_from_arrays`: the ``solve_key`` beliefs
    as numpy arrays (None where a variable has no belief)."""
    variables = []
    for v in fg.variables.values():
        b = v.beliefs.get(solve_key)
        variables.append({
            "label": v.label, "type": v.vartype.name,
            "manifold": manifold_to(v.manifold), "N": v.N,
            "solvable": v.solvable, "tags": sorted(v.tags),
            "points": None if b is None else b.points.cpu().numpy(),
            "bw": None if b is None else b.bw.cpu().numpy(),
            "ipc": None if b is None else b.ipc.cpu().numpy(),
            "parametric_point": _host(v.parametric_point),
            "parametric_cov": _host(v.parametric_cov),
        })
    factors = []
    for f in fg.factors.values():
        d = {"label": f.label, "type": type(f.model).__name__,
             "variables": list(f.variables),
             "multihypo": None if f.multihypo is None else list(f.multihypo),
             "nullhypo": f.nullhypo, "solvable": f.solvable,
             "tags": sorted(f.tags), **_model_to(f.model)}
        factors.append(d)
    return {"params": dataclasses.asdict(fg.params), "variables": variables,
            "factors": factors}

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

The model families travel too.  A grid density is
``{"type": "HeatmapGridDensity", "data", "xs", "ys", "N"}`` or
``{"type": "LevelSetGridNormal", "data", "xs", "ys", "level", "sigma"}``
(``data`` the raw grid).  A network ensemble is
``{"type": "FluxModelsDistribution", "net": "mlp" | [layer specs],
"params": [[W, b], ...], "data", "out_dim", "shuffle"}`` with the stacked
parameters in the JAX package's layout (conv weights HWIO); see
:func:`ensemble_params_from`.  A DERelative factor carries ``"Z"``,
``"t0"``, ``"t1"``, ``"steps"`` and ``"data"``; its dynamics function is
Python code, so :func:`graph_from_arrays` takes it from ``functions``, a
mapping from factor label to function.
"""

from __future__ import annotations

import dataclasses
import itertools
import re

import numpy as np
import torch

from .config import SolverParams
from . import distributions as _d
from .distributions import host32
from . import manifolds as _m
from .graph import (Circular, ContinuousEuclid, ContinuousScalar,
                    FactorGraph, Position, VariableType)
from .manifolds import Euclidean
from .models.densities import HeatmapGridDensity, LevelSetGridNormal
from .models.factors import MODEL_REGISTRY, Mixture
from .models.flux import FluxModelsDistribution, SequentialNet, mlp_apply
from .models.ode import DERelative

__all__ = ["graph_from_arrays", "graph_to_arrays", "manifold_from",
           "manifold_to", "ensemble_params_from", "ensemble_params_to"]

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


def ensemble_params_from(params) -> list:
    """Stacked ensemble parameters in the JAX package's layout (a list of
    (W, b) arrays: dense W (E, out, in), conv W HWIO (E, k, k, in, out)) as
    the port's float32 CPU tensors (conv W (E, out, in, k, k))."""
    out = []
    for W, b in params:
        W = host32(W)
        if W.ndim == 5:
            W = W.transpose(0, 4, 3, 1, 2)
        out.append((torch.tensor(np.ascontiguousarray(W)),
                    torch.tensor(host32(b))))
    return out


def ensemble_params_to(params) -> list:
    """The inverse of :func:`ensemble_params_from`: [[W, b], ...] numpy
    arrays in the JAX package's layout."""
    out = []
    for W, b in params:
        W = host32(W)
        if W.ndim == 5:
            W = np.ascontiguousarray(W.transpose(0, 3, 4, 2, 1))
        out.append([W, host32(b)])
    return out


def _dist_from(d: dict):
    if d["type"] == "ManifoldKernelDensity":
        return _d.ManifoldKernelDensity(Euclidean(int(d["dof"])),
                                        d["points"], bw=d.get("bw"))
    if d["type"] == "HeatmapGridDensity":
        return HeatmapGridDensity(d["data"], (d["xs"], d["ys"]),
                                  N=int(d.get("N", 10000)))
    if d["type"] == "LevelSetGridNormal":
        return LevelSetGridNormal(d["data"], (d["xs"], d["ys"]),
                                  level=float(d["level"]),
                                  sigma=float(d["sigma"]))
    if d["type"] == "FluxModelsDistribution":
        net = (mlp_apply if d["net"] == "mlp"
               else SequentialNet(d["net"]))
        return FluxModelsDistribution(net, ensemble_params_from(d["params"]),
                                      d["data"], int(d["out_dim"]),
                                      shuffle=bool(d.get("shuffle", True)))
    if d["type"] not in _DIST_FIELDS:
        raise ValueError(f"unsupported distribution {d['type']!r}")
    return getattr(_d, d["type"])(*(np.asarray(d[f], np.float32)
                                    for f in _DIST_FIELDS[d["type"]]))


def _dist_to(z) -> dict:
    name = type(z).__name__
    if name == "ManifoldKernelDensity":
        return {"type": name, "dof": z.manifold.dof,
                "points": host32(z.points), "bw": host32(z.bw)}
    if name == "HeatmapGridDensity":
        return {"type": name, "data": z.data, "xs": z.xs, "ys": z.ys,
                "N": z.N}
    if name == "LevelSetGridNormal":
        return {"type": name, "data": z.data, "xs": z.heatmap.xs,
                "ys": z.heatmap.ys, "level": z.level, "sigma": z.sigma}
    if name == "FluxModelsDistribution":
        if isinstance(z.apply_fn, SequentialNet):
            net = [list(layer) for layer in z.apply_fn.spec]
        elif z.apply_fn is mlp_apply:
            net = "mlp"
        else:
            raise ValueError("only a SequentialNet or mlp_apply network is "
                             "carried as arrays")
        return {"type": name, "net": net,
                "params": ensemble_params_to(z.params),
                "data": host32(z.data), "out_dim": z.out_dim,
                "shuffle": bool(z.shuffle)}
    if name not in _DIST_FIELDS:
        raise ValueError(f"unsupported distribution {name}")
    return {"type": name,
            **{f: np.asarray(getattr(z, f)) for f in _DIST_FIELDS[name]}}


def _model_from(f: dict, functions: dict):
    if f["type"] not in MODEL_REGISTRY:
        raise ValueError(f"unsupported factor type {f['type']!r}")
    cls = MODEL_REGISTRY[f["type"]][0]
    if cls is Mixture:
        components = [_dist_from(c) for c in f["components"]]
        mechanics = MODEL_REGISTRY[f["mechanics"]][0]
        extra = f.get("mechanics_fields")
        if extra:           # mechanics with more than a distribution
            mechanics = mechanics(Z=components[0], **{
                k: _FIELD_FROM[k](v) for k, v in extra.items()})
        return Mixture(mechanics, components, f["diversity"])
    kw = {k: _FIELD_FROM[k](f[k]) for k in _carried(f["type"])}
    if cls is DERelative:
        if f["label"] not in functions:
            raise ValueError(
                f"factor {f['label']!r} is a DERelative: its dynamics "
                f"function is not carried as arrays, pass it as "
                f"functions={{{f['label']!r}: f}}")
        return cls(functions[f["label"]], **kw)
    return cls(**kw)


#: the parameter fields convert carries, each with its two directions; a
#: factor type is carried when all its registered fields are among these
_FIELD_FROM = {"Z": _dist_from, "manifold": manifold_from,
               "p0": lambda a: np.asarray(a, np.float32),
               "partial": lambda t: tuple(int(i) for i in t),
               "manifolds": lambda ms: [manifold_from(m) for m in ms],
               "p0s": lambda ps: [np.asarray(p, np.float32) for p in ps],
               "cov": lambda a: np.asarray(a, np.float32),
               "t0": float, "t1": float, "steps": int,
               "data": lambda a: None if a is None
               else np.asarray(a, np.float32)}
_FIELD_TO = {"Z": _dist_to, "manifold": manifold_to,
             "p0": lambda a: np.asarray(a, np.float32),
             "partial": list,
             "manifolds": lambda ms: [manifold_to(m) for m in ms],
             "p0s": lambda ps: [host32(p) for p in ps],
             "cov": host32,
             "t0": float, "t1": float, "steps": int,
             "data": host32}


def _carried(type_name: str):
    _, children, aux = MODEL_REGISTRY[type_name]
    fields = children + aux
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


def graph_from_arrays(spec: dict, device=None,
                      functions: dict | None = None) -> FactorGraph:
    """Build a :class:`FactorGraph` on ``device`` (CUDA by default) from
    the dict described in the module docstring.  Factors are added without
    graphinit: the beliefs come from the dict.  ``functions`` maps the label
    of each DERelative factor to its dynamics function."""
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
        fg.add_factor(f["variables"], _model_from(f, functions or {}),
                      multihypo=f.get("multihypo"),
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
            "parametric_point": host32(v.parametric_point),
            "parametric_cov": host32(v.parametric_cov),
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

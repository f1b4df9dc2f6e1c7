"""Packed (JSON-safe) serialization of distributions, beliefs, factors,
graphs and trees.

Counterpart of ``incrementalinference/jl_tpu/serialization/packed.py``
(reference packDistribution/unpackDistribution, PackedManifoldKernelDensity
and parchDistribution, the packed-factor reconstruction of
DispatchPackedConversions.jl, saveTree/loadTree).  The file format is the
JAX package's: the same ``_format`` headers, keys, ``_type`` names and
array layouts (nested lists; a network ensemble's conv weights HWIO), so a
file written by either package loads in the other.

Tensors leave through the host; float32 values written as JSON doubles read
back bit for bit.  What a load makes of tensors (beliefs, PPEs, parametric
state, custom-model arrays) lands as float32 on the graph's device;
distribution parameters stay host-side numpy, as everywhere in the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from .. import distributions as D
from .. import models as M
from ..beliefs import Belief, LazyPPE
from ..config import SolverParams, resolve_device
from ..convert import ensemble_params_from, ensemble_params_to
from ..datastore import BlobEntry
from ..graph import FactorGraph, VariableType
from ..manifolds import (SE2, SE3, SO2, SO3, Circle, Euclidean, Manifold,
                         Product, Sphere2)
from ..models.densities import (HeatmapGridDensity, LevelSetGridNormal,
                                PartialPriorPassThrough)
from ..models.flux import FluxModelsDistribution, SequentialNet, mlp_apply
from ..models.ode import DERelative
from ..tree.bayestree import BayesTree, Clique, CliqStatus

__all__ = [
    "pack_distribution", "unpack_distribution", "pack_belief",
    "unpack_belief", "pack_manifold", "unpack_manifold", "pack_factor_model",
    "unpack_factor_model", "save_graph", "load_graph", "save_tree",
    "load_tree", "register_fn",
]


def _arr(x) -> list:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).tolist()


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ---------------------------------------------------------------------------
# manifolds
# ---------------------------------------------------------------------------

#: manifolds without parameters, in the JAX package's isinstance order
_PLAIN = {"SO2": SO2, "Circle": Circle, "SE2": SE2, "SO3": SO3, "SE3": SE3,
          "Sphere2": Sphere2}


def pack_manifold(m: Manifold) -> Any:
    """Symbolic manifold name for packed payloads."""
    if isinstance(m, Euclidean):
        return {"_type": "Euclidean", "n": m.n}
    for name, cls in _PLAIN.items():
        if isinstance(m, cls):
            return {"_type": name}
    if isinstance(m, Product):
        return {"_type": "Product",
                "components": [pack_manifold(c) for c in m.components]}
    raise TypeError(f"cannot pack manifold {m!r}")


def unpack_manifold(d: Dict) -> Manifold:
    t = d["_type"]
    if t == "Euclidean":
        return Euclidean(d["n"])
    if t == "Product":
        return Product(*[unpack_manifold(c) for c in d["components"]])
    if t in _PLAIN:
        return _PLAIN[t]()
    raise TypeError(f"unknown packed manifold {t}")


# ---------------------------------------------------------------------------
# distributions (reference packDistribution forms)
# ---------------------------------------------------------------------------

def _pack_distribution_core(z):
    if isinstance(z, D.Normal):
        return {"_type": "Normal", "mu": float(z.mu), "sigma": float(z.sigma)}
    if isinstance(z, D.MvNormal):
        return {"_type": "MvNormal", "mu": _arr(z.mu), "cov": _arr(z.cov)}
    if isinstance(z, D.Uniform):
        return {"_type": "Uniform", "a": float(z.a), "b": float(z.b)}
    if isinstance(z, D.Rayleigh):
        return {"_type": "Rayleigh", "sigma": float(z.sigma)}
    if isinstance(z, D.Categorical):
        return {"_type": "Categorical", "p": _arr(z.p)}
    if isinstance(z, D.AliasingScalarSampler):
        return {"_type": "AliasingScalarSampler", "x": _arr(z.x),
                "weights": _arr(z.weights)}
    if isinstance(z, D.ManifoldKernelDensity):
        # PackedManifoldKernelDensity (reference SerializationMKD.jl)
        return {"_type": "ManifoldKernelDensity", "dim": z.manifold.dof,
                "manifold": pack_manifold(z.manifold),
                "points": _arr(z.belief.points), "bw": _arr(z.belief.bw)}
    return None


def _unpack_distribution_core(d: Dict, device):
    t = d["_type"]
    if t == "Normal":
        return D.Normal(d["mu"], d["sigma"])
    if t == "MvNormal":
        return D.MvNormal(d["mu"], d["cov"])
    if t == "Uniform":
        return D.Uniform(d["a"], d["b"])
    if t == "Rayleigh":
        return D.Rayleigh(d["sigma"])
    if t == "Categorical":
        return D.Categorical(d["p"])
    if t == "AliasingScalarSampler":
        return D.AliasingScalarSampler(np.asarray(d["x"], np.float32),
                                       np.asarray(d["weights"], np.float32))
    if t == "ManifoldKernelDensity":
        # files without "manifold" (older JAX-package files): Euclidean(dim)
        man = (unpack_manifold(d["manifold"]) if "manifold" in d
               else Euclidean(int(d["dim"])))
        return D.ManifoldKernelDensity(man, _f32(d["points"], device),
                                       bw=np.asarray(d["bw"], np.float32))
    return None


# ---------------------------------------------------------------------------
# beliefs (PackedManifoldKernelDensity; parch = hollow out points)
# ---------------------------------------------------------------------------

def pack_belief(b: Belief, parch: bool = False) -> Dict:
    """JSON-safe packed KDE belief (reference PackedManifoldKernelDensity;
    ``parch=True`` hollows the point block, reference parchDistribution)."""
    out = {"_type": "Belief", "bw": _arr(b.bw), "ipc": _arr(b.ipc),
           "npts": int(b.points.shape[0])}
    if not parch:
        out["points"] = _arr(b.points)
    return out


def unpack_belief(d: Dict, device=None) -> Belief:
    """Rebuild a ``Belief`` on ``device`` (CUDA unless named), float32,
    ``ipc`` kept; a parched block comes back as zeros of the packed
    shape."""
    device = resolve_device(device)
    pts = d.get("points")
    if pts is None:
        pts = np.zeros((d["npts"], len(d["bw"])), np.float32)
    return Belief(points=_f32(pts, device), bw=_f32(d["bw"], device),
                  ipc=_f32(d["ipc"], device))


# ---------------------------------------------------------------------------
# factor models
# ---------------------------------------------------------------------------

def _pack_factor_model_core(m):
    if isinstance(m, M.Mixture):
        return {"_type": "Mixture",
                "mechanics": pack_factor_model(m.mechanics),
                "components": [pack_distribution(c) for c in m.components],
                "diversity": _arr(m.diversity)}
    if isinstance(m, M.PartialPrior):
        return {"_type": "PartialPrior", "Z": pack_distribution(m.Z),
                "partial": list(m.partial)}
    if isinstance(m, M.MsgPrior):
        return {"_type": "MsgPrior", "belief": pack_belief(m.belief),
                "manifold": pack_manifold(m.manifold)}
    if isinstance(m, M.MetaPrior):
        return {"_type": "MetaPrior", "data": m.data}
    if isinstance(m, M.GenericMarginal):
        return {"_type": "GenericMarginal"}
    if isinstance(m, M.ManifoldPrior):
        return {"_type": "ManifoldPrior", "manifold": pack_manifold(m.manifold),
                "p0": _arr(m.p0), "Z": pack_distribution(m.Z)}
    if isinstance(m, M.ManifoldFactor):
        return {"_type": "ManifoldFactor",
                "manifold": pack_manifold(m.manifold),
                "Z": pack_distribution(m.Z)}
    for cls in (M.Prior, M.LinearRelative, M.EuclidDistance, M.PriorCircular,
                M.CircularCircular):
        if type(m) is cls:
            return {"_type": cls.__name__, "Z": pack_distribution(m.Z)}
    return None


_SIMPLE_MODELS = {"Prior": M.Prior, "LinearRelative": M.LinearRelative,
                  "EuclidDistance": M.EuclidDistance,
                  "PriorCircular": M.PriorCircular,
                  "CircularCircular": M.CircularCircular}


def _unpack_factor_model_core(d: Dict, device):
    t = d["_type"]
    if t in _SIMPLE_MODELS:
        return _SIMPLE_MODELS[t](unpack_distribution(d["Z"], device))
    if t == "Mixture":
        return M.Mixture(unpack_factor_model(d["mechanics"], device),
                         [unpack_distribution(c, device)
                          for c in d["components"]],
                         d["diversity"])
    if t == "PartialPrior":
        return M.PartialPrior(unpack_distribution(d["Z"], device),
                              d["partial"])
    if t == "MsgPrior":
        return M.MsgPrior(unpack_belief(d["belief"], device),
                          unpack_manifold(d["manifold"]))
    if t == "MetaPrior":
        return M.MetaPrior(d.get("data"))
    if t == "GenericMarginal":
        return M.GenericMarginal()
    if t == "ManifoldPrior":
        return M.ManifoldPrior(unpack_manifold(d["manifold"]),
                               np.asarray(d["p0"], np.float32),
                               unpack_distribution(d["Z"], device))
    if t == "ManifoldFactor":
        return M.ManifoldFactor(unpack_manifold(d["manifold"]),
                                unpack_distribution(d["Z"], device))
    return None


# ---------------------------------------------------------------------------
# graph save/load (reference saveDFG/loadDFG role)
# ---------------------------------------------------------------------------

def save_graph(fg: FactorGraph, path: str, parch: bool = False) -> str:
    """Save the graph as packed JSON (reference saveDFG).  ``parch=True``
    hollows out the belief point blocks (reference parchDistribution)."""
    doc = {"_format": "iitpu-fg-v1",
           "params": fg.params.__dict__ | {
               "algorithms": list(fg.params.algorithms)},
           "variables": [], "factors": []}
    for lbl, v in fg.variables.items():
        doc["variables"].append({
            "label": lbl, "vartype": v.vartype.name,
            "manifold": pack_manifold(v.manifold), "N": v.N,
            "tags": sorted(v.tags), "solvable": v.solvable,
            "marginalized": v.marginalized,
            "beliefs": {k: pack_belief(b, parch=parch)
                        for k, b in v.beliefs.items()},
            "initialized": dict(v.initialized),
            "parametric_point": (None if v.parametric_point is None
                                 else _arr(v.parametric_point)),
            "parametric_cov": (None if v.parametric_cov is None
                               else _arr(v.parametric_cov)),
            "timestamp": v.timestamp,
            "solved_count": dict(v.solved_count),
            # an estimate nobody read yet saves as a marker and comes back
            # lazy: forcing it here would cost an N x N KDE per variable
            "ppe": {k: ({"__lazy__": True}
                        if isinstance(est, LazyPPE) and not est._done
                        else {kk: _arr(vv) for kk, vv in est.items()})
                    for k, est in v.ppe.items()},
            "data": {k: {"label": e.label, "blob_id": e.blob_id,
                         "blobstore": e.blobstore,
                         "mime_type": e.mime_type, "hash": e.hash,
                         "origin": e.origin,
                         "description": e.description,
                         "timestamp": e.timestamp}
                     for k, e in v.data.items()},
        })
    for lbl, f in fg.factors.items():
        doc["factors"].append({
            "label": lbl, "variables": list(f.variables),
            "model": pack_factor_model(f.model),
            "multihypo": (None if f.multihypo is None else list(f.multihypo)),
            "nullhypo": f.nullhypo, "tags": sorted(f.tags),
            "solvable": f.solvable, "timestamp": f.timestamp,
        })
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fp:
        json.dump(doc, fp)
    return path


def load_graph(path: str, device=None) -> FactorGraph:
    """Rebuild a solvable graph on ``device`` (CUDA unless named) from
    ``save_graph`` output of either package (reference loadDFG +
    reconstFactorData).  For archives of the reference ecosystem itself use
    ``load_dfg_archive``."""
    with open(path) as fp:
        doc = json.load(fp)
    if doc.get("_format") != "iitpu-fg-v1":
        raise ValueError(f"{path}: unknown graph format "
                         f"{doc.get('_format')!r}")
    pd = dict(doc["params"])
    pd["algorithms"] = tuple(pd.get("algorithms", ("default", "parametric")))
    fg = FactorGraph(SolverParams(**pd), device=device)
    dev = fg.device
    for vd in doc["variables"]:
        vt = VariableType(vd["vartype"], unpack_manifold(vd["manifold"]))
        v = fg.add_variable(vd["label"], vt, N=vd["N"], tags=vd["tags"],
                            solvable=vd["solvable"])
        v.marginalized = vd["marginalized"]
        v.initialized = dict(vd["initialized"])
        v.beliefs = {k: unpack_belief(b, dev)
                     for k, b in vd["beliefs"].items()}
        if vd["parametric_point"] is not None:
            v.parametric_point = _f32(vd["parametric_point"], dev)
        if vd["parametric_cov"] is not None:
            v.parametric_cov = _f32(vd["parametric_cov"], dev)
        v.timestamp = vd.get("timestamp", 0.0)
        v.solved_count = dict(vd.get("solved_count", {}))
        v.ppe = {}
        for k, est in vd.get("ppe", {}).items():
            if est.get("__lazy__") and k in v.beliefs:
                v.ppe[k] = LazyPPE(v.manifold, v.beliefs[k])
            elif not est.get("__lazy__"):
                v.ppe[k] = {kk: _f32(vv, dev) for kk, vv in est.items()}
        v.data = {k: BlobEntry(**e) for k, e in vd.get("data", {}).items()}
    for fd in doc["factors"]:
        f = fg.add_factor(fd["variables"],
                          unpack_factor_model(fd["model"], dev),
                          multihypo=fd["multihypo"], nullhypo=fd["nullhypo"],
                          label=fd["label"], graphinit=False,
                          tags=fd["tags"], solvable=fd["solvable"])
        f.timestamp = fd.get("timestamp", 0.0)
    return fg


# ---------------------------------------------------------------------------
# tree save/load (reference saveTree/loadTree)
# ---------------------------------------------------------------------------

def save_tree(tree: BayesTree, path: str) -> str:
    """Save the tree's structure and clique states as JSON (reference
    saveTree)."""
    doc = {"_format": "iitpu-bt-v1",
           "elimination_order": tree.elimination_order,
           "build_time": tree.build_time,
           "cliques": [{
               "cid": c.cid, "frontals": c.frontals,
               "separator": c.separator, "parent": c.parent,
               "children": c.children, "potentials": c.potentials,
               "status": c.status.value, "is_recycled": c.is_recycled,
               "is_marginalized": c.is_marginalized,
               "direct_vars": c.direct_vars, "iter_vars": c.iter_vars,
               "msgskip_vars": c.msgskip_vars,
           } for c in tree.cliques.values()]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fp:
        json.dump(doc, fp)
    return path


def load_tree(path: str) -> BayesTree:
    """Rebuild a Bayes tree from ``save_tree`` output (reference
    loadTree); pass it to ``solve_tree`` as ``old_tree``."""
    with open(path) as fp:
        doc = json.load(fp)
    if doc.get("_format") != "iitpu-bt-v1":
        raise ValueError(f"{path}: unknown tree format "
                         f"{doc.get('_format')!r}")
    tree = BayesTree()
    tree.elimination_order = doc["elimination_order"]
    tree.build_time = doc["build_time"]
    for cd in doc["cliques"]:
        c = Clique(cid=cd["cid"], frontals=cd["frontals"],
                   separator=cd["separator"], parent=cd["parent"],
                   children=cd["children"], potentials=cd["potentials"],
                   status=CliqStatus(cd["status"]),
                   is_recycled=cd["is_recycled"],
                   is_marginalized=cd["is_marginalized"],
                   direct_vars=cd["direct_vars"],
                   iter_vars=cd["iter_vars"],
                   msgskip_vars=cd["msgskip_vars"])
        tree.cliques[c.cid] = c
        for frt in c.frontals:
            tree.frontal_to_clique[frt] = c.cid
    return tree


# ---------------------------------------------------------------------------
# optional densities and extension models (reference
# SerializingOptionalDensities.jl, ext/FluxModelsSerialization.jl)
# ---------------------------------------------------------------------------

#: name -> callable: ODE dynamics and network functions serialize by name
_FN_REGISTRY: Dict[str, Any] = {}


def register_fn(name: str, fn) -> None:
    """Register a callable so that factors holding it can round-trip (the
    reference rebuilds these from Julia type names)."""
    _FN_REGISTRY[name] = fn


def _fn_name(fn) -> str:
    for k, v in _FN_REGISTRY.items():
        if v is fn:
            return k
    name = getattr(fn, "__name__", None)
    if name and name != "<lambda>":
        _FN_REGISTRY[name] = fn
        return name
    raise TypeError(
        "cannot serialize an unregistered lambda; use register_fn()")


def _pack_ext(z):
    if isinstance(z, LevelSetGridNormal):
        return {"_type": "LevelSetGridNormal", "data": _arr(z.data),
                "xs": _arr(z.heatmap.xs), "ys": _arr(z.heatmap.ys),
                "level": z.level, "sigma": z.sigma}
    if isinstance(z, HeatmapGridDensity):
        return {"_type": "HeatmapGridDensity", "data": _arr(z.data),
                "xs": _arr(z.xs), "ys": _arr(z.ys)}
    if isinstance(z, FluxModelsDistribution):
        # the file holds the JAX package's layout (conv weights HWIO)
        out = {"_type": "FluxModelsDistribution",
               "params": [[_arr(W), _arr(b)]
                          for W, b in ensemble_params_to(z.params)],
               "data": _arr(z.data), "out_dim": z.out_dim,
               "shuffle": z.shuffle}
        if isinstance(z.apply_fn, SequentialNet):
            # sequential architectures round-trip by structure, no registry
            out["apply"] = "sequential"
            out["spec"] = [list(layer) for layer in z.apply_fn.spec]
        else:
            out["apply"] = ("mlp" if z.apply_fn is mlp_apply
                            else _fn_name(z.apply_fn))
        return out
    return None


def _unpack_ext(d: Dict, device):
    t = d["_type"]
    if t == "HeatmapGridDensity":
        return HeatmapGridDensity(np.asarray(d["data"], np.float32),
                                  (np.asarray(d["xs"], np.float32),
                                   np.asarray(d["ys"], np.float32)))
    if t == "LevelSetGridNormal":
        return LevelSetGridNormal(np.asarray(d["data"], np.float32),
                                  (np.asarray(d["xs"], np.float32),
                                   np.asarray(d["ys"], np.float32)),
                                  d["level"], d["sigma"])
    if t == "FluxModelsDistribution":
        if d["apply"] == "sequential":
            fn = SequentialNet(d["spec"])
        elif d["apply"] == "mlp":
            fn = mlp_apply
        else:
            fn = _FN_REGISTRY[d["apply"]]
        params = [tuple(p.to(device) for p in layer)
                  for layer in ensemble_params_from(d["params"])]
        return FluxModelsDistribution(fn, params,
                                      np.asarray(d["data"], np.float32),
                                      d["out_dim"], d["shuffle"])
    return None


def _pack_model_ext(m):
    if isinstance(m, PartialPriorPassThrough):
        return {"_type": "PartialPriorPassThrough",
                "Z": pack_distribution(m.Z), "partial": list(m.partial)}
    if isinstance(m, DERelative):
        out = {"_type": "DERelative", "f": _fn_name(m.f), "t0": m.t0,
               "t1": m.t1, "Z": pack_distribution(m.Z), "steps": m.steps}
        if m.data is not None:
            if not isinstance(m.data, (np.ndarray, torch.Tensor)):
                raise TypeError(
                    "DERelative serialization supports data=None or a "
                    "single array (close over richer structures inside a "
                    "register_fn()-registered dynamics function instead)")
            out["data"] = _arr(m.data)
        return out
    return None


def _unpack_model_ext(d: Dict, device):
    t = d["_type"]
    if t == "PartialPriorPassThrough":
        return PartialPriorPassThrough(unpack_distribution(d["Z"], device),
                                       d["partial"])
    if t == "DERelative":
        return DERelative(_FN_REGISTRY[d["f"]], d["t0"], d["t1"],
                          unpack_distribution(d["Z"], device),
                          steps=d["steps"],
                          data=(np.asarray(d["data"], np.float32)
                                if "data" in d else None))
    return None


# ---------------------------------------------------------------------------
# custom models, packed field by field through the model registry
# ---------------------------------------------------------------------------

def _pack_value(v):
    if v is None:
        return {"_k": "none"}
    if isinstance(v, (bool, int, float, str)):
        return {"_k": "scalar", "v": v}
    if isinstance(v, Belief):
        return {"_k": "belief", "v": pack_belief(v)}
    if isinstance(v, Manifold):
        return {"_k": "manifold", "v": pack_manifold(v)}
    if isinstance(v, D.Distribution):
        return {"_k": "dist", "v": pack_distribution(v)}
    if isinstance(v, (tuple, list)):
        return {"_k": "seq", "tuple": isinstance(v, tuple),
                "v": [_pack_value(x) for x in v]}
    try:
        return {"_k": "array", "v": _arr(v)}
    except (TypeError, ValueError) as e:
        raise TypeError(f"cannot pack custom field value {v!r}") from e


def _unpack_value(d, device):
    k = d["_k"]
    if k == "none":
        return None
    if k == "scalar":
        return d["v"]
    if k == "belief":
        return unpack_belief(d["v"], device)
    if k == "manifold":
        return unpack_manifold(d["v"])
    if k == "dist":
        return unpack_distribution(d["v"], device)
    if k == "seq":
        out = [_unpack_value(x, device) for x in d["v"]]
        return tuple(out) if d["tuple"] else out
    if k == "array":
        return _f32(d["v"], device)
    raise TypeError(f"unknown packed value kind {k}")


def _pack_model_custom(m):
    name = type(m).__name__
    if name not in M.MODEL_REGISTRY:
        return None
    _, children, aux = M.MODEL_REGISTRY[name]
    return {"_type": f"Custom:{name}",
            "children": {f: _pack_value(getattr(m, f)) for f in children},
            "aux": {f: _pack_value(getattr(m, f)) for f in aux}}


def _unpack_model_custom(d: Dict, device):
    t = d["_type"]
    if not t.startswith("Custom:"):
        return None
    name = t.split(":", 1)[1]
    if name not in M.MODEL_REGISTRY:
        raise TypeError(
            f"custom factor model {name!r} is not registered in this "
            f"process: import its module before load_graph")
    cls = M.MODEL_REGISTRY[name][0]
    m = object.__new__(cls)
    for f, v in (d["children"] | d["aux"]).items():
        object.__setattr__(m, f, _unpack_value(v, device))
    return m


# ---------------------------------------------------------------------------
# dispatch: each handler returns a packed dict / an instance, or None to
# pass to the next
# ---------------------------------------------------------------------------

_DIST_PACKERS = [_pack_ext, _pack_distribution_core]
_DIST_UNPACKERS = [_unpack_ext, _unpack_distribution_core]
_MODEL_PACKERS = [_pack_model_ext, _pack_factor_model_core,
                  _pack_model_custom]
_MODEL_UNPACKERS = [_unpack_model_ext, _unpack_factor_model_core,
                    _unpack_model_custom]


def pack_distribution(z) -> Dict:
    """Packed struct of any samplable distribution (reference
    packDistribution)."""
    for h in _DIST_PACKERS:
        out = h(z)
        if out is not None:
            return out
    raise TypeError(f"cannot pack distribution {type(z).__name__}")


def unpack_distribution(d: Dict, device=None):
    """Inverse of :func:`pack_distribution` (reference unpackDistribution);
    a KDE's belief lands on ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    for h in _DIST_UNPACKERS:
        out = h(d, device)
        if out is not None:
            return out
    raise TypeError(f"unknown packed distribution {d['_type']}")


def pack_factor_model(m) -> Dict:
    """Packed factor data (reference Packed* factor structs)."""
    for h in _MODEL_PACKERS:
        out = h(m)
        if out is not None:
            return out
    raise TypeError(f"cannot pack factor model {type(m).__name__}")


def unpack_factor_model(d: Dict, device=None):
    """Inverse of :func:`pack_factor_model` (reference reconstFactorData);
    tensors land on ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    for h in _MODEL_UNPACKERS:
        out = h(d, device)
        if out is not None:
            return out
    raise TypeError(f"unknown packed factor model {d['_type']}")

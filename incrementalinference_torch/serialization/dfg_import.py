"""Import of graphs saved by the reference ecosystem.

Counterpart of ``incrementalinference/jl_tpu/serialization/dfg_import.py``.
DistributedFactorGraphs.jl ``saveDFG`` writes a tar.gz (or directory) of
per-node JSON files: ``variables/<label>.json`` with the packed variable
data and ``factors/<label>.json`` whose ``data``/``fnctype`` fields carry
the packed-factor structs decoded here.  Schema sources in the reference:

- packed distributions (PackedNormal, PackedFullNormal, ...):
  src/Serialization/entities/SerializingDistributions.jl:22-66 and
  services/SerializingDistributions.jl:4-38;
- packed manifold KDE: src/Serialization/entities/AdditionalDensities.jl:2-9;
- packed factors (PackedPrior{Z}, PackedLinearRelative{Z}, PackedMixture
  {N,F_,S,components,diversity}, PackedPartialPrior{varType,Z,partials},
  PackedEuclidDistance, PackedPriorCircular, PackedCircularCircular):
  src/Factors/*.jl;
- the factor-node payload (fnc, multihypo, certainhypo, nullhypo,
  inflation): src/Serialization/services/DispatchPackedConversions.jl.

Julia is 1-indexed: ``partials`` and ``certainhypo`` arrive 1-based and
are shifted here.  Unknown packed types raise with the offending type.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tarfile
import tempfile
from typing import Dict

import numpy as np
import torch

from ..config import SolverParams
from ..distributions import (AliasingScalarSampler, Categorical,
                             ManifoldKernelDensity, MvNormal, Normal,
                             Rayleigh, Uniform)
from ..graph import Circular, ContinuousEuclid, FactorGraph, VariableType
from ..manifolds import SE2, SE3
from ..models.factors import (CircularCircular, EuclidDistance,
                              LinearRelative, Mixture, PartialPrior, Prior,
                              PriorCircular)

__all__ = ["load_dfg_archive"]

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# packed distributions (reference SerializingDistributions.jl)
# ---------------------------------------------------------------------------

def _tname(d: Dict) -> str:
    t = d.get("_type") or d.get("PackedSamplableTypeJSON") or ""
    return t.rsplit(".", 1)[-1]


def _unpack_dfg_distribution(d: Dict, device=None):
    t = _tname(d)
    if t == "PackedNormal":
        return Normal(float(d["mu"]), float(d["sigma"]))
    if t == "PackedFullNormal":
        mu = np.asarray(d["mu"], np.float32)
        cov = np.asarray(d["cov"], np.float32).reshape(len(mu), len(mu))
        return MvNormal(mu, cov)
    if t == "PackedDiagNormal":
        # 'diag' holds variances; a 1-D MvNormal covariance is std devs
        mu = np.asarray(d["mu"], np.float32)
        return MvNormal(mu, np.sqrt(np.asarray(d["diag"], np.float32)))
    if t == "PackedZeroMeanDiagNormal":
        var = np.asarray(d["diag"], np.float32)
        return MvNormal(np.zeros(len(var), np.float32), np.sqrt(var))
    if t == "PackedZeroMeanFullNormal":
        cov = np.asarray(d["cov"], np.float32)
        n = int(round(np.sqrt(cov.size)))
        return MvNormal(np.zeros(n, np.float32), cov.reshape(n, n))
    if t == "PackedUniform":
        return Uniform(float(d["a"]), float(d["b"]))
    if t == "PackedCategorical":
        p = np.asarray(d["p"], np.float32)
        return Categorical(p / p.sum())
    if t == "PackedRayleigh":
        return Rayleigh(float(d["sigma"]))
    if t == "PackedAliasingScalarSampler":
        return AliasingScalarSampler(np.asarray(d["domain"], np.float32),
                                     np.asarray(d["weights"], np.float32))
    if t == "PackedManifoldKernelDensity":
        pts = torch.as_tensor(np.asarray(d["pts"], np.float32),
                              device=device)          # (N, dim) rows
        man = _manifold_for_vartype(d.get("varType", ""))
        bw = d.get("bw") or None
        return ManifoldKernelDensity(man, pts, bw=bw)
    raise ValueError(
        f"unsupported packed distribution type {d.get('_type')!r}")


# ---------------------------------------------------------------------------
# variable types (reference @defVariable names as stored by DFG)
# ---------------------------------------------------------------------------

def _vartype_for_name(name: str):
    short = name.rsplit(".", 1)[-1]
    if short in ("ContinuousScalar", "ContinuousEuclid{1}", "Position{1}",
                 "Position1"):
        return ContinuousEuclid(1)
    for pat in ("ContinuousEuclid{", "Position{"):
        if short.startswith(pat):
            return ContinuousEuclid(int(short[len(pat):].rstrip("}")))
    if short == "Circular":
        return Circular
    if short in ("Pose2", "SpecialEuclidean(2)"):
        return VariableType("Pose2", SE2())
    if short in ("Pose3", "SpecialEuclidean(3)"):
        return VariableType("Pose3", SE3())
    raise ValueError(f"unsupported variable type {name!r}")


def _manifold_for_vartype(name: str):
    return _vartype_for_name(name or "ContinuousScalar").manifold


# ---------------------------------------------------------------------------
# packed factors (reference src/Factors/*.jl serialization blocks)
# ---------------------------------------------------------------------------

_DFG_SIMPLE = {"PackedPrior": Prior, "PackedLinearRelative": LinearRelative,
               "PackedEuclidDistance": EuclidDistance,
               "PackedPriorCircular": PriorCircular,
               "PackedCircularCircular": CircularCircular}


def _unpack_dfg_factor_model(fnc: Dict, fnctype: str, device=None):
    t = (fnctype or fnc.get("_type", "")).rsplit(".", 1)[-1]
    if t in _DFG_SIMPLE:
        return _DFG_SIMPLE[t](_unpack_dfg_distribution(fnc["Z"], device))
    if t == "PackedPartialPrior":
        partials = tuple(int(p) - 1 for p in fnc["partials"])   # 1-based
        return PartialPrior(_unpack_dfg_distribution(fnc["Z"], device),
                            partial=partials)
    if t == "PackedMixture":
        mech_name = fnc["F_"].rsplit(".", 1)[-1].replace("Packed", "")
        mech = {"Prior": Prior, "LinearRelative": LinearRelative,
                "EuclidDistance": EuclidDistance}.get(mech_name)
        if mech is None:
            raise ValueError(
                f"unsupported Mixture mechanics {fnc['F_']!r}")
        comps = [_unpack_dfg_distribution(c, device)
                 for c in fnc["components"]]
        div = fnc.get("diversity")
        weights = None
        if isinstance(div, dict) and _tname(div) == "PackedCategorical":
            weights = np.asarray(div["p"], np.float32)
        return Mixture(mech, comps, weights)
    raise ValueError(f"unsupported packed factor type {fnctype!r}")


# ---------------------------------------------------------------------------
# archive walking
# ---------------------------------------------------------------------------

def _iter_node_jsons(root: str, kind: str):
    """Parsed JSON of every ``**/<kind>/*.json`` under root."""
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        if os.path.basename(dirpath) != kind:
            continue
        for fn in sorted(filenames):
            if fn.endswith(".json"):
                with open(os.path.join(dirpath, fn)) as fp:
                    yield json.load(fp)


def _maybe_json(v):
    """DFG stores nested payloads either inline or as JSON strings."""
    if isinstance(v, str):
        return json.loads(v)
    return v


def load_dfg_archive(path: str, params=None, n_default: int = 100,
                     device=None) -> FactorGraph:
    """Load a reference-ecosystem saved graph (``saveDFG`` tar.gz or its
    unpacked directory) into a solvable :class:`FactorGraph` on ``device``
    (CUDA unless named).

    Restores variable types, stored particles and bandwidths
    (``vecval``/``vecbw``, point-major), factor models through the packed
    structs above, and multihypo/nullhypo (reference reconstFactorData).
    Per-factor ``inflation`` is not honoured: inflation is the solver-level
    ``SolverParams.inflation`` here, and a factor with another value logs a
    warning.  ``certainhypo`` follows from ``multihypo`` and is not kept.
    Variables without stored points start uninitialized."""
    if os.path.isfile(path):
        tmp = tempfile.mkdtemp(prefix="iitpu_dfg_")
        try:
            with tarfile.open(path, "r:*") as tf:
                tf.extractall(tmp, filter="data")
            return _load_dfg_tree(tmp, params, n_default, device)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return _load_dfg_tree(path, params, n_default, device)


def _tags(node: Dict) -> tuple:
    """Tags without the ':' prefix and the node-kind markers DFG adds
    (save_dfg_archive adds them back)."""
    return tuple(t.lstrip(":") for t in node.get("tags", [])
                 if t.lstrip(":") not in ("VARIABLE", "FACTOR"))


def _load_dfg_tree(root: str, params, n_default: int, device):
    fg = FactorGraph(params or SolverParams(), device=device)

    for vd in _iter_node_jsons(root, "variables"):
        label = vd["label"]
        vt = _vartype_for_name(vd.get("variableType", "ContinuousScalar"))
        solver = vd.get("solverDataDict") or {}
        if not solver and vd.get("solverData"):
            solver = {sd.get("solveKey", "default"): sd
                      for sd in map(_maybe_json, vd["solverData"])}
        sd = _maybe_json(solver.get("default")) if solver else None
        N = n_default
        if sd and sd.get("vecval"):
            dim = int(sd.get("dimval") or vt.manifold.point_dim)
            N = len(sd["vecval"]) // dim
        fg.add_variable(label, vt, N=N, tags=_tags(vd),
                        solvable=int(vd.get("solvable", 1)))
        if sd and sd.get("vecval"):
            pts = np.asarray(sd["vecval"], np.float32).reshape(N, dim)
            bw = None
            if sd.get("vecbw"):
                bw = torch.as_tensor(
                    np.asarray(sd["vecbw"], np.float32)[:vt.manifold.dof],
                    device=fg.device)
            fg.set_belief(label, torch.as_tensor(pts, device=fg.device),
                          bw=bw,
                          initialized=bool(sd.get("initialized", True)))

    for fd in _iter_node_jsons(root, "factors"):
        label = fd["label"]
        order = [str(s).lstrip(":") for s in
                 (fd.get("_variableOrderSymbols")
                  or fd.get("variableOrderSymbols") or [])]
        data = _maybe_json(fd.get("data") or {})
        fnc = _maybe_json(data.get("fnc") or fd.get("fnc") or {})
        model = _unpack_dfg_factor_model(fnc, fd.get("fnctype", ""),
                                         fg.device)
        multihypo = data.get("multihypo") or None
        nullhypo = float(data.get("nullhypo", 0.0))
        infl = data.get("inflation")
        if infl is not None and abs(float(infl)
                                    - fg.params.inflation) > 1e-9:
            logger.warning(
                "factor %s carries inflation=%s; the solver-level "
                "SolverParams.inflation=%s applies instead (per-factor "
                "inflation is not honoured)", label, infl,
                fg.params.inflation)
        fg.add_factor(order, model, multihypo=multihypo,
                      nullhypo=nullhypo, label=label, tags=_tags(fd),
                      solvable=int(fd.get("solvable", 1)),
                      graphinit=False)
    return fg

"""Export to the reference ecosystem's ``saveDFG`` archive format.

Counterpart of ``incrementalinference/jl_tpu/serialization/dfg_export.py``:
the same layout ``load_dfg_archive`` reads and the reference's
DistributedFactorGraphs ``loadDFG`` expects, field for field: per-node JSON
files under ``variables/`` and ``factors/``, with the reference's ``_type``
strings and field names.  Schema sources in the reference:

- packed distributions: src/Serialization/entities/
  SerializingDistributions.jl:22-66 and services/SerializingDistributions.jl
  (PackedNormal{mu,sigma}, PackedFullNormal{mu,cov=vec(Σ)},
  PackedUniform{a,b} with its PackedSamplableTypeJSON field,
  PackedCategorical{p}, PackedRayleigh{sigma},
  PackedAliasingScalarSampler{domain,weights});
- packed MKD: src/Serialization/entities/AdditionalDensities.jl:2-9;
- packed factors: src/Factors/*.jl (PackedPartialPrior with 1-based
  partials, PackedMixture{N,F_,S,components,diversity});
- the factor-node payload and certainhypo (1-based indices of the certain
  variables, or 1..n without multihypo):
  src/Serialization/services/DispatchPackedConversions.jl and
  src/services/CalcFactor.jl:374-378;
- solver data: point-major ``vecval`` and per-coordinate ``vecbw``.

Tensors leave through the host (float32, written as JSON doubles).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..distributions import (AliasingScalarSampler, Categorical,
                             ManifoldKernelDensity, MvNormal, Normal,
                             Rayleigh, Uniform)
from ..models.factors import Mixture, PartialPrior

__all__ = ["save_dfg_archive"]

_IIF = "IncrementalInference"


# ---------------------------------------------------------------------------
# distributions → reference packed dicts
# ---------------------------------------------------------------------------

def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _flist(a) -> List[float]:
    return [float(x) for x in _host64(a).ravel()]


def _pack_dfg_distribution(z, vartype_name: str | None = None) -> Dict:
    if isinstance(z, Normal):
        return {"_type": f"{_IIF}.PackedNormal",
                "mu": float(np.asarray(z.mu).ravel()[0]),
                "sigma": float(np.asarray(z.sigma).ravel()[0])}
    if isinstance(z, MvNormal):
        # always the full form: vec(Σ) row-major == column-major (symmetric)
        return {"_type": f"{_IIF}.PackedFullNormal",
                "mu": _flist(z.mu), "cov": _flist(z.cov)}
    if isinstance(z, Uniform):
        return {"_type": f"{_IIF}.PackedUniform",
                "a": float(z.a), "b": float(z.b),
                "PackedSamplableTypeJSON": f"{_IIF}.PackedUniform"}
    if isinstance(z, Categorical):
        return {"_type": f"{_IIF}.PackedCategorical", "p": _flist(z.p)}
    if isinstance(z, Rayleigh):
        return {"_type": f"{_IIF}.PackedRayleigh", "sigma": float(z.sigma)}
    if isinstance(z, AliasingScalarSampler):
        return {"_type": f"{_IIF}.PackedAliasingScalarSampler",
                "domain": _flist(z.x), "weights": _flist(z.weights)}
    if isinstance(z, ManifoldKernelDensity):
        pts = _host64(z.points)
        zbw = getattr(z.belief, "bw", None)
        bw = _flist(zbw) if zbw is not None else []
        return {"_type": f"{_IIF}.PackedManifoldKernelDensity",
                "varType": vartype_name or "ContinuousScalar",
                "pts": [[float(c) for c in row] for row in pts],
                "bw": bw, "partial": [],
                "infoPerCoord": [0.0] * int(pts.shape[1])}
    raise ValueError(
        f"cannot export distribution {type(z).__name__} to saveDFG form")


# ---------------------------------------------------------------------------
# variable types → reference names
# ---------------------------------------------------------------------------

def _dfg_vartype_name(vt) -> str:
    name = vt.name
    if name in ("ContinuousScalar", "ContinuousEuclid1", "Position1",
                "ContinuousEuclid{1}"):
        return f"{_IIF}.ContinuousScalar"
    for pat, tmpl in (("ContinuousEuclid", _IIF + ".ContinuousEuclid{{{n}}}"),
                      ("Position", _IIF + ".Position{{{n}}}")):
        if name.startswith(pat) and name[len(pat):].strip("{}").isdigit():
            return tmpl.format(n=int(name[len(pat):].strip("{}")))
    if name == "Circular":
        return f"{_IIF}.Circular"
    if name == "Pose2":
        return "RoME.Pose2"
    if name == "Pose3":
        return "RoME.Pose3"
    raise ValueError(
        f"cannot export variable type {name!r} to saveDFG form")


# ---------------------------------------------------------------------------
# factor models → reference packed dicts
# ---------------------------------------------------------------------------

_PACKED_NAMES = {"Prior": "PackedPrior",
                 "LinearRelative": "PackedLinearRelative",
                 "EuclidDistance": "PackedEuclidDistance",
                 "PriorCircular": "PackedPriorCircular",
                 "CircularCircular": "PackedCircularCircular",
                 "PartialPrior": "PackedPartialPrior",
                 "Mixture": "PackedMixture"}


def _pack_dfg_factor_model(model, vartype_name: str):
    """Return (fnc dict, fnctype string) for the reference packed form."""
    cls = type(model).__name__
    packed = _PACKED_NAMES.get(cls)
    if packed is None:
        raise ValueError(
            f"cannot export factor model {cls} to saveDFG form "
            f"(supported: {sorted(_PACKED_NAMES)})")
    fnctype = f"{_IIF}.{packed}"
    if isinstance(model, Mixture):
        comps = [_pack_dfg_distribution(c, vartype_name)
                 for c in model.components]
        mech_cls = type(model.mechanics).__name__
        mech_packed = _PACKED_NAMES.get(mech_cls)
        if mech_packed is None:
            raise ValueError(
                f"cannot export Mixture mechanics {mech_cls} to saveDFG")
        fnc = {"_type": fnctype,
               "N": len(comps),
               "F_": f"{_IIF}.{mech_packed}",
               "S": [c["_type"].rsplit(".", 1)[-1] for c in comps],
               "components": comps,
               "diversity": {"_type": f"{_IIF}.PackedCategorical",
                             "p": _flist(model.diversity)}}
        return fnc, fnctype
    if isinstance(model, PartialPrior):
        return ({"_type": fnctype,
                 "varType": vartype_name,
                 "Z": _pack_dfg_distribution(model.Z, vartype_name),
                 "partials": [int(i) + 1 for i in model.partial]},  # 1-based
                fnctype)
    # NOTE: the reference's PackedEuclidDistance declares a quirky leading
    # _type of "/application/JuliaLang/PackedSamplableBelief"
    # (src/Factors/EuclidDistance.jl:30-38); this export keeps the
    # packed-struct NAME in _type instead — the reference dispatches on
    # the node-level fnctype, and the symmetric re-import here reads it
    return ({"_type": fnctype,
             "Z": _pack_dfg_distribution(model.Z, vartype_name)}, fnctype)


# ---------------------------------------------------------------------------
# node JSON assembly
# ---------------------------------------------------------------------------

def _timestamp(ts: float) -> str:
    t = time.gmtime(ts if ts else time.time())
    return time.strftime("%Y-%m-%dT%H:%M:%S", t) + ".000Z"


def _variable_json(fg, var, solve_key: str) -> Dict:
    d = {"label": var.label,
         "variableType": _dfg_vartype_name(var.vartype),
         "tags": [":VARIABLE"] + [f":{t}" for t in sorted(var.tags)
                                  if t != "VARIABLE"],
         "nstime": "0",
         "timestamp": _timestamp(var.timestamp),
         "solvable": int(var.solvable),
         "smallData": "{}"}
    bel = var.beliefs.get(solve_key)
    if bel is not None:
        pts = _host64(bel.points)
        N, dim = pts.shape
        sd = {"solveKey": solve_key,
              "vecval": _flist(pts),                     # point-major rows
              "dimval": int(dim),
              "vecbw": _flist(bel.bw) if bel.bw is not None else [],
              "dimbw": int(var.vartype.manifold.dof),
              "N": int(N),
              "initialized": bool(var.initialized.get(solve_key, True)),
              "infoPerCoord": _flist(bel.ipc)
              if getattr(bel, "ipc", None) is not None else [],
              "variableType": d["variableType"]}
        d["solverData"] = [json.dumps(sd)]
    return d


def _factor_json(fg, fct, inflation: float) -> Dict:
    vt_name = _dfg_vartype_name(fg.var(fct.variables[0]).vartype)
    fnc, fnctype = _pack_dfg_factor_model(fct.model, vt_name)
    if fct.multihypo is not None:
        mh = [float(w) for w in fct.multihypo]
        # reference certainhypo: 1-based indices whose (parsed) weight is
        # zero — user weights >= 1-1e-10 are zeroed by parseusermultihypo
        certain = [i + 1 for i, w in enumerate(mh)
                   if w >= 1.0 - 1e-10 or w == 0.0]
    else:
        mh = []
        certain = list(range(1, len(fct.variables) + 1))
    data = {"eliminated": False,
            "potentialused": False,
            "edgeIDs": [],
            "fnc": fnc,
            "multihypo": mh,
            "certainhypo": certain,
            "nullhypo": float(fct.nullhypo),
            "solveInProgress": 0,
            "inflation": float(inflation)}
    return {"label": fct.label,
            "tags": [":FACTOR"] + [f":{t}" for t in sorted(fct.tags)
                                   if t != "FACTOR"],
            "_variableOrderSymbols": [f":{v}" for v in fct.variables],
            "nstime": "0",
            "timestamp": _timestamp(fct.timestamp),
            "fnctype": fnctype,
            "solvable": int(fct.solvable),
            "data": json.dumps(data)}


# ---------------------------------------------------------------------------
# archive writing
# ---------------------------------------------------------------------------

def save_dfg_archive(fg, path: str, solve_key: str = "default",
                     include_solver_data: bool = True) -> str:
    """Write ``fg`` as a reference-ecosystem ``saveDFG`` archive.

    ``path`` ending in ``.tar.gz`` writes the tarball the reference's
    ``loadDFG`` unpacks; any other path is created as the equivalent
    directory tree.  Solver data (particle values/bandwidths for
    ``solve_key``) is embedded unless ``include_solver_data=False``
    (parch-style hollow export, reference parchDistribution,
    SerializationMKD.jl:30-44).

    Round-trip guarantee: an archive written here re-imports through
    :func:`~.dfg_import.load_dfg_archive` with model equality and solve
    parity (tests/test_dfg_import.py).  Returns ``path``."""
    var_jsons = {}
    for label in sorted(fg.variables):
        var = fg.var(label)
        d = _variable_json(fg, var, solve_key)
        if not include_solver_data:
            d.pop("solverData", None)
        var_jsons[label] = d
    fct_jsons = {f.label: _factor_json(fg, f, fg.params.inflation)
                 for f in (fg.factors[k] for k in sorted(fg.factors))}

    if path.endswith((".tar.gz", ".tgz")):
        base = os.path.basename(path)
        base = base[:-7] if base.endswith(".tar.gz") else base[:-4]
        with tarfile.open(path, "w:gz") as tf:
            for label, d in var_jsons.items():
                _tar_add_json(tf, f"{base}/variables/{label}.json", d)
            for label, d in fct_jsons.items():
                _tar_add_json(tf, f"{base}/factors/{label}.json", d)
        return path

    os.makedirs(os.path.join(path, "variables"), exist_ok=True)
    os.makedirs(os.path.join(path, "factors"), exist_ok=True)
    for label, d in var_jsons.items():
        with open(os.path.join(path, "variables", f"{label}.json"),
                  "w") as fp:
            json.dump(d, fp, indent=1)
    for label, d in fct_jsons.items():
        with open(os.path.join(path, "factors", f"{label}.json"),
                  "w") as fp:
            json.dump(d, fp, indent=1)
    return path


def _tar_add_json(tf: tarfile.TarFile, name: str, obj: Dict) -> None:
    raw = json.dumps(obj, indent=1).encode()
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    info.mtime = int(time.time())
    tf.addfile(info, io.BytesIO(raw))

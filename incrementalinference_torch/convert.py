"""Carry a factor graph's state across as plain arrays.

This system has no weights: its state is the graph — variables with belief
points and bandwidths, factors with their model parameters.
:func:`graph_from_arrays` builds a graph on a device from a dict of plain
numpy and Python values, and :func:`graph_to_arrays` is its inverse.  A
graph from another implementation (the JAX package) converts to the same
dict, so both start from identical particles.

The dict::

    {"params": {SolverParams field: value, ...},          # optional
     "variables": [{"label", "type": "ContinuousScalar" | "ContinuousEuclid<n>",
                    "N", "solvable", "tags",
                    "points": (N, d) array or None (uninitialized),
                    "bw": (dof,) array or None (LOO-selected),
                    "ipc": (dof,) array or None}, ...],
     "factors": [{"label", "type": "Prior" | "LinearRelative" | ...,
                  "variables": [labels], "Z": distribution dict,
                  "multihypo", "nullhypo", "solvable", "tags"}, ...]}

with a distribution dict ``{"type": "Normal", "mu", "sigma"}`` or
``{"type": "MvNormal", "mu", "cov"}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import re

import numpy as np
import torch

from .config import SolverParams
from .distributions import MvNormal, Normal
from .graph import ContinuousEuclid, ContinuousScalar, FactorGraph
from .models.factors import MODEL_REGISTRY

__all__ = ["graph_from_arrays", "graph_to_arrays"]


def _vartype(name: str):
    if name == "ContinuousScalar":
        return ContinuousScalar
    m = re.fullmatch(r"ContinuousEuclid(\d+)", name)
    if m:
        return ContinuousEuclid(int(m.group(1)))
    raise ValueError(f"unsupported variable type {name!r}")


def _dist_from(d: dict):
    if d["type"] == "Normal":
        return Normal(float(np.asarray(d["mu"])),
                      float(np.asarray(d["sigma"])))
    if d["type"] == "MvNormal":
        return MvNormal(np.asarray(d["mu"], np.float32),
                        np.asarray(d["cov"], np.float32))
    raise ValueError(f"unsupported distribution {d['type']!r}")


def _dist_to(z) -> dict:
    if isinstance(z, Normal):
        return {"type": "Normal", "mu": float(z.mu), "sigma": float(z.sigma)}
    if isinstance(z, MvNormal):
        return {"type": "MvNormal", "mu": np.asarray(z.mu),
                "cov": np.asarray(z.cov)}
    raise ValueError(f"unsupported distribution {type(z).__name__}")


def _tensor(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def graph_from_arrays(spec: dict, device=None) -> FactorGraph:
    """Build a :class:`FactorGraph` on ``device`` (CUDA by default) from
    the dict described in the module docstring.  Factors are added without
    graphinit: the beliefs come from the dict."""
    params = SolverParams(**spec.get("params", {}))
    fg = FactorGraph(params, device=device)
    for v in spec["variables"]:
        fg.add_variable(v["label"], _vartype(v["type"]), N=v.get("N"),
                        tags=v.get("tags", ()),
                        solvable=v.get("solvable", 1))
        if v.get("points") is not None:
            bw, ipc = v.get("bw"), v.get("ipc")
            fg.set_belief(
                v["label"], _tensor(v["points"], fg.device),
                bw=None if bw is None else _tensor(bw, fg.device),
                ipc=None if ipc is None else _tensor(ipc, fg.device))
    for f in spec["factors"]:
        if f["type"] not in MODEL_REGISTRY:
            raise ValueError(f"unsupported factor type {f['type']!r}")
        cls, _ = MODEL_REGISTRY[f["type"]]
        model = cls(_dist_from(f["Z"])) if "Z" in f else cls()
        fg.add_factor(f["variables"], model, multihypo=f.get("multihypo"),
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
            "label": v.label, "type": v.vartype.name, "N": v.N,
            "solvable": v.solvable, "tags": sorted(v.tags),
            "points": None if b is None else b.points.cpu().numpy(),
            "bw": None if b is None else b.bw.cpu().numpy(),
            "ipc": None if b is None else b.ipc.cpu().numpy(),
        })
    factors = []
    for f in fg.factors.values():
        d = {"label": f.label, "type": type(f.model).__name__,
             "variables": list(f.variables),
             "multihypo": None if f.multihypo is None else list(f.multihypo),
             "nullhypo": f.nullhypo, "solvable": f.solvable,
             "tags": sorted(f.tags)}
        if hasattr(f.model, "Z"):
            d["Z"] = _dist_to(f.model.Z)
        factors.append(d)
    return {"params": dataclasses.asdict(fg.params), "variables": variables,
            "factors": factors}

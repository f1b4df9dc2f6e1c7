"""Graph accessor surface: the get/set/list/find utilities a user reaches
for daily.

Counterpart of ``incrementalinference/jl_tpu/fgos.py`` (reference DFG
accessors and FGOSUtils.jl, SolverUtilities fastnorm, TetherUtils
cont2disc, FactorGraph.jl reshapeVec2Mat, DeconvUtils deconvSolveKey).
Host-side structural code; beliefs stay tensors on the graph's device.
``get_ppe_*``, ``calc_variable_ppe`` and ``find_variables_near`` read PPEs:
the KDE of all N particles at each of them, O(N²·dof) work, streamed
through one kernel on the card (Euclidean and SE(2)) or in chunks of at
most ``beliefs._KDE_CHUNK_PAIRS`` pairs, so a read holds a few GiB at most
(SE(3), the costliest manifold) at any N the solves reach.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import keys as _keys
from .distributions import host32
from .graph import Factor, FactorGraph, Variable, VariableType

__all__ = [
    "get_variable", "get_factor", "list_variables", "list_factors",
    "is_variable", "is_factor", "ls2", "get_label", "get_tags",
    "get_timestamp",
    "get_variable_type", "get_variable_dim", "get_factor_type",
    "get_factor_dim", "get_dimension", "get_solvable", "set_solvable",
    "get_bw", "set_bw", "get_num_pts", "get_val", "set_val",
    "get_ppe_dict", "get_variable_ppe", "get_ppe_mean", "get_ppe_max",
    "get_ppe_suggested", "get_ppe_suggested_all", "calc_variable_ppe",
    "set_solved_count", "set_marginalized", "is_marginalized",
    "unfreeze_variables_all", "dont_marginalize_variables_all",
    "copy_graph", "deepcopy_graph", "sort_dfg", "get_variable_order",
    "find_variables_near", "find_closest_timestamp",
    "find_factors_between_from", "get_factors_among_variables_only",
    "list_solve_keys", "list_supersolves", "clone_solve_key",
    "delete_variable_solver_data", "reset_variable",
    "reset_variable_all_initializations", "set_variable_initialized",
    "set_variable_infer_dim", "set_variable_reference",
    "get_measurements", "deconv_solve_key",
    "fastnorm", "reshape_vec2mat", "cont2disc",
    "print_variable", "print_factor", "print_graph_summary",
    "get_variables", "get_factors", "get_solver_data", "get_bw_val",
    "get_point_identity", "get_point_type", "get_multihypo_distribution",
    "get_log_path", "join_log_path", "ls_types", "lsf_types", "lsf_priors",
    "list_type_tree", "get_current_workspace_factors",
    "get_current_workspace_variables", "make_solver_data",
    "init_variable_manual",
    "reset_init_values", "reset_factor_graph_new_tree",
    "default_fixed_lag_on_tree", "normal_from_string",
    "categorical_from_string", "extract_distribution",
]


def _tensor(a, device) -> torch.Tensor:
    """A float32 tensor of ``a`` (an array, a list or a tensor) on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)



# ---------------------------------------------------------------------------
# basic get/list (reference DFG getVariable/getFactor/listVariables/...)
# ---------------------------------------------------------------------------

def get_variable(fg: FactorGraph, label: str) -> Variable:
    """Reference DFG ``getVariable``."""
    return fg.variables[label]


def get_factor(fg: FactorGraph, label: str) -> Factor:
    """Reference DFG ``getFactor``."""
    return fg.factors[label]


def _regex_filter(labels: List[str], regex) -> List[str]:
    if regex is None:
        return labels
    pat = re.compile(regex)
    return [l for l in labels if pat.search(l)]


def list_variables(fg: FactorGraph, regex=None, tags: Iterable[str] = (),
                   solvable: int = 0) -> List[str]:
    """Reference DFG ``listVariables`` / ``ls2`` — optional label regex,
    tag filter, and minimum solvable level."""
    out = fg.ls(tags=tags)
    out = [l for l in out if fg.var(l).solvable >= solvable]
    return _regex_filter(out, regex)


def list_factors(fg: FactorGraph, regex=None, tags: Iterable[str] = (),
                 solvable: int = 0) -> List[str]:
    """Reference DFG ``listFactors`` / ``lsf`` with filters."""
    out = fg.lsf(tags=tags)
    out = [l for l in out if fg.factor(l).solvable >= solvable]
    return _regex_filter(out, regex)


def is_variable(fg: FactorGraph, label: str) -> bool:
    """Reference DFG ``isVariable``."""
    return label in fg.variables


def is_factor(fg: FactorGraph, label: str) -> bool:
    """Reference DFG ``isFactor``."""
    return label in fg.factors


def ls2(fg: FactorGraph, label: str) -> List[str]:
    """Variables reachable through ``label``'s factors — the reference's
    two-hop neighborhood ``ls2(dfg, sym)`` (used to pick autoinit
    neighbors, src/parametric/services/ParametricManopt.jl:532)."""
    out = set()
    for fl in fg.factors_of(label):
        out.update(fg.factor(fl).variables)
    out.discard(label)
    return sorted(out)


def _node(fg: FactorGraph, label: str):
    if label in fg.variables:
        return fg.variables[label]
    if label in fg.factors:
        return fg.factors[label]
    raise KeyError(f"unknown node {label!r}")


def get_label(node) -> str:
    """Reference DFG ``getLabel``."""
    return node.label


def get_tags(fg: FactorGraph, label: str) -> set:
    """Reference DFG ``getTags``."""
    return _node(fg, label).tags


def get_timestamp(fg: FactorGraph, label: str) -> float:
    """Reference DFG ``getTimestamp`` (seconds since epoch here)."""
    return _node(fg, label).timestamp


def get_variable_type(fg: FactorGraph, label: str) -> VariableType:
    """Reference ``getVariableType`` / ``getSofttype``."""
    return fg.var(label).vartype


def get_variable_dim(fg: FactorGraph, label: str) -> int:
    """Reference ``getVariableDim`` / ``getDimension`` — manifold dof."""
    return fg.var(label).manifold.dof


def get_dimension(obj) -> int:
    """Reference ``getDimension`` on a variable-type/manifold/variable."""
    if hasattr(obj, "manifold"):
        return obj.manifold.dof
    if hasattr(obj, "dof"):
        return obj.dof
    raise TypeError(f"no dimension on {type(obj).__name__}")


def get_factor_type(fg: FactorGraph, label: str):
    """Reference ``getFactorType`` — the user factor model object."""
    return fg.factor(label).model


def get_factor_dim(fg: FactorGraph, label: str) -> int:
    """Reference ``getFactorDim`` — measurement z-dim (calcZDim,
    src/services/CalcFactor.jl:82-98)."""
    f = fg.factor(label)
    z = f.model.sample(_keys.generator(fg.next_key(), fg.device), 1)
    return int(z.reshape(z.shape[0], -1).shape[-1])


def get_solvable(fg: FactorGraph, label: str) -> int:
    """Reference DFG ``getSolvable``."""
    return _node(fg, label).solvable


def set_solvable(fg: FactorGraph, label: str, level: int) -> int:
    """Reference DFG ``setSolvable!``."""
    _node(fg, label).solvable = int(level)
    return int(level)


# ---------------------------------------------------------------------------
# belief-array accessors (reference getBW/getVal/setVal!/getNumPts)
# ---------------------------------------------------------------------------

def get_val(fg: FactorGraph, label: str, solve_key: str = "default"):
    """Reference ``getVal`` — the particle point block."""
    return fg.points(label, solve_key)


def set_val(fg: FactorGraph, label: str, points,
            solve_key: str = "default") -> None:
    """Reference ``setVal!`` — replace points, re-derive bandwidths."""
    fg.set_belief(label, _tensor(points, fg.device), solve_key=solve_key)


def get_bw(fg: FactorGraph, label: str, solve_key: str = "default"):
    """Reference ``getBW`` — KDE bandwidths of the stored belief."""
    return fg.get_belief(label, solve_key).bw


def set_bw(fg: FactorGraph, label: str, bw,
           solve_key: str = "default") -> None:
    """Reference ``setBW!``."""
    from .beliefs import Belief
    v = fg.var(label)
    b = v.beliefs[solve_key]
    v.beliefs[solve_key] = Belief(points=b.points,
                                  bw=_tensor(bw, b.points.device), ipc=b.ipc)


def get_num_pts(fg: FactorGraph, label: str,
                solve_key: str = "default") -> int:
    """Reference ``getNumPts``."""
    return int(fg.points(label, solve_key).shape[0])


# ---------------------------------------------------------------------------
# PPE accessors (reference getPPE* family, DFG + FGOSUtils.jl:237-274)
# ---------------------------------------------------------------------------

def get_ppe_dict(fg: FactorGraph, label: str) -> Dict[str, dict]:
    """Reference ``getPPEDict`` — all stored PPEs keyed by solveKey."""
    return fg.var(label).ppe


def get_variable_ppe(fg: FactorGraph, label: str,
                     solve_key: str = "default") -> dict:
    """Reference ``getVariablePPE`` / ``getPPE``."""
    return fg.var(label).ppe[solve_key]


def get_ppe_mean(fg: FactorGraph, label: str, solve_key: str = "default"):
    """Reference ``getPPEMean``."""
    return get_variable_ppe(fg, label, solve_key)["mean"]


def get_ppe_max(fg: FactorGraph, label: str, solve_key: str = "default"):
    """Reference ``getPPEMax``."""
    return get_variable_ppe(fg, label, solve_key)["max"]


def get_ppe_suggested(fg: FactorGraph, label: str,
                      solve_key: str = "default"):
    """Reference ``getPPESuggested``."""
    return get_variable_ppe(fg, label, solve_key)["suggested"]


def get_ppe_suggested_all(fg: FactorGraph, regex=None,
                          solve_key: str = "default"
                          ) -> Tuple[List[str], np.ndarray]:
    """Reference ``getPPESuggestedAll`` (FGOSUtils.jl:398-421): labels plus
    a stacked (nvars, maxdim) suggested-estimate matrix."""
    labels = [l for l in _regex_filter(fg.ls(), regex)
              if solve_key in fg.var(l).ppe]
    if not labels:
        return [], np.zeros((0, 0))
    vals = [np.atleast_1d(host32(fg.var(l).ppe[solve_key]["suggested"]))
            for l in labels]
    maxdim = max(v.shape[0] for v in vals)
    mat = np.zeros((len(vals), maxdim))
    for i, v in enumerate(vals):
        mat[i, :v.shape[0]] = v
    return labels, mat


def calc_variable_ppe(fg: FactorGraph, label: str,
                      solve_key: str = "default") -> dict:
    """Reference ``calcVariablePPE`` — compute (without storing) the
    MeanMaxPPE from the current belief."""
    from .beliefs import ppe as _ppe
    v = fg.var(label)
    return _ppe(v.manifold, fg.get_belief(label, solve_key))


# ---------------------------------------------------------------------------
# solver-data mutation (reference set*/reset* family)
# ---------------------------------------------------------------------------

def set_solved_count(fg: FactorGraph, label: str, count: int,
                     solve_key: str = "default") -> None:
    """Reference ``setSolvedCount!``."""
    fg.var(label).solved_count[solve_key] = int(count)


def set_marginalized(fg: FactorGraph, label: str, flag: bool = True) -> None:
    """Reference ``setMarginalized!``."""
    fg.var(label).marginalized = bool(flag)


def is_marginalized(fg: FactorGraph, label: str) -> bool:
    """Reference ``isMarginalized``."""
    return fg.var(label).marginalized


def unfreeze_variables_all(fg: FactorGraph,
                           labels: Optional[Sequence[str]] = None
                           ) -> List[str]:
    """Reference ``unfreezeVariablesAll`` — clear fixed-lag marginalized
    flags."""
    labels = list(labels) if labels is not None else fg.ls()
    out = []
    for l in labels:
        v = fg.var(l)
        if v.marginalized:
            v.marginalized = False
            out.append(l)
    return out


def dont_marginalize_variables_all(fg: FactorGraph) -> List[str]:
    """Reference ``dontMarginalizeVariablesAll!`` — unfreeze everything and
    disable the fixed-lag window."""
    fg.params = fg.params.replace(is_fixed_lag=False)
    return unfreeze_variables_all(fg)


def set_variable_initialized(fg: FactorGraph, label: str, flag: bool,
                             solve_key: str = "default") -> None:
    """Reference ``setVariableInitialized!``."""
    fg.var(label).initialized[solve_key] = bool(flag)


def set_variable_infer_dim(fg: FactorGraph, label: str, ipc,
                           solve_key: str = "default") -> None:
    """Reference ``setVariableInferDim!`` — overwrite infoPerCoord."""
    from .beliefs import Belief
    v = fg.var(label)
    b = v.beliefs[solve_key]
    ipc = torch.broadcast_to(_tensor(ipc, b.ipc.device), b.ipc.shape)
    v.beliefs[solve_key] = Belief(points=b.points, bw=b.bw,
                                  ipc=ipc.clone())


def reset_variable(fg: FactorGraph, label: str,
                   solve_key: str = "default") -> None:
    """Reference ``resetVariable!`` — zero the solver data for one solveKey
    (back to uninitialized identity points)."""
    v = fg.var(label)
    v.beliefs.pop(solve_key, None)
    v.initialized[solve_key] = False
    v.ppe.pop(solve_key, None)
    v.solved_count[solve_key] = 0


def reset_variable_all_initializations(fg: FactorGraph) -> List[str]:
    """Reference ``resetVariableAllInitializations!``."""
    out = []
    for l in fg.ls():
        reset_variable(fg, l)
        out.append(l)
    return out


def delete_variable_solver_data(fg: FactorGraph, label: str,
                                solve_key: str) -> None:
    """Reference DFG ``deleteVariableSolverData!`` — drop a solveKey."""
    v = fg.var(label)
    v.beliefs.pop(solve_key, None)
    v.initialized.pop(solve_key, None)
    v.ppe.pop(solve_key, None)
    v.solved_count.pop(solve_key, None)


def set_variable_reference(fg: FactorGraph, label: str, points,
                           solve_key: str = "reference") -> None:
    """Reference ``setVariableRefence!`` — store ground-truth/reference
    points under a dedicated solveKey (used by simulation comparisons)."""
    fg.set_belief(label, _tensor(points, fg.device), solve_key=solve_key)
    fg.var(label).solved_count.setdefault(solve_key, 0)


def list_solve_keys(fg: FactorGraph, label: Optional[str] = None) -> set:
    """Reference ``listSolveKeys`` — union over variables (or one)."""
    labels = [label] if label is not None else fg.ls()
    out = set()
    for l in labels:
        out |= set(fg.var(l).beliefs.keys())
    return out


def list_supersolves(fg: FactorGraph, label: Optional[str] = None) -> set:
    """Reference ``listSupersolves`` (alias of listSolveKeys)."""
    return list_solve_keys(fg, label)


def clone_solve_key(fg: FactorGraph, dest: str, src: str = "default",
                    solvable: int = 0) -> List[str]:
    """Reference DFG ``cloneSolveKey!`` — copy one solveKey's solver data to
    another across all (sufficiently solvable) variables."""
    out = []
    for l in list_variables(fg, solvable=solvable):
        v = fg.var(l)
        if src in v.beliefs:
            v.beliefs[dest] = v.beliefs[src]
            v.initialized[dest] = v.initialized.get(src, False)
            if src in v.ppe:
                v.ppe[dest] = v.ppe[src]
            v.solved_count[dest] = v.solved_count.get(src, 0)
            out.append(l)
    return out


# ---------------------------------------------------------------------------
# graph copies / ordering / search (reference copyGraph, sortDFG, find*)
# ---------------------------------------------------------------------------

def deepcopy_graph(fg: FactorGraph) -> FactorGraph:
    """Reference ``deepcopyGraph`` — full structural + solver-data copy on
    the same device.  Belief tensors are shared, as the JAX package shares
    its immutable arrays: no solver writes a belief tensor in place (a new
    belief replaces the old one)."""
    new = FactorGraph(fg.params, device=fg.device)
    for l in fg.ls():
        v = fg.var(l)
        nv = copy.copy(v)
        nv.tags = set(v.tags)
        nv.beliefs = dict(v.beliefs)
        nv.initialized = dict(v.initialized)
        nv.ppe = dict(v.ppe)
        nv.solved_count = dict(v.solved_count)
        nv.data = dict(v.data)
        new.variables[l] = nv
        new._var_factors[l] = list(fg._var_factors[l])
    for l, f in fg.factors.items():
        nf = copy.copy(f)
        nf.tags = set(f.tags)
        new.factors[l] = nf
    return new


def copy_graph(fg: FactorGraph, variables: Sequence[str],
               factors: Optional[Sequence[str]] = None) -> FactorGraph:
    """Reference DFG ``copyGraph!``/``buildSubgraph`` — copy a subset of
    variables (and the factors fully contained among them, or an explicit
    factor list) into a fresh graph."""
    new = FactorGraph(fg.params, device=fg.device)
    varset = set(variables)
    for l in variables:
        v = fg.var(l)
        nv = copy.copy(v)
        nv.beliefs = dict(v.beliefs)
        nv.initialized = dict(v.initialized)
        nv.ppe = dict(v.ppe)
        nv.solved_count = dict(v.solved_count)
        new.variables[l] = nv
        new._var_factors[l] = []
    if factors is None:
        factors = [fl for fl, f in fg.factors.items()
                   if set(f.variables) <= varset]
    for fl in factors:
        f = fg.factor(fl)
        if not set(f.variables) <= varset:
            raise ValueError(f"factor {fl!r} references variables outside "
                             "the copied subset")
        new.factors[fl] = copy.copy(f)
        for vl in f.variables:
            new._var_factors[vl].append(fl)
    return new


def _natural_key(label: str):
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", label)]


def sort_dfg(labels: Iterable[str], lt=None, by=None) -> List[str]:
    """Reference ``sortDFG`` — natural sort of variable/factor labels
    (x1 < x2 < x10)."""
    key = by or _natural_key
    return sorted(labels, key=key)


def get_variable_order(fg: FactorGraph, solvable: int = 0) -> List[str]:
    """Reference ``getVariableOrder`` on a graph — natural-sorted labels."""
    return sort_dfg(list_variables(fg, solvable=solvable))


def find_variables_near(fg: FactorGraph, loc: Sequence[float], regex=None,
                        number: int = 3,
                        solve_key: str = "default"
                        ) -> Tuple[List[str], List[float]]:
    """Reference ``findVariablesNear`` (FGOSUtils.jl:425-437): the
    ``number`` variables whose suggested PPE is closest to ``loc``."""
    labels, mat = get_ppe_suggested_all(fg, regex, solve_key=solve_key)
    if not labels:
        return [], []
    loc = np.asarray(loc, dtype=float)
    d = np.sqrt(((mat[:, :loc.shape[0]] - loc[None, :]) ** 2).sum(axis=1))
    order = np.argsort(d)[:number]
    return [labels[i] for i in order], [float(d[i]) for i in order]


def find_closest_timestamp(fg: FactorGraph, ts: float,
                           labels: Optional[Sequence[str]] = None) -> str:
    """Reference DFG ``findClosestTimestamp`` — nearest-created node."""
    labels = list(labels) if labels is not None else fg.ls()
    if not labels:
        raise ValueError("empty graph")
    return min(labels, key=lambda l: abs(_node(fg, l).timestamp - ts))


def find_factors_between_from(fg: FactorGraph, between: Sequence[str],
                              from_var: str) -> List[str]:
    """Reference ``findFactorsBetweenFrom`` (FGOSUtils.jl:447-469): factors
    on ``from_var`` whose full neighborhood lies within ``between``."""
    between = set(between)
    out = []
    for fl in fg.factors_of(from_var):
        if set(fg.factor(fl).variables) <= between:
            out.append(fl)
    return out


def get_factors_among_variables_only(fg: FactorGraph,
                                     varlist: Sequence[str],
                                     unused: bool = True) -> List[str]:
    """Reference ``getFactorsAmongVariablesOnly`` (FGOSUtils.jl:481-508):
    factors fully contained in ``varlist`` (optionally only those not yet
    consumed by symbolic elimination — ``potential_used``)."""
    varset = set(varlist)
    seen, out = set(), []
    for vl in varlist:
        for fl in fg.factors_of(vl):
            if fl in seen:
                continue
            seen.add(fl)
            f = fg.factor(fl)
            if not set(f.variables) <= varset:
                continue
            if unused and f.potential_used:
                continue
            out.append(fl)
    return out


# ---------------------------------------------------------------------------
# measurements / deconv across solve keys
# ---------------------------------------------------------------------------

def get_measurements(fg: FactorGraph, factor_label: str,
                     n: Optional[int] = None):
    """Reference ``getMeasurements``/``sampleFactor`` on a graph factor —
    draw n generative measurement samples."""
    f = fg.factor(factor_label)
    n = n or fg.params.N
    return f.model.sample(_keys.generator(fg.next_key(), fg.device), n)


def deconv_solve_key(fg: FactorGraph, ref_sym: str, ref_key: str,
                     tst_sym: str, tst_key: str):
    """Reference ``deconvSolveKey`` (DeconvUtils.jl:263-306): measure the
    implied relative transform between two solveKeys' estimates of (possibly
    the same) variable by deconvolving a default relative factor in a temp
    two-variable graph.  Returns (solved_meas, sampled_meas)."""
    from .ops.deconv import approx_deconv
    from .utils.defaults import select_factor_type

    tfg = FactorGraph(fg.params, device=fg.device)
    vref = fg.var(ref_sym)
    vtst = fg.var(tst_sym)
    tfg.add_variable(ref_sym + "_ref", vref.vartype, N=vref.N)
    tfg.add_variable(tst_sym + "_tst", vtst.vartype, N=vtst.N)
    bref = fg.get_belief(ref_sym, ref_key)
    btst = fg.get_belief(tst_sym, tst_key)
    tfg.set_belief(ref_sym + "_ref", bref.points, bw=bref.bw)
    tfg.set_belief(tst_sym + "_tst", btst.points, bw=btst.bw)
    model = select_factor_type(vref.vartype, vtst.vartype)
    fct = tfg.add_factor([ref_sym + "_ref", tst_sym + "_tst"], model,
                         graphinit=False)
    return approx_deconv(tfg, fct.label)


# ---------------------------------------------------------------------------
# numeric helpers (reference SolverUtilities.jl:1-10, TetherUtils.jl:12-44,
# FactorGraph.jl:45)
# ---------------------------------------------------------------------------

def fastnorm(u) -> float:
    """Reference ``fastnorm`` — 2-norm of a vector."""
    u = np.asarray(u, dtype=float).ravel()
    return float(np.sqrt((u * u).sum()))


def reshape_vec2mat(vec, rows: int) -> np.ndarray:
    """Reference ``reshapeVec2Mat`` (column-major like Julia)."""
    vec = np.asarray(vec)
    return vec.reshape((rows, len(vec) // rows), order="F")


def cont2disc(F, G, Qc, dt: float, Phik=None):
    """Continuous LTI (F, G, Qc) → discrete (Phi, Gamma, Qd) via the
    matrix-exponential (Van Loan) construction (reference ``cont2disc``,
    src/services/TetherUtils.jl:12-44)."""
    from scipy.linalg import expm
    F = np.asarray(F, dtype=float)
    G = np.asarray(G, dtype=float)
    Qc = np.asarray(Qc, dtype=float)
    fr, fc = F.shape
    gr, gc = G.shape
    M1 = np.zeros((fc + gc, fc + gc))
    M1[:fr, :fc] = F
    M1[:gr, fc:] = G
    Md1 = expm(M1 * dt)
    Phi = Md1[:fr, :fc] if Phik is None else np.asarray(Phik)
    Gamma = Md1[:fr, fc:]
    M2 = np.zeros((fr + fc, fr + fc))
    M2[:fr, :fc] = F
    M2[:fr, fc:] = G @ Qc @ G.T
    M2[fr:, fc:] = -F.T
    Md2 = expm(M2 * dt)
    Qd = Md2[:fr, fc:(fc + fr)] @ Phi.T
    # symmetrize numerical residue
    Qd = 0.5 * (Qd + Qd.T)
    return Phi, Gamma, Qd


# ---------------------------------------------------------------------------
# printers (reference printVariable/printFactor/printSummary)
# ---------------------------------------------------------------------------

def print_variable(fg: FactorGraph, label: str, short: bool = True) -> str:
    """Reference ``printVariable`` — human summary; returns the string."""
    v = fg.var(label)
    lines = [f"Variable {label} :: {v.vartype} (dof={v.manifold.dof})",
             f"  tags: {sorted(v.tags)}  solvable: {v.solvable}"
             f"  marginalized: {v.marginalized}"]
    for sk in sorted(v.beliefs):
        b = v.beliefs[sk]
        init = v.initialized.get(sk, False)
        lines.append(f"  solveKey {sk!r}: N={b.points.shape[0]}"
                     f" initialized={init}"
                     f" solved×{v.solved_count.get(sk, 0)}")
        if not short and sk in v.ppe:
            lines.append(f"    ppe.suggested="
                         f"{host32(v.ppe[sk]['suggested'])}")
    out = "\n".join(lines)
    print(out)
    return out


def print_factor(fg: FactorGraph, label: str) -> str:
    """Reference ``printFactor``."""
    f = fg.factor(label)
    lines = [f"Factor {label} :: {type(f.model).__name__}",
             f"  variables: {list(f.variables)}",
             f"  multihypo: {f.multihypo}  nullhypo: {f.nullhypo}"
             f"  solvable: {f.solvable}  tags: {sorted(f.tags)}"]
    out = "\n".join(lines)
    print(out)
    return out


def print_graph_summary(fg: FactorGraph) -> str:
    """Reference ``printSummary``/``printGraphSummary``."""
    nv, nf = len(fg.variables), len(fg.factors)
    ninit = sum(1 for l in fg.ls() if fg.var(l).is_initialized())
    out = (f"FactorGraph: {nv} variables ({ninit} initialized), "
           f"{nf} factors, solve_count={fg.solve_count}")
    print(out)
    return out


# ---------------------------------------------------------------------------
# object listings / solver-data views (reference getVariables/getSolverData)
# ---------------------------------------------------------------------------

def get_variables(fg: FactorGraph, regex=None, tags: Iterable[str] = (),
                  solvable: int = 0) -> List[Variable]:
    """Reference DFG ``getVariables`` — resolved Variable objects."""
    return [fg.var(l) for l in
            list_variables(fg, regex=regex, tags=tags, solvable=solvable)]


def get_factors(fg: FactorGraph, regex=None, tags: Iterable[str] = (),
                solvable: int = 0) -> List[Factor]:
    """Reference DFG ``getFactors``."""
    return [fg.factor(l) for l in
            list_factors(fg, regex=regex, tags=tags, solvable=solvable)]


def get_solver_data(fg: FactorGraph, label: str,
                    solve_key: str = "default") -> dict:
    """Reference ``getSolverData`` — one solveKey's full solver record
    (belief arrays, init flag, solve count, PPE if stored)."""
    v = fg.var(label)
    return {"belief": v.beliefs.get(solve_key),
            "initialized": v.initialized.get(solve_key, False),
            "solved_count": v.solved_count.get(solve_key, 0),
            "ppe": v.ppe.get(solve_key),
            "marginalized": v.marginalized}


def get_bw_val(fg: FactorGraph, label: str,
               solve_key: str = "default") -> np.ndarray:
    """Reference ``getBWVal`` — bandwidths as a host array."""
    return host32(get_bw(fg, label, solve_key))


def get_point_identity(vartype_or_manifold):
    """Reference ``getPointIdentity`` — the manifold's identity point."""
    m = getattr(vartype_or_manifold, "manifold", vartype_or_manifold)
    return m.identity()


def get_point_type(vartype_or_manifold):
    """Reference ``getPointType`` — (shape, dtype) of a point array."""
    p = get_point_identity(vartype_or_manifold)
    return tuple(p.shape), p.numpy().dtype


def get_multihypo_distribution(fg: FactorGraph, factor_label: str):
    """Reference ``getMultihypoDistribution`` (FGOSUtils.jl:303-313) —
    Categorical over the factor's hypothesis weights (None when not
    multihypo)."""
    from .distributions import Categorical as _Cat
    f = fg.factor(factor_label)
    if f.multihypo is None:
        return None
    w = np.asarray(f.multihypo, dtype=float)
    w = w / max(w.sum(), 1e-12)
    return _Cat(w.tolist())


def get_log_path(fg: FactorGraph) -> str:
    """Reference ``getLogPath`` — the solve-log directory."""
    return fg.params.logpath


def join_log_path(fg: FactorGraph, *parts: str) -> str:
    """Reference ``joinLogPath``."""
    import os as _os
    return _os.path.join(get_log_path(fg), *map(str, parts))


def lsf_priors(fg: FactorGraph) -> List[str]:
    """Reference ``lsfPriors`` (DFG; used e.g. at
    TreeBasedInitialization.jl:27, ParametricUtils.jl:969) — labels of all
    unary prior factors in the graph."""
    return [l for l in fg.lsf() if fg.factor(l).is_prior]


def ls_types(fg: FactorGraph) -> Dict[str, List[str]]:
    """Reference ``lsTypes`` — variable labels grouped by variable type."""
    out: Dict[str, List[str]] = {}
    for l in fg.ls():
        out.setdefault(fg.var(l).vartype.name, []).append(l)
    return out


def lsf_types(fg: FactorGraph) -> Dict[str, List[str]]:
    """Reference ``lsfTypes`` — factor labels grouped by model type."""
    out: Dict[str, List[str]] = {}
    for l in fg.lsf():
        out.setdefault(type(fg.factor(l).model).__name__, []).append(l)
    return out


def list_type_tree(cls=None, indent: int = 0) -> str:
    """Reference ``listTypeTree`` — print the factor-model class hierarchy
    rooted at ``cls`` (default: FactorModel)."""
    if cls is None:
        from .models.factors import FactorModel
        cls = FactorModel
    lines = [" " * indent + cls.__name__]
    for sub in sorted(cls.__subclasses__(), key=lambda c: c.__name__):
        lines.append(list_type_tree(sub, indent + 2))
    out = "\n".join(lines)
    if indent == 0:
        print(out)
    return out


def get_current_workspace_factors() -> List[type]:
    """All factor-model classes loadable in this Python process (reference
    getCurrentWorkspaceFactors, ext/IncrInfrInteractiveUtilsExt.jl:19-29 —
    there via InteractiveUtils subtype reflection, here the transitive
    FactorModel subclass closure)."""
    from .models.factors import FactorModel

    def walk(cls):
        out = []
        for sub in cls.__subclasses__():
            out.append(sub)
            out.extend(walk(sub))
        return out

    return sorted(set(walk(FactorModel)), key=lambda c: c.__name__)


def get_current_workspace_variables() -> List:
    """All variable types known in this Python process (reference
    getCurrentWorkspaceVariables, ext/IncrInfrInteractiveUtilsExt.jl:32-42):
    every live VariableType instance, including factory-created ones
    (ContinuousEuclid(n), Position(n), user-defined)."""
    return sorted(set(VariableType._REGISTRY), key=lambda v: v.name)


# ---------------------------------------------------------------------------
# solver-data lifecycle (reference makeSolverData!, resetInitValues!,
# resetFactorGraphNewTree!, defaultFixedLagOnTree!)
# ---------------------------------------------------------------------------

def make_solver_data(fg: FactorGraph, solve_key: str = "default"
                     ) -> List[str]:
    """Reference ``makeSolverData!`` (GraphInit.jl:21-43) — materialize
    solver data under ``solve_key`` for every variable that lacks it
    (identity points, uninitialized)."""
    out = []
    for l in fg.ls():
        v = fg.var(l)
        if solve_key not in v.beliefs:
            src = v.beliefs.get("default")
            if src is not None:
                v.beliefs[solve_key] = src
                v.initialized[solve_key] = v.initialized.get("default",
                                                             False)
            else:
                fg.set_belief(l, fg.points(l, solve_key),
                              solve_key=solve_key, initialized=False)
            out.append(l)
    return out


def init_variable_manual(fg: FactorGraph, label: str, value,
                         solve_key: str = "default"):
    """Reference ``initVariableManual!`` — alias of initVariable!."""
    from .graphinit import init_variable
    return init_variable(fg, label, value, solve_key=solve_key)


def reset_init_values(fg: FactorGraph, solve_key: str = "default",
                      from_key: str = "graphinit"):
    """Reference ``resetInitValues!`` — restore the graphinit snapshot."""
    from .graphinit import reset_initial_values
    return reset_initial_values(fg, solve_key=solve_key, src_key=from_key)


def reset_factor_graph_new_tree(fg: FactorGraph) -> FactorGraph:
    """Reference ``resetFactorGraphNewTree!`` — clear per-solve elimination
    bookkeeping so a fresh tree can be built."""
    for f in fg.factors.values():
        f.potential_used = False
    return fg


def default_fixed_lag_on_tree(fg: FactorGraph, qfl: int = 99999,
                              limit_fixed_lag: bool = True) -> int:
    """Reference ``defaultFixedLagOnTree!`` — enable the quasi fixed-lag
    marginalization window."""
    fg.params = fg.params.replace(qfl=int(qfl),
                                  is_fixed_lag=bool(limit_fixed_lag))
    return int(qfl)


# ---------------------------------------------------------------------------
# legacy string → distribution parsing (reference normalfromstring /
# categoricalfromstring / extractdistribution)
# ---------------------------------------------------------------------------

def normal_from_string(s: str):
    """Parse ``"Normal(mu, sigma)"`` (reference normalfromstring)."""
    import ast
    from .distributions import Normal as _N
    m = re.match(r"\s*Normal\s*\((.*)\)\s*$", s)
    if not m:
        raise ValueError(f"not a Normal string: {s!r}")
    mu, sigma = ast.literal_eval("(" + m.group(1) + ")")
    return _N(float(mu), float(sigma))


def categorical_from_string(s: str):
    """Parse ``"Categorical([p1, p2, …])"`` (reference
    categoricalfromstring)."""
    import ast
    from .distributions import Categorical as _C
    m = re.match(r"\s*Categorical\s*\((.*)\)\s*$", s)
    if not m:
        raise ValueError(f"not a Categorical string: {s!r}")
    p = ast.literal_eval(m.group(1))
    return _C([float(x) for x in p])


def extract_distribution(s: str):
    """Parse any supported distribution string (reference
    extractdistribution): Normal, MvNormal, Uniform, Rayleigh,
    Categorical."""
    import ast
    from . import distributions as D
    m = re.match(r"\s*([A-Za-z]+)\s*\((.*)\)\s*$", s)
    if not m:
        raise ValueError(f"unparseable distribution string: {s!r}")
    name, argstr = m.groups()
    ctor = {"Normal": D.Normal, "MvNormal": D.MvNormal,
            "Uniform": D.Uniform, "Rayleigh": D.Rayleigh,
            "Categorical": D.Categorical}.get(name)
    if ctor is None:
        raise ValueError(f"unknown distribution {name!r}")
    args = ast.literal_eval("(" + argstr + ",)")
    return ctor(*args)

"""Name-compatibility surface for reference users.

Counterpart of ``incrementalinference/jl_tpu/compat.py``.  The reference
re-exports names from its dependency stack (DistributedFactorGraphs.jl
summaries, FunctionalStateMachine.jl helpers, LinearAlgebra.diagm) and a
few type aliases (src/IncrementalInference.jl, src/ExportAPI.jl).  This
module maps each onto the port's equivalent: aliases, thin dataclass
summaries, and constructors of the packed dicts that
``serialization/packed.py`` writes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .beliefs import Belief
from .config import SolverParams
from .distributions import (AliasingScalarSampler, Categorical, MvNormal,
                            Normal, Rayleigh, Uniform)
from .graph import Factor, FactorGraph, Variable, VariableType
from .models.factors import (FactorModel, GenericMarginal, MsgPrior,
                             PartialPrior, Prior, PriorModel)
from .ops.convolve import ConvSpec
from .serialization.packed import (pack_belief, pack_distribution,
                                   pack_factor_model)
from .tree.bayestree import BayesTree, Clique

__all__ = [
    "AbstractBayesTree", "BeliefArray", "GraphsDFG", "InferenceVariable",
    "DFGVariableSummary", "DFGFactorSummary", "variable_summary",
    "factor_summary", "CliqStateMachineContainer", "get_solver_params",
    "diagm",
    "PackedPrior", "PackedMsgPrior", "PackedPartialPrior",
    "PackedGenericMarginal", "PackedSamplableBelief",
    "PackedZeroMeanFullNormal", "PackedFunctionNodeData",
    "PackedBayesTreeNodeData",
]

# type aliases (reference AbstractBayesTree / BeliefArray
# src/IncrementalInference.jl:94; GraphsDFG / InferenceVariable are the DFG
# in-memory graph type and the abstract variable-type supertype).  A
# belief's point block is a tensor in the port.
AbstractBayesTree = BayesTree
BeliefArray = torch.Tensor
GraphsDFG = FactorGraph
InferenceVariable = VariableType


@dataclass(frozen=True)
class DFGVariableSummary:
    """Lightweight variable view (reference DFG.DFGVariableSummary)."""

    label: str
    variable_type: str
    tags: tuple
    timestamp: float
    solvable: int
    npoints: int


@dataclass(frozen=True)
class DFGFactorSummary:
    """Lightweight factor view (reference DFG.DFGFactorSummary)."""

    label: str
    factor_type: str
    variables: tuple
    tags: tuple
    timestamp: float
    solvable: int


def variable_summary(v: Variable) -> DFGVariableSummary:
    b = v.beliefs.get("default")
    return DFGVariableSummary(
        label=v.label, variable_type=v.vartype.name, tags=tuple(sorted(v.tags)),
        timestamp=float(getattr(v, "timestamp", 0.0)), solvable=v.solvable,
        npoints=0 if b is None else int(b.points.shape[0]))


def factor_summary(f: Factor) -> DFGFactorSummary:
    """Lightweight factor header (reference DFGFactorSummary)."""
    return DFGFactorSummary(
        label=f.label, factor_type=type(f.model).__name__,
        variables=tuple(f.variables), tags=tuple(sorted(f.tags)),
        timestamp=float(getattr(f, "timestamp", 0.0)), solvable=f.solvable)


@dataclass
class CliqStateMachineContainer:
    """Bundle of one clique solve's working state (reference
    CliqStateMachineContainer, src/entities/JunctionTreeTypes.jl:32-56).
    The level sweeps have no live state machine; this container packages
    the same handles for the single-clique harness and replays."""

    dfg: FactorGraph
    cliq_sub_fg: Optional[FactorGraph]
    tree: BayesTree
    cliq: Clique
    solve_key: str = "default"
    incremental: bool = True
    history: List[Any] = field(default_factory=list)


def get_solver_params(fg: FactorGraph) -> SolverParams:
    """Reference ``getSolverParams(dfg)``."""
    return fg.params


def diagm(v) -> np.ndarray:
    """Reference re-export LinearAlgebra.diagm — diagonal matrix from a
    vector."""
    return np.diag(np.asarray(v))


# ---------------------------------------------------------------------------
# packed-type constructors (reference Packed* structs; here the packed form
# is the JSON-safe dict produced by serialization/packed.py, so each
# constructor simply packs the live object)
# ---------------------------------------------------------------------------

def PackedPrior(Z) -> Dict[str, Any]:
    """Packed form of ``Prior(Z)`` (reference PackedPrior)."""
    return pack_factor_model(Prior(Z))


def PackedMsgPrior(belief, manifold, ipc=None) -> Dict[str, Any]:
    """Packed form of ``MsgPrior`` (reference PackedMsgPrior)."""
    return pack_factor_model(MsgPrior(belief, manifold, ipc=ipc))


def PackedPartialPrior(Z, dims) -> Dict[str, Any]:
    """Packed form of ``PartialPrior`` (reference PackedPartialPrior)."""
    return pack_factor_model(PartialPrior(Z, tuple(dims)))


def PackedGenericMarginal() -> Dict[str, Any]:
    """Packed form of ``GenericMarginal`` (reference
    PackedGenericMarginal)."""
    return pack_factor_model(GenericMarginal())


def PackedSamplableBelief(z) -> Dict[str, Any]:
    """Packed form of any samplable distribution (reference
    PackedSamplableBelief string/struct forms)."""
    return pack_distribution(z)


def PackedZeroMeanFullNormal(cov) -> Dict[str, Any]:
    """Reference PackedZeroMeanFullNormal — MvNormal with zero mean."""
    cov = np.asarray(cov, dtype=float)
    return pack_distribution(MvNormal(np.zeros(cov.shape[0]), cov))


def PackedFunctionNodeData(f: Factor) -> Dict[str, Any]:
    """Packed per-factor solver data (reference PackedFunctionNodeData)."""
    return {"label": f.label, "variables": list(f.variables),
            "fnc": pack_factor_model(f.model),
            "multihypo": list(f.multihypo) if f.multihypo is not None else None,
            "nullhypo": float(f.nullhypo), "solvable": f.solvable,
            "tags": sorted(f.tags)}


def PackedBayesTreeNodeData(c: Clique) -> Dict[str, Any]:
    """Packed clique payload (reference PackedBayesTreeNodeData) — the same
    dict save_tree persists per clique."""
    return {"cid": c.cid, "frontals": list(c.frontals),
            "separator": list(c.separator), "parent": c.parent,
            "children": list(c.children), "potentials": list(c.potentials),
            "status": c.status.value, "is_recycled": c.is_recycled,
            "is_marginalized": c.is_marginalized,
            "direct_vars": list(c.direct_vars),
            "iter_vars": list(c.iter_vars),
            "msgskip_vars": list(c.msgskip_vars)}


# ---------------------------------------------------------------------------
# the rest of the ExportAPI.jl names: aliases of the reference's abstract
# hierarchy and the Packed* distribution constructors (each makes the
# packed dict serialization/packed.py round-trips, the analogue of the
# reference's Packed* structs, SerializingDistributions.jl:4-38)
# ---------------------------------------------------------------------------

#: reference LocalDFG — the same in-memory graph type as GraphsDFG
LocalDFG = FactorGraph
#: reference TreeBelief (points+bw+ipc per variable, BeliefTypes.jl:23-34)
TreeBelief = Belief
#: reference CommonConvWrapper — the per-factor static compute plan
CommonConvWrapper = ConvSpec
#: reference abstract factor hierarchy: one residual API serves all four
#: (models/factors.py FactorModel.residual; prior vs relative is the
#: is_prior flag, minimize-vs-manifold collapses into the batched
#: tangent-space LM solve)
AbstractFactor = FactorModel
CalcFactor = FactorModel
AbstractPrior = PriorModel


class _RelativeMeta(type):
    """isinstance/issubclass semantics matching the reference's DISJOINT
    AbstractPrior vs AbstractRelative hierarchies (DFG abstract types):
    a prior model must NOT satisfy ``isinstance(x, AbstractRelative)``,
    or migrated dispatch code silently takes the wrong branch."""

    def __instancecheck__(cls, obj):
        return (isinstance(obj, FactorModel)
                and not getattr(obj, "is_prior", False))

    def __subclasscheck__(cls, sub):
        if sub is cls or (isinstance(sub, type)
                          and isinstance(sub, _RelativeMeta)):
            return True                      # reflexivity (+ aliases)
        if not (isinstance(sub, type) and issubclass(sub, FactorModel)):
            return False
        # class-level is_prior True ⇒ statically a prior; a property
        # (e.g. Mixture, whose prior-ness is per-instance) stays eligible
        return getattr(sub, "is_prior", False) is not True


class AbstractRelative(metaclass=_RelativeMeta):
    """Reference AbstractRelative: any FactorModel that is not a prior.
    Virtual base — use only for isinstance/issubclass dispatch."""


AbstractRelativeMinimize = AbstractRelative
AbstractManifoldMinimize = AbstractRelative


def _packed_dist(ctor, ref_name):
    """Constructor shim named after the REFERENCE's packed struct (which
    can differ from the local distribution class, e.g. PackedFullNormal
    wraps MvNormal)."""

    def make(*args, **kw):
        return pack_distribution(ctor(*args, **kw))
    make.__name__ = ref_name
    make.__doc__ = (f"Reference {ref_name} — packed dict form of "
                    f"``{ctor.__name__}(...)``.")
    return make


PackedNormal = _packed_dist(Normal, "PackedNormal")
PackedFullNormal = _packed_dist(MvNormal, "PackedFullNormal")
PackedCategorical = _packed_dist(Categorical, "PackedCategorical")
PackedUniform = _packed_dist(Uniform, "PackedUniform")
PackedRayleigh = _packed_dist(Rayleigh, "PackedRayleigh")
PackedAliasingScalarSampler = _packed_dist(AliasingScalarSampler,
                                           "PackedAliasingScalarSampler")


def PackedDiagNormal(mu, diag) -> Dict[str, Any]:
    """Reference PackedDiagNormal — MvNormal with diagonal covariance."""
    mu = np.asarray(mu, dtype=float)
    return pack_distribution(MvNormal(mu, np.diag(np.asarray(diag, float))))


def PackedZeroMeanDiagNormal(diag) -> Dict[str, Any]:
    """Reference PackedZeroMeanDiagNormal."""
    diag = np.asarray(diag, dtype=float)
    return PackedDiagNormal(np.zeros(diag.shape[0]), diag)


def PackedManifoldKernelDensity(belief, parch: bool = False) -> Dict[str, Any]:
    """Reference PackedManifoldKernelDensity — packed KDE belief
    (SerializationMKD.jl:14-40); ``parch=True`` hollows the points."""
    return pack_belief(belief, parch=parch)


def PackedMixture(mix) -> Dict[str, Any]:
    """Reference PackedMixture — packed form of a ``Mixture`` factor."""
    return pack_factor_model(mix)


def PackedHeatmapGridDensity(h) -> Dict[str, Any]:
    """Reference PackedHeatmapGridDensity."""
    return pack_distribution(h)


def PackedLevelSetGridNormal(l) -> Dict[str, Any]:
    """Reference PackedLevelSetGridNormal."""
    return pack_distribution(l)


def PackedFluxModelsDistribution(f) -> Dict[str, Any]:
    """Reference PackedFluxModelsDistribution (ext/FluxModelsSerialization)."""
    return pack_distribution(f)


__all__ += [
    "LocalDFG", "TreeBelief", "CommonConvWrapper", "CalcFactor",
    "AbstractFactor", "AbstractPrior", "AbstractRelative",
    "AbstractRelativeMinimize", "AbstractManifoldMinimize",
    "PackedNormal", "PackedFullNormal", "PackedDiagNormal",
    "PackedZeroMeanDiagNormal", "PackedCategorical", "PackedUniform",
    "PackedRayleigh", "PackedAliasingScalarSampler",
    "PackedManifoldKernelDensity", "PackedMixture",
    "PackedHeatmapGridDensity", "PackedLevelSetGridNormal",
    "PackedFluxModelsDistribution",
]

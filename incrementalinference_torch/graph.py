"""Factor-graph container: variables, factors, solve keys.

Counterpart of ``incrementalinference/jl_tpu/graph.py``.  Structure (labels,
adjacency, solve keys) is plain Python; beliefs are tensors on the graph's
``device``, which is CUDA unless the caller names another
(:func:`~incrementalinference_torch.config.resolve_device`).
"""

from __future__ import annotations

import itertools
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import keys as _keys
from . import tracing
from .beliefs import Belief, make_belief
from .config import SolverParams, resolve_device
from .manifolds import Circle, Euclidean, Manifold

__all__ = ["VariableType", "Variable", "Factor", "FactorGraph", "initfg",
           "ContinuousScalar", "ContinuousEuclid", "Position", "Circular",
           "Position1", "Position2", "Position3", "Position4"]


class VariableType:
    """A named manifold (reference ``@defVariable`` products).  Every
    instance joins a weak registry, so workspace introspection
    (``fgos.get_current_workspace_variables``) sees factory-made types."""

    _REGISTRY: "weakref.WeakSet" = weakref.WeakSet()

    def __init__(self, name: str, manifold: Manifold):
        self.name = name
        self.manifold = manifold
        VariableType._REGISTRY.add(self)

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        return isinstance(other, VariableType) and \
            (self.name, self.manifold) == (other.name, other.manifold)

    def __hash__(self):
        return hash((self.name, self.manifold))


def ContinuousEuclid(n: int) -> VariableType:
    """Euclidean R^n variable type (reference ContinuousEuclid{N})."""
    return VariableType(f"ContinuousEuclid{n}", Euclidean(n))


def Position(n: int) -> VariableType:
    """Translation-group position variable type (reference Position{N})."""
    return VariableType(f"Position{n}", Euclidean(n))


ContinuousScalar = ContinuousEuclid(1)
Circular = VariableType("Circular", Circle())

# the first Position{N} instances, exported by name as in the reference
Position1 = Position(1)
Position2 = Position(2)
Position3 = Position(3)
Position4 = Position(4)


@dataclass
class Variable:
    """Graph variable with per-solveKey beliefs."""

    label: str
    vartype: VariableType
    N: int = 100
    tags: set = field(default_factory=set)
    solvable: int = 1
    # creation time (seconds since the epoch) and attached blob entries
    # (reference DFG getTimestamp and the addData! entries)
    timestamp: float = 0.0
    data: Dict[str, Any] = field(default_factory=dict)
    beliefs: Dict[str, Belief] = field(default_factory=dict)
    initialized: Dict[str, bool] = field(default_factory=dict)
    ppe: Dict[str, dict] = field(default_factory=dict)
    # parametric solve state: the point and its tangent covariance
    parametric_point: Optional[torch.Tensor] = None
    parametric_cov: Optional[torch.Tensor] = None
    marginalized: bool = False
    solved_count: Dict[str, int] = field(default_factory=dict)

    @property
    def manifold(self) -> Manifold:
        return self.vartype.manifold

    def get_solved_count(self, solve_key: str = "default") -> int:
        return self.solved_count.get(solve_key, 0)

    def is_solved(self, solve_key: str = "default") -> bool:
        return self.get_solved_count(solve_key) > 0

    def belief(self, solve_key: str = "default") -> Belief:
        return self.beliefs[solve_key]

    def is_initialized(self, solve_key: str = "default") -> bool:
        return self.initialized.get(solve_key, False)


@dataclass
class Factor:
    """Graph factor: model + variable order + discrete-hypothesis config."""

    label: str
    variables: Tuple[str, ...]
    model: Any
    multihypo: Optional[Tuple[float, ...]] = None
    nullhypo: float = 0.0
    tags: set = field(default_factory=set)
    solvable: int = 1
    timestamp: float = 0.0
    potential_used: bool = False
    # what the model's ``preamble_cache`` hook built at add time
    cache: Any = None

    @property
    def is_prior(self) -> bool:
        return len(self.variables) == 1 and getattr(self.model, "is_prior",
                                                    False)

    @property
    def is_multihypo(self) -> bool:
        return self.multihypo is not None

    @property
    def is_partial(self) -> bool:
        """Reference isPartial: the factor constrains only a subset of the
        target's tangent dims."""
        return getattr(self.model, "partial", None) is not None


class FactorGraph:
    """The in-memory factor graph (reference ``initfg``/LocalDFG)."""

    def __init__(self, params: SolverParams | None = None, device=None):
        self.params = params or SolverParams()
        self.device = resolve_device(device)
        self.variables: Dict[str, Variable] = {}
        self.factors: Dict[str, Factor] = {}
        self._var_factors: Dict[str, List[str]] = {}
        self._seed = int(self.params.seed) & 0xFFFFFFFF
        self._key_ctr = 0
        self._factor_counter = itertools.count()
        self._default_points: Dict[Tuple, torch.Tensor] = {}
        self.solve_count = 0

    # -- host-side key stream (see keys.py) --------------------------------
    def next_key(self) -> int:
        """A fresh key, deterministic per (params.seed, call index)."""
        self._key_ctr += 1
        return _keys.make_key(self._seed, self._key_ctr)

    def reseed(self, seed: int) -> None:
        """Restart the key stream from a new seed."""
        self._seed = int(seed) & 0xFFFFFFFF
        self._key_ctr = 0

    # -- construction -----------------------------------------------------
    @tracing.spanned("add_variable", device=lambda self, *a, **k: self.device)
    def add_variable(self, label: str, vartype: VariableType,
                     N: int | None = None, tags: Iterable[str] = (),
                     solvable: int = 1) -> Variable:
        """Add a variable node (reference addVariable!)."""
        if label in self.variables:
            raise ValueError(f"variable {label!r} already exists")
        v = Variable(label=label, vartype=vartype, N=N or self.params.N,
                     tags=set(tags), solvable=solvable,
                     timestamp=time.time())
        self.variables[label] = v
        self._var_factors[label] = []
        return v

    @tracing.spanned("add_factor", device=lambda self, *a, **k: self.device)
    def add_factor(self, variables: Sequence[str], model: Any,
                   multihypo: Optional[Sequence[float]] = None,
                   nullhypo: float = 0.0, label: str | None = None,
                   graphinit: bool | None = None, tags: Iterable[str] = (),
                   solvable: int = 1) -> Factor:
        """Add a factor (reference addFactor!): auto-names it, guards
        ``max_incidence``, checks ``multihypo`` and runs graphinit on its
        variables unless disabled."""
        variables = tuple(variables)
        for vl in variables:
            if vl not in self.variables:
                raise ValueError(f"unknown variable {vl!r}")
            if len(self._var_factors[vl]) >= self.params.max_incidence:
                raise ValueError(f"variable {vl!r} exceeds maxincidence="
                                 f"{self.params.max_incidence}")
        if multihypo is not None:
            multihypo = tuple(float(x) for x in multihypo)
            if len(multihypo) != len(variables):
                raise ValueError("multihypo length must match variables")
        if label is None:
            label = "".join(variables) + f"f{next(self._factor_counter) + 1}"
        if label in self.factors:
            raise ValueError(f"factor {label!r} already exists")
        f = Factor(label=label, variables=variables, model=model,
                   multihypo=multihypo, nullhypo=float(nullhypo),
                   tags=set(tags), solvable=solvable, timestamp=time.time())
        self.factors[label] = f
        for vl in variables:
            self._var_factors[vl].append(label)
        # reference preambleCache: a user model may build a one-time cache
        # from the graph context, kept host-side on the factor
        pc = getattr(model, "preamble_cache", None)
        if callable(pc):
            f.cache = pc(self, [self.variables[vl] for vl in variables], f)
        do_init = self.params.graphinit if graphinit is None else graphinit
        if do_init:
            from .graphinit import doautoinit
            for vl in variables:
                doautoinit(self, vl)
        return f

    def remove_factor(self, label: str) -> Factor:
        """Delete a factor (reference DFG deleteFactor!)."""
        f = self.factors.pop(label, None)
        if f is None:
            raise KeyError(f"unknown factor {label!r}")
        for vl in f.variables:
            if label in self._var_factors.get(vl, ()):
                self._var_factors[vl].remove(label)
        return f

    def remove_variable(self, label: str, remove_factors: bool = True
                        ) -> Variable:
        """Delete a variable (reference DFG deleteVariable!) and, unless
        ``remove_factors`` is False (then the delete refuses while factors
        remain), its factors."""
        if label not in self.variables:
            raise KeyError(f"unknown variable {label!r}")
        attached = list(self._var_factors.get(label, ()))
        if attached and not remove_factors:
            raise ValueError(
                f"variable {label!r} still has factors {attached}")
        for fl in attached:
            self.remove_factor(fl)
        del self._var_factors[label]
        # graphinit.ensure_solvable's demotions are kept by label
        getattr(self, "_auto_demoted", set()).discard(label)
        return self.variables.pop(label)

    # -- queries -----------------------------------------------------------
    def exists(self, label: str) -> bool:
        """Reference DFG exists(fg, label): a variable or a factor."""
        return label in self.variables or label in self.factors

    def ls(self, tags: Iterable[str] = ()) -> List[str]:
        tags = set(tags)
        return [v for v, var in self.variables.items()
                if not tags or tags & var.tags]

    def lsf(self, tags: Iterable[str] = ()) -> List[str]:
        tags = set(tags)
        return [f for f, fac in self.factors.items()
                if not tags or tags & fac.tags]

    def var(self, label: str) -> Variable:
        return self.variables[label]

    def factor(self, label: str) -> Factor:
        return self.factors[label]

    def factors_of(self, var_label: str) -> List[str]:
        return list(self._var_factors[var_label])

    def neighbors(self, label: str) -> List[str]:
        """A variable's factors or a factor's variables (reference
        getNeighbors)."""
        if label in self.variables:
            return self.factors_of(label)
        return list(self.factors[label].variables)

    # -- beliefs -----------------------------------------------------------
    def get_belief(self, label: str, solve_key: str = "default") -> Belief:
        return self.variables[label].beliefs[solve_key]

    def set_belief(self, label: str, points: torch.Tensor,
                   solve_key: str = "default",
                   bw: torch.Tensor | None = None,
                   ipc: torch.Tensor | None = None,
                   initialized: bool = True) -> Belief:
        """Replace a variable's belief (reference setValKDE!); bandwidths
        are LOO-selected when ``bw`` is omitted."""
        v = self.variables[label]
        b = make_belief(v.manifold, points.to(self.device), bw=bw, ipc=ipc)
        v.beliefs[solve_key] = b
        v.initialized[solve_key] = initialized
        return b

    def points(self, label: str, solve_key: str = "default") -> torch.Tensor:
        """The belief's particles ``(N, point_dim)``; identity points when
        the solve key has no belief yet."""
        v = self.variables[label]
        b = v.beliefs.get(solve_key)
        if b is not None:
            return b.points
        k = (v.manifold, v.N)
        if k not in self._default_points:
            ident = v.manifold.identity(self.device)
            self._default_points[k] = ident.expand(
                (v.N,) + ident.shape).clone()
        return self._default_points[k]

    def __repr__(self):
        return (f"FactorGraph({len(self.variables)} variables, "
                f"{len(self.factors)} factors, {self.device})")


def initfg(params: SolverParams | None = None, device=None) -> FactorGraph:
    """Reference ``initfg``: an empty graph on ``device`` (CUDA default)."""
    return FactorGraph(params, device=device)

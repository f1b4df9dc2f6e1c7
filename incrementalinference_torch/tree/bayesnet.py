"""Symbolic variable elimination → chordal Bayes net.

Counterpart of ``incrementalinference/jl_tpu/tree/bayesnet.py`` (reference
buildBayesNet!): eliminate in order, form separators, track chain-rule
marginals symbolically.  Labels only, no numerics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

__all__ = ["Conditional", "build_bayes_net"]


@dataclass
class Conditional:
    """p(var | separator) with the factor labels consumed at elimination."""

    var: str
    separator: List[str]
    factors: List[str] = field(default_factory=list)


def build_bayes_net(fg, order: Sequence[str]) -> List[Conditional]:
    """One conditional per variable of ``order``.  Only factors whose
    variables are all solvable take part."""
    active: Dict[str, Tuple[str, ...]] = {}
    for fl in fg.lsf():
        f = fg.factor(fl)
        if f.solvable > 0 and all(fg.var(v).solvable > 0
                                  for v in f.variables):
            active[fl] = tuple(f.variables)

    conditionals: List[Conditional] = []
    eliminated = set()
    marg_count = 0
    for var in order:
        touching = [k for k, vs in active.items() if var in vs]
        sep: List[str] = []
        real_factors: List[str] = []
        for k in touching:
            for v in active[k]:
                if v != var and v not in eliminated and v not in sep:
                    sep.append(v)
            if not k.startswith("__marg"):
                real_factors.append(k)
                fg.factor(k).potential_used = True
            del active[k]
        conditionals.append(Conditional(var=var, separator=sep,
                                        factors=real_factors))
        eliminated.add(var)
        if sep:
            marg_count += 1
            active[f"__marg{marg_count}"] = tuple(sep)
    return conditionals

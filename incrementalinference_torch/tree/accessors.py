"""Clique accessors the scheduler needs.

Counterpart of the two helpers of ``incrementalinference/jl_tpu``
(tree/accessors.py get_cliq_vars_with_frontal_neighbors, fgos.py
find_factors_between_from) that the down solve calls.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["get_cliq_vars_with_frontal_neighbors", "find_factors_between_from"]


def get_cliq_vars_with_frontal_neighbors(fg, cliq, solvable: int = 1
                                         ) -> List[str]:
    """Clique variables plus every variable sharing a factor with a frontal
    (reference getCliqVarsWithFrontalNeighbors)."""
    syms = list(dict.fromkeys(list(cliq.frontals) + list(cliq.separator)))
    seen = set(syms)
    for frt in cliq.frontals:
        for fl in fg.factors_of(frt):
            if fg.factor(fl).solvable < solvable:
                continue
            for vl in fg.factor(fl).variables:
                if vl not in seen and fg.var(vl).solvable >= solvable:
                    seen.add(vl)
                    syms.append(vl)
    return syms


def find_factors_between_from(fg, between: Sequence[str],
                              from_var: str) -> List[str]:
    """Factors on ``from_var`` whose variables all lie in ``between``
    (reference findFactorsBetweenFrom)."""
    between = set(between)
    return [fl for fl in fg.factors_of(from_var)
            if set(fg.factor(fl).variables) <= between]

"""Fill-reducing variable elimination orderings.

Counterpart of ``incrementalinference/jl_tpu/tree/ordering.py`` (reference
getEliminationOrder): "qr", the column pivoting of a QR factorization of
the dense factor × variable incidence matrix (LAPACK through scipy,
imported when asked for), the default as in the JAX package; and
"colamd"/"ccolamd"/"mindegree", the constrained minimum-degree order from
the port's own native build, with a Python greedy min-degree heuristic when
the build is unavailable.  ``build_tree`` asks for ``SolverParams.ordering``
("ccolamd"), so a solve takes the minimum-degree order in both packages.
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["get_elimination_order"]

logger = logging.getLogger(__name__)


def _incidence(fg, variables: List[str]) -> np.ndarray:
    """Dense solvable-factor × variable incidence matrix."""
    col = {v: j for j, v in enumerate(variables)}
    fls = [f for f in fg.lsf() if fg.factor(f).solvable > 0]
    A = np.zeros((max(len(fls), 1), len(variables)), np.float64)
    for i, fl in enumerate(fls):
        for vl in fg.factor(fl).variables:
            if vl in col:
                A[i, col[vl]] = 1.0
    return A


def _qr_order(fg, variables: List[str]) -> List[str]:
    """LAPACK dgeqp3's column pivots (the reference's qr(A, Val(true)).p)."""
    import scipy.linalg

    _, _, p = scipy.linalg.qr(_incidence(fg, variables), pivoting=True,
                              mode="economic")
    return [variables[j] for j in p]


def _min_degree_order(fg, variables: List[str]) -> List[str]:
    """Greedy minimum-degree on the variable adjacency graph, ties broken
    by label."""
    adj = {v: set() for v in variables}
    for fl in fg.lsf():
        vs = [v for v in fg.factor(fl).variables if v in adj]
        for a in vs:
            for b in vs:
                if a != b:
                    adj[a].add(b)
    order: List[str] = []
    remaining = set(variables)
    while remaining:
        v = min(remaining, key=lambda x: (len(adj[x] & remaining), x))
        order.append(v)
        remaining.discard(v)
        nbrs = adj[v] & remaining
        for a in nbrs:
            adj[a] |= nbrs - {a}
    return order


def get_elimination_order(fg, method: str = "qr",
                          constraints: Optional[Sequence[str]] = None,
                          variables: Optional[Iterable[str]] = None
                          ) -> List[str]:
    """Elimination order over solvable variables; ``constraints`` go to the
    end of the order (near the tree root)."""
    if method not in ("qr", "colamd", "ccolamd", "mindegree"):
        raise ValueError(f"unknown ordering method {method!r}")
    variables = [v for v in (variables or fg.ls())
                 if fg.var(v).solvable > 0]
    cset = set(constraints or [])
    constraints = [c for c in (constraints or []) if c in variables]
    free = [v for v in variables if v not in cset]
    if method == "qr":
        return _qr_order(fg, free) + constraints

    from ..native import native_ccolamd
    idx = {v: i for i, v in enumerate(variables)}
    fvars = [[idx[v] for v in fg.factor(fl).variables if v in idx]
             for fl in fg.lsf() if fg.factor(fl).solvable > 0]
    cmember = [1 if v in cset else 0 for v in variables]
    out = native_ccolamd(len(variables), fvars, cmember)
    if out is not None:
        return [variables[i] for i in out]

    logger.warning("native ordering unavailable; using the Python "
                   "min-degree heuristic")
    return _min_degree_order(fg, free) + constraints

"""Fill-reducing variable elimination orderings.

Counterpart of ``incrementalinference/jl_tpu/tree/ordering.py``: the
constrained minimum-degree order ("colamd"/"ccolamd") from the port's own
native build, with a Python greedy min-degree heuristic when the build is
unavailable.  The JAX package's "qr" ordering (scipy pivoted QR) is not
ported: the port depends on torch and numpy only.
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional, Sequence

__all__ = ["get_elimination_order"]

logger = logging.getLogger(__name__)


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


def get_elimination_order(fg, method: str = "ccolamd",
                          constraints: Optional[Sequence[str]] = None,
                          variables: Optional[Iterable[str]] = None
                          ) -> List[str]:
    """Elimination order over solvable variables; ``constraints`` go to the
    end of the order (near the tree root)."""
    if method not in ("colamd", "ccolamd", "mindegree"):
        raise ValueError(f"unknown or unported ordering method {method!r}")
    variables = [v for v in (variables or fg.ls())
                 if fg.var(v).solvable > 0]
    cset = set(constraints or [])
    constraints = [c for c in (constraints or []) if c in variables]

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
    free = [v for v in variables if v not in cset]
    return _min_degree_order(fg, free) + list(constraints)

"""Solver API — user entry points.

Counterpart of ``incrementalinference/jl_tpu/api.py`` (reference
solveTree! = solveGraph!): init → freeze → tree build → up/down sweeps.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

from .graph import FactorGraph
from .graphinit import ensure_solvable, init_all
from .parallel.scheduler import solve_tree_sweeps
from .tree.bayestree import BayesTree, build_tree

__all__ = ["solve_tree", "solve_graph", "fifo_freeze"]

logger = logging.getLogger(__name__)


def fifo_freeze(fg: FactorGraph) -> List[str]:
    """Quasi fixed-lag: marginalize all but the newest ``qfl`` initialized
    variables (reference fifoFreeze!)."""
    if not fg.params.is_fixed_lag or fg.params.qfl <= 0:
        return []
    labels = fg.ls()
    keep = set(labels[-fg.params.qfl:])
    frozen = []
    for lbl in labels:
        v = fg.var(lbl)
        if lbl not in keep and v.is_initialized() and not v.marginalized:
            v.marginalized = True
            frozen.append(lbl)
    return frozen


def solve_tree(fg: FactorGraph, old_tree: Optional[BayesTree] = None,
               solve_key: str = "default", store_old: bool = False,
               up: Optional[bool] = None, down: Optional[bool] = None,
               order: Optional[Sequence[str]] = None,
               verbose: bool = False) -> BayesTree:
    """Nonparametric MM-iSAM solve over the Bayes tree (reference
    solveTree!).  Runs on the graph's device.  Returns the tree.

    ``old_tree`` (incremental clique recycling) is not ported yet and is
    refused."""
    if old_tree is not None:
        raise NotImplementedError("clique recycling (old_tree) is not "
                                  "ported yet")
    params = fg.params
    t0 = time.time()
    ensure_solvable(fg)
    if params.graphinit:
        init_all(fg, solve_key=solve_key)
    if store_old:
        snap = f"{solve_key}_{fg.solve_count}"
        for v in fg.variables.values():
            if solve_key in v.beliefs:
                v.beliefs[snap] = v.beliefs[solve_key]
    fifo_freeze(fg)

    tree = build_tree(fg, order=order)
    if verbose:
        logger.info("tree: %d cliques, depth %d, build %.3fs",
                    tree.num_cliques(), len(tree.levels()), tree.build_time)
    solve_tree_sweeps(fg, tree, solve_key=solve_key,
                      up=params.upsolve if up is None else up,
                      down=params.downsolve if down is None else down)
    for v in fg.variables.values():
        if v.solvable and v.is_initialized(solve_key):
            v.solved_count[solve_key] = v.get_solved_count(solve_key) + 1
    fg.solve_count += 1
    if verbose:
        logger.info("solve_tree done in %.3fs", time.time() - t0)
    return tree


def solve_graph(fg: FactorGraph, **kw) -> BayesTree:
    """Alias of :func:`solve_tree` (reference solveGraph! = solveTree!)."""
    return solve_tree(fg, **kw)

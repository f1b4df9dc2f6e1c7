"""Tree cost and structure metrics.

Counterpart of ``incrementalinference/jl_tpu/tree/analysis.py`` (reference
src/services/AnalysisTools.jl nnzTree, nnzSqrtInfoMatrix, getTreeCost_01/02,
getAllTrees, shrinkFactorGraph).
"""

from __future__ import annotations

from typing import Dict, List

from .bayestree import BayesTree
from .ordering import get_elimination_order

__all__ = ["nnz_frontals", "nnz_clique", "nnz_tree", "nnz_sqrt_info_matrix",
           "tree_cost_01", "tree_cost_02", "all_tree_costs",
           "shrink_factor_graph", "get_all_trees"]


def nnz_frontals(dim: int) -> int:
    """Upper-triangular non-zeros of a dim×dim frontal block (reference
    nnzFrontals; test/testAnalysisTools.jl:5-12)."""
    return dim * (dim + 1) // 2


def nnz_clique(clique) -> int:
    """Upper-triangular fill of one clique's frontal block plus the
    frontal×separator rectangle (reference nnzClique)."""
    m = len(clique.frontals)
    s = len(clique.separator)
    return m * (m + 1) // 2 + m * s


def nnz_tree(tree: BayesTree) -> int:
    """Non-zeros of the squared-root-information factor implied by the tree
    (reference nnzTree)."""
    return sum(nnz_clique(c) for c in tree.cliques.values())


def nnz_sqrt_info_matrix(fg, order=None) -> int:
    """nnz of R from symbolic elimination (reference nnzSqrtInfoMatrix)."""
    from .bayesnet import build_bayes_net
    order = order or get_elimination_order(fg)
    conds = build_bayes_net(fg, order)
    return sum(1 + len(c.separator) for c in conds)


def tree_cost_01(tree: BayesTree) -> float:
    """Cost model: Σ (frontals+separator)² per clique — total compute
    (reference getTreeCost_01)."""
    return float(sum((len(c.frontals) + len(c.separator)) ** 2
                     for c in tree.cliques.values()))


def tree_cost_02(tree: BayesTree) -> float:
    """Cost model: max clique dimension (critical path / treewidth proxy)
    (reference getTreeCost_02)."""
    return float(max((len(c.frontals) + len(c.separator))
                     for c in tree.cliques.values()))


def all_tree_costs(fg, orders: List[List[str]] | None = None,
                   n_random: int = 10) -> List[Dict]:
    """Evaluate tree costs across candidate orderings (reference
    getAllTrees usage in ordering experiments)."""
    import random as _random

    from .bayestree import build_tree

    rng = _random.Random(0)
    cands: List[List[str]] = list(orders or [])
    if not cands:
        base = fg.ls()
        cands.append(get_elimination_order(fg, "qr"))
        cands.append(get_elimination_order(fg, "ccolamd"))
        for _ in range(n_random):
            o = base[:]
            rng.shuffle(o)
            cands.append(o)
    out = []
    for o in cands:
        t = build_tree(fg, order=o)
        out.append({"order": o, "cost01": tree_cost_01(t),
                    "cost02": tree_cost_02(t), "nnz": nnz_tree(t),
                    "num_cliques": t.num_cliques()})
    return out


def shrink_factor_graph(fg, upto: int = 6):
    """Deep-copied subgraph keeping only the first ``upto`` pose-style
    variables (labels matching x<digits>, sorted) plus whatever else is
    solvable — the reference's analysis helper for tree-cost studies
    (shrinkFactorGraph, src/services/AnalysisTools.jl:18-34)."""
    import copy
    import re

    fgs = copy.deepcopy(fg)
    del_vars = {v for v in fgs.ls() if fgs.var(v).solvable == 0}
    poses = sorted((v for v in fgs.ls() if re.fullmatch(r"x\d+", v)),
                   key=lambda s: int(s[1:]))
    del_vars.update(poses[upto:])
    del_fcts = {fl for fl in fgs.lsf() if fgs.factor(fl).solvable == 0}
    for v in del_vars:
        del_fcts.update(fgs.factors_of(v))
    for fl in del_fcts:
        if fl in fgs.factors:
            fgs.remove_factor(fl)
    for v in del_vars:
        fgs.remove_variable(v)
    return fgs


def get_all_trees(fg) -> dict:
    """Build a tree for every elimination ordering and record its nnz cost
    (reference getAllTrees, src/services/AnalysisTools.jl:44-57; factorial —
    guarded to ≤11 variables like the reference)."""
    from itertools import permutations

    from .bayestree import build_tree_reset

    variables = fg.ls()
    if len(variables) > 11:
        raise ValueError("graph too large for exhaustive ordering sweep "
                         "(>11 variables — factorial explosion)")
    out = {}
    for i, order in enumerate(permutations(variables)):
        tree = build_tree_reset(fg, list(order))
        out[i] = (tree, list(order), float(nnz_tree(tree)))
    return out

"""Bayes (junction) tree assembly and clique bookkeeping.

Counterpart of ``incrementalinference/jl_tpu/tree/bayestree.py`` (reference
JunctionTreeUtils.jl: buildTree!/newPotential, buildTreeFromOrdering!,
setCliqPotentials!, setCliqMCIDs!, and clique recycling against the tree of
the previous solve: buildTreeReset!, attemptTreeSimilarClique).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

from .bayesnet import Conditional, build_bayes_net
from .ordering import get_elimination_order

__all__ = ["CliqStatus", "Clique", "BayesTree", "build_tree",
           "build_tree_reset"]


class CliqStatus(str, Enum):
    """Reference CliqStatus enum."""

    NULL = "NULL"
    NO_INIT = "NO_INIT"
    INITIALIZED = "INITIALIZED"
    UPSOLVED = "UPSOLVED"
    MARGINALIZED = "MARGINALIZED"
    DOWNSOLVED = "DOWNSOLVED"
    UPRECYCLED = "UPRECYCLED"
    ERROR_STATUS = "ERROR_STATUS"


@dataclass
class Clique:
    """Tree clique payload (reference BayesTreeNodeData)."""

    cid: int
    frontals: List[str]
    separator: List[str]
    parent: Optional[int] = None
    children: List[int] = field(default_factory=list)
    potentials: List[str] = field(default_factory=list)
    status: CliqStatus = CliqStatus.NULL
    is_recycled: bool = False
    is_marginalized: bool = False
    # Gibbs partitions (reference setCliqMCIDs!)
    direct_vars: List[str] = field(default_factory=list)
    iter_vars: List[str] = field(default_factory=list)
    msgskip_vars: List[str] = field(default_factory=list)
    # set by the down solve when the parent's message initialized it
    down_inited: bool = False

    @property
    def all_vars(self) -> List[str]:
        return self.frontals + self.separator

    def signature(self) -> Tuple:
        """Recycling identity: frontals, separator and potentials
        (reference attemptTreeSimilarClique match rule)."""
        return (tuple(sorted(self.frontals)), tuple(sorted(self.separator)),
                tuple(sorted(self.potentials)))


class BayesTree:
    """Reference MetaBayesTree."""

    def __init__(self):
        self.cliques: Dict[int, Clique] = {}
        self.frontal_to_clique: Dict[str, int] = {}
        self.elimination_order: List[str] = []
        self.conditionals: List[Conditional] = []
        self.build_time: float = 0.0
        # down-message summaries of the previous solve by clique signature,
        # read by the wildfire down-solve gate (SolverParams.wildfire_tol)
        self.down_cache: Dict[Tuple, dict] = {}
        # per-clique traces of the last solve (SolverParams.record_cliques)
        self.traces: Dict[int, object] = {}
        # parametric solves: Gaussian up messages by clique signature (the
        # next solve's recycling) and the size of each batched LM call
        self.param_up_msgs: Dict[Tuple, object] = {}
        self.param_batches: List[int] = []
        # up/down messages of the last sweep, for introspection
        self.up_msgs: Dict[int, object] = {}
        self.down_msgs: Dict[int, object] = {}
        self._euler = None

    @property
    def root_ids(self) -> List[int]:
        return [c.cid for c in self.cliques.values() if c.parent is None]

    def _euler_intervals(self):
        """Pre-order (tin, tout) per clique, for O(1) descendant tests."""
        if self._euler is not None and self._euler[2] == len(self.cliques):
            return self._euler[0], self._euler[1]
        tin: Dict[int, int] = {}
        tout: Dict[int, int] = {}
        t = 0
        for r in sorted(self.root_ids):
            stack = [(r, False)]
            while stack:
                cid, done = stack.pop()
                if done:
                    tout[cid] = t - 1
                    continue
                tin[cid] = t
                t += 1
                stack.append((cid, True))
                stack.extend((ch, False)
                             for ch in sorted(self.cliques[cid].children))
        self._euler = (tin, tout, len(self.cliques))
        return tin, tout

    def is_descendant_frontal(self, var: str, cid: int) -> bool:
        """True when ``var`` is a frontal of a strict descendant of
        ``cid``."""
        home = self.frontal_to_clique.get(var)
        if home is None or home == cid:
            return False
        tin, tout = self._euler_intervals()
        th = tin.get(home)
        return th is not None and tin[cid] < th <= tout[cid]

    def clique(self, cid: int) -> Clique:
        return self.cliques[cid]

    def clique_of(self, frontal: str) -> Clique:
        return self.cliques[self.frontal_to_clique[frontal]]

    def children(self, cid: int) -> List[Clique]:
        return [self.cliques[c] for c in self.cliques[cid].children]

    def levels(self) -> List[List[int]]:
        """Cliques grouped by depth, root level first."""
        depth: Dict[int, int] = {}
        stack = [(r, 0) for r in self.root_ids]
        while stack:
            cid, d = stack.pop()
            depth[cid] = d
            stack.extend((ch, d + 1) for ch in self.cliques[cid].children)
        out: List[List[int]] = []
        for cid, d in depth.items():
            while len(out) <= d:
                out.append([])
            out[d].append(cid)
        return out

    def num_cliques(self) -> int:
        return len(self.cliques)

    def is_root(self, cid: int) -> bool:
        """Reference isRoot(tree, CliqueId)."""
        return self.cliques[cid].parent is None

    def delete_clique(self, cid: int) -> Clique:
        """Remove a clique; its children become roots and its frontals are
        unindexed (reference deleteClique!)."""
        cl = self.cliques.pop(cid)
        for ch in cl.children:
            self.cliques[ch].parent = None
        if cl.parent is not None and cl.parent in self.cliques:
            par = self.cliques[cl.parent]
            par.children = [c for c in par.children if c != cid]
        for f in cl.frontals:
            self.frontal_to_clique.pop(f, None)
        return cl

    def __repr__(self):
        return (f"BayesTree({len(self.cliques)} cliques, "
                f"depth={len(self.levels())})")


def _assign_potentials(fg, tree: BayesTree) -> None:
    """Each factor goes to one clique: post-order, the first clique whose
    variables cover it and whose frontals touch it."""
    used = set()

    def visit(cl) -> None:
        cvars = set(cl.all_vars)
        frontals = set(cl.frontals)
        for vl in cl.frontals:
            for fl in fg.factors_of(vl):
                if fl in used:
                    continue
                f = fg.factor(fl)
                if f.solvable <= 0:
                    continue
                if set(f.variables) <= cvars and \
                        any(v in frontals for v in f.variables):
                    cl.potentials.append(fl)
                    used.add(fl)

    stack = [(r, False) for r in tree.root_ids]
    while stack:
        cid, expanded = stack.pop()
        if expanded:
            visit(tree.cliques[cid])
            continue
        stack.append((cid, True))
        stack.extend((ch, False) for ch in tree.cliques[cid].children)


def _partition_gibbs_vars(fg, tree: BayesTree) -> None:
    """Separator vars with no in-clique factor are message pass-throughs;
    vars touched by <= 1 potential solve once ("direct"); the rest iterate,
    sorted by potential count."""
    for cl in tree.cliques.values():
        counts = {v: 0 for v in cl.all_vars}
        for fl in cl.potentials:
            for v in fg.factor(fl).variables:
                if v in counts:
                    counts[v] += 1
        for ch in tree.children(cl.cid):
            for v in ch.separator:
                if v in counts:
                    counts[v] += 1
        cl.direct_vars, cl.iter_vars, cl.msgskip_vars = [], [], []
        for v in cl.frontals:
            (cl.direct_vars if counts[v] <= 1 else cl.iter_vars).append(v)
        for v in cl.separator:
            if counts[v] == 0:
                cl.msgskip_vars.append(v)
            elif counts[v] <= 1:
                cl.direct_vars.append(v)
            else:
                cl.iter_vars.append(v)
        cl.iter_vars.sort(key=lambda v: (-counts[v], v))


def build_tree(fg, order: Optional[Sequence[str]] = None,
               method: Optional[str] = None) -> BayesTree:
    """Elimination → Bayes net → Bayes tree + potentials + partitions
    (reference buildTreeFromOrdering!; Kaess Alg. 2 over the reversed
    order)."""
    t0 = time.perf_counter()
    if order is None:
        order = get_elimination_order(fg, method or fg.params.ordering)
    order = list(order)
    conditionals = build_bayes_net(fg, order)
    cond_of = {c.var: c for c in conditionals}
    elim_index = {v: i for i, v in enumerate(order)}

    tree = BayesTree()
    tree.elimination_order = order
    tree.conditionals = conditionals
    next_id = 0
    for var in reversed(order):
        sep = cond_of[var].separator
        parent = None
        if sep:
            fel = min(sep, key=lambda s: elim_index[s])
            cp = tree.cliques[tree.frontal_to_clique[fel]]
            if set(cp.all_vars) == set(sep):
                cp.frontals.append(var)
                tree.frontal_to_clique[var] = cp.cid
                continue
            parent = cp.cid
        next_id += 1
        cl = Clique(cid=next_id, frontals=[var], separator=list(sep),
                    parent=parent)
        tree.cliques[cl.cid] = cl
        tree.frontal_to_clique[var] = cl.cid
        if parent is not None:
            tree.cliques[parent].children.append(cl.cid)

    _assign_potentials(fg, tree)
    _partition_gibbs_vars(fg, tree)
    tree.build_time = time.perf_counter() - t0
    return tree


_RECYCLABLE = (CliqStatus.UPSOLVED, CliqStatus.DOWNSOLVED,
               CliqStatus.UPRECYCLED, CliqStatus.MARGINALIZED)


def build_tree_reset(fg, order: Optional[Sequence[str]] = None,
                     method: Optional[str] = None,
                     old_tree: Optional[BayesTree] = None) -> BayesTree:
    """Rebuild the tree and mark the cliques that can be recycled from
    ``old_tree`` (reference buildTreeReset! + attemptTreeSimilarClique)."""
    tree = build_tree(fg, order=order, method=method)
    if old_tree is None:
        return tree
    # carry over only the summaries of signatures the new tree still has: a
    # plain copy would grow with every signature a growing graph ever had
    live = {c.signature() for c in tree.cliques.values()}
    tree.down_cache = {sig: s for sig, s in old_tree.down_cache.items()
                       if sig in live}
    if not fg.params.incremental:
        return tree
    old_by_sig = {c.signature(): c for c in old_tree.cliques.values()}
    for cl in tree.cliques.values():
        old = old_by_sig.get(cl.signature())
        if old is None:
            continue
        if old.status in _RECYCLABLE:
            cl.is_recycled = True
            cl.status = CliqStatus.UPRECYCLED
        if old.is_marginalized:
            cl.is_marginalized = True
            cl.status = CliqStatus.MARGINALIZED

    # an up message depends on every descendant's up-solve: a clique stays
    # recycled only if its whole subtree is (post-order, explicit stack)
    stack = [(r, False) for r in tree.root_ids]
    while stack:
        cid, expanded = stack.pop()
        cl = tree.cliques[cid]
        if not expanded:
            stack.append((cid, True))
            stack.extend((ch, False) for ch in cl.children)
            continue
        ok = all(tree.cliques[ch].is_recycled
                 or tree.cliques[ch].is_marginalized for ch in cl.children)
        if cl.is_recycled and not ok:
            cl.is_recycled = False
            cl.status = CliqStatus.NULL
    return tree

"""Bayes-tree and clique accessors.

Counterpart of ``incrementalinference/jl_tpu/tree/accessors.py`` (reference
JunctionTreeUtils.jl, TreeMessageAccessors.jl, TreeBasedInitialization.jl,
TreeDebugTools.jl treeProductUp/Dwn): every function a user calls to
interrogate or hand-steer a tree solve.  Host-side structural code only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bayestree import BayesTree, Clique, CliqStatus

__all__ = [
    "get_clique", "get_cliques", "get_clique_ids", "get_clique_data",
    "set_clique_data", "has_clique", "get_num_cliqs", "get_frontals",
    "get_parent", "get_children", "parent_cliq", "child_cliqs",
    "get_cliq_depth", "get_cliq_siblings",
    "get_cliq_frontal_var_ids", "get_cliq_separator_var_ids",
    "get_cliq_all_var_ids", "get_cliq_var_ids_all",
    "get_cliq_factor_ids_all", "get_cliq_factors", "get_clique_potentials",
    "get_cliq_var_ids_priors", "get_cliq_var_singletons",
    "get_cliq_num_assoc_factors_per_var", "get_cliq_assoc_mat",
    "get_cliq_msg_mat", "get_cliq_mat",
    "get_clique_status", "set_clique_status", "get_cliq_status",
    "get_clique_draw_color", "set_clique_draw_color",
    "is_cliq_initialized", "is_cliq_up_solved", "is_tree_solved",
    "is_up_inference_complete",
    "are_cliq_variables_all_initialized",
    "are_cliq_variables_all_marginalized",
    "append_separator_to_clique", "get_tree_all_frontal_syms",
    "get_cliq_var_solve_order_up", "get_cliq_init_var_order_down",
    "reset_cliq_solve",
    "reset_tree_cliques_for_up_solve", "calc_cliques_recycled",
    "get_tree_cliq_up_msgs_all", "stack_cliq_up_msgs_by_variable",
    "get_cliq_down_msgs_after_down_solve",
    "tree_product_up", "tree_product_down",
    "get_cliq_vars_with_frontal_neighbors",
    "are_siblings_remaining_need_down_only",
    "reset_data", "build_clique_potentials",
]


# ---------------------------------------------------------------------------
# clique lookup (reference getClique/getCliques/hasClique/getFrontals)
# ---------------------------------------------------------------------------

def get_clique(tree: BayesTree, key) -> Clique:
    """Reference ``getClique`` — by CliqueId or by frontal variable label."""
    if isinstance(key, str):
        return tree.clique_of(key)
    return tree.clique(int(key))


def get_cliques(tree: BayesTree) -> Dict[int, Clique]:
    """Reference ``getCliques``."""
    return tree.cliques


def get_clique_ids(tree: BayesTree) -> List[int]:
    """Reference ``getCliqueIds``."""
    return list(tree.cliques.keys())


def get_clique_data(tree: BayesTree, key) -> Clique:
    """Reference ``getCliqueData`` — here the Clique IS its payload."""
    return get_clique(tree, key)


def set_clique_data(tree: BayesTree, cid: int, data: Clique) -> Clique:
    """Reference ``setCliqueData!``."""
    data.cid = cid
    tree.cliques[cid] = data
    for f in data.frontals:
        tree.frontal_to_clique[f] = cid
    return data


def has_clique(tree: BayesTree, frontal: str) -> bool:
    """Reference ``hasClique`` — does some clique own this frontal."""
    return frontal in tree.frontal_to_clique


def get_num_cliqs(tree: BayesTree) -> int:
    """Reference ``getNumCliqs``."""
    return tree.num_cliques()


def get_frontals(cliq: Clique) -> List[str]:
    """Reference ``getFrontals``."""
    return list(cliq.frontals)


# ---------------------------------------------------------------------------
# tree topology (reference getParent/getChildren/getCliqDepth/siblings)
# ---------------------------------------------------------------------------

def get_parent(tree: BayesTree, cliq: Clique) -> Optional[Clique]:
    """Reference ``getParent``/``parentCliq``."""
    return None if cliq.parent is None else tree.clique(cliq.parent)


def get_children(tree: BayesTree, cliq: Clique) -> List[Clique]:
    """Reference ``getChildren``/``childCliqs``."""
    return tree.children(cliq.cid)


def parent_cliq(tree: BayesTree, cliq: Clique) -> List[Clique]:
    """Reference ``parentCliq`` — list form (empty at root)."""
    p = get_parent(tree, cliq)
    return [] if p is None else [p]


def child_cliqs(tree: BayesTree, cliq: Clique) -> List[Clique]:
    """Reference ``childCliqs``."""
    return get_children(tree, cliq)


def get_cliq_depth(tree: BayesTree, cliq: Clique) -> int:
    """Reference ``getCliqDepth`` — root has depth 0."""
    d, cur = 0, cliq
    while cur.parent is not None:
        cur = tree.clique(cur.parent)
        d += 1
    return d


def get_cliq_siblings(tree: BayesTree, cliq: Clique,
                      inclusive: bool = False) -> List[Clique]:
    """Reference ``getCliqSiblings``."""
    if cliq.parent is None:
        sibs = [tree.clique(c) for c in tree.root_ids]
    else:
        sibs = tree.children(cliq.parent)
    if inclusive:
        return sibs
    return [c for c in sibs if c.cid != cliq.cid]


# ---------------------------------------------------------------------------
# clique contents (reference getCliq*VarIds / factors / potentials)
# ---------------------------------------------------------------------------

def get_cliq_frontal_var_ids(cliq: Clique) -> List[str]:
    """Reference ``getCliqFrontalVarIds``."""
    return list(cliq.frontals)


def get_cliq_separator_var_ids(cliq: Clique) -> List[str]:
    """Reference ``getCliqSeparatorVarIds``."""
    return list(cliq.separator)


def get_cliq_all_var_ids(cliq: Clique) -> List[str]:
    """Reference ``getCliqAllVarIds``/``getCliqVarIdsAll``."""
    return cliq.all_vars


get_cliq_var_ids_all = get_cliq_all_var_ids


def get_cliq_factor_ids_all(cliq: Clique) -> List[str]:
    """Reference ``getCliqFactorIdsAll`` — the clique's potential labels."""
    return list(cliq.potentials)


def get_cliq_factors(fg, cliq: Clique) -> List:
    """Reference ``getCliqFactors`` — resolved Factor objects."""
    return [fg.factor(fl) for fl in cliq.potentials]


def get_clique_potentials(cliq: Clique) -> List[str]:
    """Reference ``getCliquePotentials``."""
    return list(cliq.potentials)


def get_cliq_var_ids_priors(fg, cliq: Clique,
                            all_vars: Optional[Sequence[str]] = None
                            ) -> List[str]:
    """Reference ``getCliqVarIdsPriors`` — clique variables carrying a
    singleton (prior) potential."""
    all_vars = list(all_vars) if all_vars is not None else cliq.all_vars
    out = []
    for v in all_vars:
        for fl in cliq.potentials:
            f = fg.factor(fl)
            if len(f.variables) == 1 and f.variables[0] == v:
                out.append(v)
                break
    return out


def get_cliq_var_singletons(fg, cliq: Clique) -> List[str]:
    """Reference ``getCliqVarSingletons`` — prior-carrying clique vars."""
    return get_cliq_var_ids_priors(fg, cliq)


def get_cliq_num_assoc_factors_per_var(fg, tree: BayesTree,
                                       cid: int) -> np.ndarray:
    """Reference ``getCliqNumAssocFactorsPerVar`` — column sums of the
    clique association matrix."""
    M = get_cliq_assoc_mat(fg, tree, cid)
    return M.sum(axis=0)


def get_cliq_assoc_mat(fg, tree: BayesTree, cid: int) -> np.ndarray:
    """Reference ``getCliqAssocMat`` — factor rows only (no message rows),
    clique-variable columns (compCliqAssocMatrices!,
    JunctionTreeUtils.jl:1294-1340)."""
    from ..debugging import clique_assoc_matrix
    rows, _cols, M = clique_assoc_matrix(fg, tree, cid)
    keep = [i for i, r in enumerate(rows) if not r.startswith("msg:")]
    return M[keep] if len(keep) else M[:0]


def get_cliq_msg_mat(fg, tree: BayesTree, cid: int) -> np.ndarray:
    """Reference ``getCliqMsgMat`` — child-message rows only."""
    from ..debugging import clique_assoc_matrix
    rows, _cols, M = clique_assoc_matrix(fg, tree, cid)
    keep = [i for i, r in enumerate(rows) if r.startswith("msg:")]
    return M[keep] if len(keep) else M[:0]


def get_cliq_mat(fg, tree: BayesTree, cid: int) -> np.ndarray:
    """Reference ``getCliqMat`` — assoc + message rows stacked."""
    from ..debugging import clique_assoc_matrix
    _rows, _cols, M = clique_assoc_matrix(fg, tree, cid)
    return M


# ---------------------------------------------------------------------------
# status / draw color (reference TreeMessageAccessors.jl:23-36)
# ---------------------------------------------------------------------------

def get_clique_status(cliq: Clique) -> CliqStatus:
    """Reference ``getCliqueStatus``."""
    return cliq.status


get_cliq_status = get_clique_status


def set_clique_status(cliq: Clique, status: CliqStatus) -> CliqStatus:
    """Reference ``setCliqueStatus!``."""
    cliq.status = CliqStatus(status)
    return cliq.status


def get_clique_draw_color(cliq: Clique) -> str:
    """Reference ``getCliqueDrawColor`` — explicit color if set, else the
    status-derived scheme the reference paints live trees with
    (CliqueStateMachine.jl:314-315,428; same map as debugging.tree_to_dot)."""
    from ..debugging import _STATUS_COLOR
    c = getattr(cliq, "draw_color", None)
    return c or _STATUS_COLOR.get(cliq.status, "gray")


def set_clique_draw_color(cliq: Clique, color: str) -> str:
    """Reference ``setCliqueDrawColor!``."""
    cliq.draw_color = color
    return color


# ---------------------------------------------------------------------------
# solve-state predicates (reference isCliqInitialized/isTreeSolved/...)
# ---------------------------------------------------------------------------

def is_cliq_initialized(cliq: Clique) -> bool:
    """Reference ``isCliqInitialized``."""
    return cliq.status in (CliqStatus.INITIALIZED, CliqStatus.UPSOLVED,
                           CliqStatus.DOWNSOLVED, CliqStatus.UPRECYCLED,
                           CliqStatus.MARGINALIZED)


def is_cliq_up_solved(cliq: Clique) -> bool:
    """Reference ``isCliqUpSolved``.  DOWNSOLVED implies the up pass
    completed earlier in the same sweep (the static schedule stores one
    status, not the reference's per-phase history)."""
    return cliq.status in (CliqStatus.UPSOLVED, CliqStatus.UPRECYCLED,
                           CliqStatus.MARGINALIZED, CliqStatus.DOWNSOLVED)


def is_tree_solved(tree: BayesTree, up_only: bool = False) -> bool:
    """Reference ``isTreeSolved`` — all cliques reached a terminal solved
    status."""
    ok_up = (CliqStatus.UPSOLVED, CliqStatus.UPRECYCLED,
             CliqStatus.MARGINALIZED, CliqStatus.DOWNSOLVED)
    ok_full = (CliqStatus.DOWNSOLVED, CliqStatus.MARGINALIZED)
    ok = ok_up if up_only else ok_full
    return all(c.status in ok for c in tree.cliques.values())


def is_up_inference_complete(tree: BayesTree) -> bool:
    """Reference ``isUpInferenceComplete``."""
    return is_tree_solved(tree, up_only=True)


def are_cliq_variables_all_initialized(fg, cliq: Clique,
                                       solve_key: str = "default") -> bool:
    """Reference ``areCliqVariablesAllInitialized``
    (TreeBasedInitialization.jl:143)."""
    return all(fg.var(v).is_initialized(solve_key) for v in cliq.all_vars)


def are_cliq_variables_all_marginalized(fg, cliq: Clique) -> bool:
    """Reference ``areCliqVariablesAllMarginalized``."""
    return all(fg.var(v).marginalized for v in cliq.all_vars)


# ---------------------------------------------------------------------------
# tree edits / resets (reference appendSeparatorToClique!, resetCliqSolve!)
# ---------------------------------------------------------------------------

def append_separator_to_clique(tree: BayesTree, cid: int,
                               seplbls: Sequence[str]) -> Clique:
    """Reference ``appendSeparatorToClique!`` — extend a clique's separator
    (used by tree surgery / manual message routing)."""
    cl = tree.clique(cid)
    for s in seplbls:
        if s not in cl.separator and s not in cl.frontals:
            cl.separator.append(s)
    return cl


def get_tree_all_frontal_syms(tree: BayesTree) -> List[str]:
    """Reference ``getTreeAllFrontalSyms``."""
    return [f for c in tree.cliques.values() for f in c.frontals]


def get_cliq_var_solve_order_up(fg, cliq: Clique) -> List[str]:
    """Reference ``getCliqVarSolveOrderUp`` — the Gibbs update sequence the
    up-solve uses (direct first, then iterated)."""
    return list(cliq.direct_vars) + list(cliq.iter_vars)


def reset_cliq_solve(fg, tree: BayesTree, cid: int,
                     solve_key: str = "default") -> Clique:
    """Reference ``resetCliqSolve!`` — clear the clique status and its
    frontal variables' solver data for a fresh up-solve."""
    from ..fgos import reset_variable
    cl = tree.clique(cid)
    cl.status = CliqStatus.NULL
    cl.is_recycled = False
    tree.up_msgs.pop(cid, None)
    for v in cl.frontals:
        reset_variable(fg, v, solve_key)
    return cl


def reset_tree_cliques_for_up_solve(tree: BayesTree) -> BayesTree:
    """Reference ``resetTreeCliquesForUpSolve!`` — statuses back to NULL."""
    for c in tree.cliques.values():
        if c.status != CliqStatus.MARGINALIZED:
            c.status = CliqStatus.NULL
    return tree


def calc_cliques_recycled(tree: BayesTree) -> Tuple[int, int, int, int]:
    """Reference ``calcCliquesRecycled`` (JunctionTreeUtils.jl:1775-1788):
    (total, marginalized, reused/up-recycled, both)."""
    total = len(tree.cliques)
    marg = sum(1 for c in tree.cliques.values() if c.is_marginalized)
    reused = sum(1 for c in tree.cliques.values() if c.is_recycled)
    both = sum(1 for c in tree.cliques.values()
               if c.is_marginalized and c.is_recycled)
    return total, marg, reused, both


# ---------------------------------------------------------------------------
# up-message introspection + manual clique products
# (reference getTreeCliqUpMsgsAll, stackCliqUpMsgsByVariable,
#  treeProductUp/Dwn — TreeDebugTools.jl:50-114)
# ---------------------------------------------------------------------------

def get_tree_cliq_up_msgs_all(tree: BayesTree) -> Dict[int, object]:
    """Reference ``getTreeCliqUpMsgsAll`` — per-clique up messages retained
    from the last sweep."""
    return dict(tree.up_msgs)


def get_cliq_down_msgs_after_down_solve(tree: BayesTree, cid: int
                                        ) -> Dict[int, object]:
    """Reference ``getCliqDownMsgsAfterDownSolve`` — the down messages this
    clique sent to each child during the last sweep (keyed by child cid)."""
    return {ch: tree.down_msgs[ch] for ch in tree.clique(cid).children
            if ch in tree.down_msgs}


def stack_cliq_up_msgs_by_variable(tree: BayesTree
                                   ) -> Dict[str, List[dict]]:
    """Reference ``stackCliqUpMsgsByVariable`` — regroup the tree's up
    messages per separator variable: label → list of {cliqId, belief}."""
    out: Dict[str, List[dict]] = {}
    for cid, msg in tree.up_msgs.items():
        beliefs = getattr(msg, "beliefs", None) or {}
        for lbl, b in beliefs.items():
            out.setdefault(lbl, []).append({"cliqId": cid, "belief": b})
    return out


def tree_product_up(fg, tree: BayesTree, frontal: str, var: str,
                    solve_key: str = "default"):
    """Reference ``treeProductUp`` (TreeDebugTools.jl:50-87): manually
    compute the product of a clique's own potentials touching ``var`` plus
    the child up-messages over it.  Returns the product Belief."""
    from ..ops.graphops import local_product
    from ..parallel.messages import add_msg_factors, delete_msg_factors
    from ..parallel.scheduler import build_clique_subgraph

    cl = tree.clique_of(frontal)
    sub = build_clique_subgraph(fg, cl)
    added = []
    for ch in cl.children:
        msg = tree.up_msgs.get(ch)
        if msg is not None:
            added += add_msg_factors(sub, msg)
    b, _ipc = local_product(sub, var, solve_key=solve_key)
    delete_msg_factors(sub, added)
    return b


def tree_product_down(fg, tree: BayesTree, frontal: str, var: str,
                      solve_key: str = "default"):
    """Reference ``treeProductDwn`` (TreeDebugTools.jl:89-114): product of
    the clique potentials for ``var`` using the parent-clique posture (no
    child messages) — the down-solve's frontal product."""
    from ..ops.graphops import local_product
    from ..parallel.scheduler import build_clique_subgraph

    cl = tree.clique_of(frontal)
    sub = build_clique_subgraph(fg, cl)
    b, _ipc = local_product(sub, var, solve_key=solve_key)
    return b


# ---------------------------------------------------------------------------
# frontal-neighborhood expansion + down-solve sibling gating + node resets
# ---------------------------------------------------------------------------

def get_cliq_vars_with_frontal_neighbors(fg, cliq: Clique,
                                         solvable: int = 1) -> List[str]:
    """All clique variables plus every variable sharing a factor with a
    frontal (reference getCliqVarsWithFrontalNeighbors,
    JunctionTreeUtils.jl:1185-1203) — the variable set a down solve pulls
    into the clique subgraph."""
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


def are_siblings_remaining_need_down_only(tree: BayesTree, cid: int) -> bool:
    """True when no sibling of ``cid`` can still make upward progress
    (reference areSiblingsRemaingNeedDownOnly,
    CliqStateMachineUtils.jl:321-337): every other child of the parent has
    left the NULL/INITIALIZED "still busy" states, so a down-only solve of
    this clique may proceed."""
    still_busy = (CliqStatus.NULL, CliqStatus.INITIALIZED)
    cl = tree.clique(cid)
    if cl.parent is None:
        return True
    for sib in tree.clique(cl.parent).children:
        if sib != cid and tree.clique(sib).status in still_busy:
            return False
    return True


def reset_data(node) -> None:
    """Wipe per-elimination bookkeeping from one variable or factor
    (reference resetData!, JunctionTreeUtils.jl:865-878).  Our elimination
    keeps variable-side state inside the BayesNet pass, so only the factor
    ``potential_used`` flag persists on the graph object."""
    if hasattr(node, "potential_used"):
        node.potential_used = False


def build_clique_potentials(fg, tree: BayesTree) -> BayesTree:
    """Re-run the post-order potential assignment + Gibbs partitioning on an
    assembled tree (reference buildCliquePotentials,
    JunctionTreeUtils.jl:1526-1542).  ``build_tree`` already calls this; the
    public entry exists for hand-assembled or loaded trees."""
    from .bayestree import _assign_potentials, _partition_gibbs_vars
    for c in tree.cliques.values():
        c.potentials = []
    _assign_potentials(fg, tree)
    _partition_gibbs_vars(fg, tree)
    return tree


def get_cliq_init_var_order_down(fg, tree: BayesTree, cid: int,
                                 dwnkeys: Sequence[str]) -> List[str]:
    """Down-init variable order (reference getCliqInitVarOrderDown,
    TreeBasedInitialization.jl:59-105): singleton-backed variables first
    (down-message separators count as priors), each group sorted by
    ascending clique-factor association count."""
    cl = tree.clique(cid)
    allsyms = cl.all_vars
    dwnvarids = [v for v in dwnkeys if v in allsyms and v in fg.variables]
    prvarids = get_cliq_var_ids_priors(fg, cl, allsyms)
    nfcts = get_cliq_num_assoc_factors_per_var(fg, tree, cid).astype(float)
    for i, v in enumerate(allsyms):
        if v in dwnvarids:
            nfcts[i] += 1.0
    sortedids = [allsyms[i] for i in np.argsort(nfcts, kind="stable")]
    singids = set(prvarids) | set(dwnvarids)
    order = [v for v in sortedids if v in singids]
    order += [v for v in sortedids if v not in order]
    return order

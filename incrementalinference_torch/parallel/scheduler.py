"""Level-ordered Bayes-tree sweeps, one clique at a time.

Counterpart of the sequential path of
``incrementalinference/jl_tpu/parallel/scheduler.py`` (reference clique
state machine, CliqueStateMachine.jl): an up sweep from the leaves to the
root, then a down sweep, each clique solved on a subgraph of its variables,
potentials and message factors.  Cliques the up sweep cannot initialize are
initialized from their parent's down message; the up sweep then re-runs
over them and their ancestors and the down sweep repeats, at most
``SolverParams.limit_treeinit_iters`` times.

Not ported yet: batched same-level solves, chain segments, clique recycling
and the wildfire gate, fault injection, multi-device placement.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

from ..beliefs import LazyPPE
from ..graph import FactorGraph, Variable
from ..graphinit import doautoinit
from ..ops.graphops import (canonical_factors, conv_entry, ipc_of,
                            local_product_and_update)
from ..tree.accessors import (find_factors_between_from,
                              get_cliq_vars_with_frontal_neighbors)
from ..tree.bayestree import BayesTree, Clique, CliqStatus
from .messages import (LikelihoodMessage, add_msg_factors, prep_msg_down,
                       prep_msg_up)

__all__ = ["build_clique_subgraph", "transfer_update_subgraph",
           "add_down_variable_factors", "up_solve_clique",
           "down_solve_clique", "solve_tree_sweeps",
           "cliq_var_init_order_up"]

logger = logging.getLogger(__name__)


def _copy_variable(v: Variable) -> Variable:
    """A subgraph's view of a variable: its own dicts, shared tensors."""
    return Variable(label=v.label, vartype=v.vartype, N=v.N,
                    tags=set(v.tags), solvable=v.solvable,
                    beliefs=dict(v.beliefs), initialized=dict(v.initialized),
                    ppe=dict(v.ppe), marginalized=v.marginalized)


def build_clique_subgraph(fg: FactorGraph, clique: Clique) -> FactorGraph:
    """Frontal + separator variables and the clique's potentials as a local
    subgraph (reference buildCliqSubgraph!), with its own key stream."""
    sub = FactorGraph(fg.params, device=fg.device)
    sub.reseed(fg.next_key())
    for vl in clique.all_vars:
        sub.variables[vl] = _copy_variable(fg.var(vl))
        sub._var_factors[vl] = []
    for fl in clique.potentials:
        f = fg.factor(fl)
        sub.factors[fl] = f
        for vl in f.variables:
            if vl in sub._var_factors:
                sub._var_factors[vl].append(fl)
    return sub


class _DescendantFrontals:
    """Set-like 'frontals of strict descendants of cid'."""

    __slots__ = ("tree", "cid")

    def __init__(self, tree, cid: int):
        self.tree = tree
        self.cid = cid

    def __contains__(self, var: str) -> bool:
        return self.tree.is_descendant_frontal(var, self.cid)


def add_down_variable_factors(fg: FactorGraph, sub: FactorGraph, clique,
                              solvable: int = 1,
                              require_initialized: Optional[str] = None,
                              exclude=None):
    """Widen a clique subgraph with the frontals' neighbor variables and
    the factors connecting them (reference addDownVariableFactors!).
    Returns ``(new_vars, new_factors)``."""
    allclsyms = get_cliq_vars_with_frontal_neighbors(fg, clique,
                                                     solvable=solvable)
    newsyms = [s for s in allclsyms if s not in sub.variables]
    if require_initialized is not None:
        newsyms = [s for s in newsyms
                   if fg.var(s).is_initialized(require_initialized)]
    if exclude is not None:
        newsyms = [s for s in newsyms if s not in exclude]
    scope = set(sub.variables) | set(newsyms)
    newfcts: List[str] = []
    for frt in clique.frontals:
        for fl in find_factors_between_from(fg, scope, frt):
            if fl not in newfcts and fl not in sub.factors:
                newfcts.append(fl)
    for vl in newsyms:
        sub.variables[vl] = _copy_variable(fg.var(vl))
        sub._var_factors[vl] = []
    for fl in newfcts:
        f = fg.factor(fl)
        sub.factors[fl] = f
        for vl in f.variables:
            if vl in sub._var_factors and fl not in sub._var_factors[vl]:
                sub._var_factors[vl].append(fl)
    return newsyms, newfcts


def transfer_update_subgraph(fg: FactorGraph, sub: FactorGraph,
                             labels: List[str],
                             solve_key: str = "default") -> None:
    """Write solved beliefs and (lazy) PPEs back to the main graph
    (reference transferUpdateSubGraph!)."""
    for vl in labels:
        sv = sub.var(vl)
        if solve_key not in sv.beliefs:
            continue
        b = sv.beliefs[solve_key]
        fg.set_belief(vl, b.points, solve_key=solve_key, bw=b.bw, ipc=b.ipc,
                      initialized=sv.is_initialized(solve_key))
        fg.var(vl).ppe[solve_key] = LazyPPE(sv.manifold, b)


def _use_chain(params) -> bool:
    """``fuse_clique``: True/"auto" run the clique chain, False the
    per-variable path (same schedule either way)."""
    return getattr(params, "fuse_clique", "auto") is not False


def cliq_var_init_order_up(sub: FactorGraph,
                           variables: Optional[Sequence[str]] = None
                           ) -> List[str]:
    """Clique up-init order (reference getCliqVarInitOrderUp):
    prior-attached variables first, then the rest, each by ascending
    factor count (stable)."""
    labels = list(variables) if variables is not None else sub.ls()
    nf = {v: len(sub.factors_of(v)) for v in labels}
    sortedids = sorted(labels, key=lambda v: nf[v])
    prior_attached = set()
    for fl in sub.lsf():
        f = sub.factor(fl)
        if getattr(f.model, "is_prior", False):
            prior_attached.update(f.variables)
    return ([v for v in sortedids if v in prior_attached]
            + [v for v in sortedids if v not in prior_attached])


def _cycle_init_by_var_order(sub: FactorGraph, clique: Clique,
                             solve_key: str = "default") -> bool:
    """Repeat auto-init over the clique's variables until nothing changes
    (reference cycleInitByVarOrder!), at most ``limit_iters`` passes."""
    max_cycles = max(1, int(sub.params.limit_iters))
    order = cliq_var_init_order_up(sub, clique.all_vars)

    def all_init():
        return all(sub.var(v).is_initialized(solve_key)
                   for v in clique.all_vars)

    for _ in range(max_cycles):
        changed = False
        for vl in order:
            if not sub.var(vl).is_initialized(solve_key):
                if doautoinit(sub, vl, solve_key=solve_key):
                    changed = True
        if all_init():
            return True
        if not changed:
            return False
    return all_init()


def _gibbs_solve(sub: FactorGraph, variables: List[str], iters: int,
                 solve_key: str = "default") -> None:
    """Per-variable Gibbs: each variable's product over all its factors,
    written back after every update (reference fmcmc!)."""
    for _ in range(iters):
        for vl in variables:
            if sub.var(vl).marginalized or not sub.factors_of(vl):
                continue
            local_product_and_update(sub, vl, solve_key=solve_key)


def _build_chain_plan(sub: FactorGraph, direct: List[str],
                      iter_vars: List[str], solve_key: str = "default"):
    """The whole-clique chain plan over the subgraph (message factors
    included).  Returns (plan, store, live): plan is a dict of steps,
    models and masks, or True (nothing to solve) / False (the clique needs
    the per-variable path: mixed particle counts)."""
    from ..ops.convolve import null_surplus_map

    params = sub.params
    live = list(sub.variables)
    local = {v: i for i, v in enumerate(live)}

    def updatable(vl):
        return not sub.var(vl).marginalized and sub.factors_of(vl)

    dvs = [v for v in direct if updatable(v)]
    ivs = [v for v in iter_vars if updatable(v)]
    if not dvs and not ivs:
        return True, None, live
    store = [sub.points(v, solve_key) for v in live]
    if len({p.shape[0] for p in store}) != 1:
        return False, None, live

    plan = {"direct": [], "iter": [], "models_direct": [],
            "models_iter": [], "touched": {}}
    for var in dvs + ivs:
        v = sub.var(var)
        factors = canonical_factors(sub, var, sub.factors_of(var))
        if not factors:
            continue
        if v.N != store[local[var]].shape[0]:
            return False, None, live
        if any(lbl not in local for f in factors for lbl in f.variables):
            return False, None, live
        nsrp = null_surplus_map(params, factors)
        specs, masks, models, fvidx = [], [], [], []
        for f in factors:
            spec, mask = conv_entry(sub, f, var, nsrp[f.label])
            specs.append(spec)
            masks.append(mask)
            models.append(f.model)
            fvidx.append(tuple(local[lbl] for lbl in f.variables))
        step = (local[var], v.manifold, tuple(specs), tuple(masks), v.N,
                tuple(fvidx))
        which = "direct" if var in dvs else "iter"
        plan[which].append(step)
        plan["models_" + which].append(tuple(models))
        plan["touched"][local[var]] = tuple(masks)
    if not plan["direct"] and not plan["iter"]:
        return True, None, live
    return plan, store, live


def _gibbs_solve_chain(sub: FactorGraph, direct: List[str],
                       iter_vars: List[str],
                       solve_key: str = "default") -> bool:
    """The clique's Gibbs schedule on a local store (ops/fused.py
    fused_clique_gibbs): direct variables once, iterated variables
    ``gibbs_iters`` rounds; beliefs are written back at the end.  Returns
    False when the clique needs the per-variable path."""
    from ..ops.fused import fused_clique_gibbs

    plan, store, live = _build_chain_plan(sub, direct, iter_vars, solve_key)
    if plan is True or plan is False:
        return plan
    new_store, dbws, ibws = fused_clique_gibbs(
        plan["direct"], plan["iter"], sub.params.gibbs_iters,
        plan["models_direct"], plan["models_iter"], store, sub.next_key())
    bw_of = {step[0]: bw for step, bw in zip(plan["direct"], dbws)}
    bw_of.update({step[0]: bw for step, bw in zip(plan["iter"], ibws)})
    for li, masks in plan["touched"].items():
        sub.set_belief(live[li], new_store[li], solve_key=solve_key,
                       bw=bw_of[li], ipc=ipc_of(masks, sub.device))
    return True


def _solve_clique_vars(sub: FactorGraph, direct: List[str],
                       iter_vars: List[str], solve_key: str) -> None:
    if _use_chain(sub.params) and _gibbs_solve_chain(sub, direct, iter_vars,
                                                     solve_key):
        return
    _gibbs_solve(sub, direct, 1, solve_key)
    if iter_vars:
        _gibbs_solve(sub, iter_vars, sub.params.gibbs_iters, solve_key)


def up_solve_clique(fg: FactorGraph, tree: BayesTree, clique: Clique,
                    child_msgs: List[LikelihoodMessage],
                    solve_key: str = "default") -> LikelihoodMessage:
    """One clique up-solve (reference CSM preUpSolve_ → solveUp_ →
    postUpSolve_, Gibbs body of upGibbsCliqueDensity)."""
    sub = build_clique_subgraph(fg, clique)
    for msg in child_msgs:
        if msg.status == CliqStatus.ERROR_STATUS:
            clique.status = CliqStatus.ERROR_STATUS
            raise RuntimeError(
                f"clique {clique.cid}: child {msg.sender} errored")
        add_msg_factors(sub, msg)

    if not _cycle_init_by_var_order(sub, clique, solve_key):
        # parents may still initialize it downward
        clique.status = CliqStatus.NO_INIT
        msg = prep_msg_up(sub, clique, CliqStatus.NO_INIT, solve_key)
        transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
        return msg

    _solve_clique_vars(sub, list(clique.direct_vars), clique.iter_vars,
                       solve_key)
    clique.status = CliqStatus.UPSOLVED
    msg = prep_msg_up(sub, clique, CliqStatus.UPSOLVED, solve_key)
    transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
    return msg


def down_solve_clique(fg: FactorGraph, tree: BayesTree, clique: Clique,
                      down_msg: Optional[LikelihoodMessage],
                      solve_key: str = "default",
                      child_msgs: Optional[List[LikelihoodMessage]] = None
                      ) -> Dict[int, LikelihoodMessage]:
    """One clique down-solve (reference CSM down states; frontal products
    of solveCliqDownFrontalProducts!).  The children's up messages stay
    attached, as in the reference's down phase.  Returns the down messages
    for each child."""
    sub = build_clique_subgraph(fg, clique)
    # frontal neighbors widen the subgraph; descendants' frontals stay out
    # (their information arrives through the child up messages)
    add_down_variable_factors(fg, sub, clique,
                              require_initialized=solve_key,
                              exclude=_DescendantFrontals(tree, clique.cid))
    for cmsg in (child_msgs or []):
        add_msg_factors(sub, cmsg)

    def no_init_msgs():
        return {ch.cid: prep_msg_down(sub, clique, ch, CliqStatus.NO_INIT,
                                      solve_key)
                for ch in tree.children(clique.cid)}

    def all_init():
        return all(sub.var(v).is_initialized(solve_key)
                   for v in clique.all_vars)

    clique.down_inited = False
    if down_msg is not None and clique.status == CliqStatus.NO_INIT:
        # down-init from the parent's solved separators (tryDownInit_)
        pre_uninit = {v for v in clique.all_vars
                      if not sub.var(v).is_initialized(solve_key)}
        for vlbl, belief in down_msg.beliefs.items():
            if vlbl in sub.variables:
                sub.set_belief(vlbl, belief.points, solve_key=solve_key,
                               bw=belief.bw, ipc=belief.ipc)
        _cycle_init_by_var_order(sub, clique, solve_key)
        clique.down_inited = any(sub.var(v).is_initialized(solve_key)
                                 for v in pre_uninit)
        if not all_init():
            transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
            return no_init_msgs()
    if down_msg is not None:
        add_msg_factors(sub, down_msg)
        for vlbl, belief in down_msg.beliefs.items():
            if vlbl in sub.variables:
                sub.set_belief(vlbl, belief.points, solve_key=solve_key,
                               bw=belief.bw, ipc=belief.ipc)
                sub.var(vlbl).marginalized = True   # fixed in the down solve
    if not all_init():
        clique.status = CliqStatus.NO_INIT
        return no_init_msgs()

    iter_frontals = [v for v in clique.iter_vars if v in clique.frontals]
    direct_frontals = [v for v in clique.frontals if v not in iter_frontals]
    _solve_clique_vars(sub, direct_frontals, iter_frontals, solve_key)
    clique.status = CliqStatus.DOWNSOLVED
    transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
    return {ch.cid: prep_msg_down(sub, clique, ch, CliqStatus.DOWNSOLVED,
                                  solve_key)
            for ch in tree.children(clique.cid)}


def solve_tree_sweeps(fg: FactorGraph, tree: BayesTree,
                      solve_key: str = "default", up: bool = True,
                      down: bool = True) -> None:
    """Up sweep (deepest level first), then down sweeps with the tree-init
    fixed point.  A clique whose solve raises is marked ERROR_STATUS, its
    error message floods the rest of the schedule, and the first error
    re-raises after the sweeps."""
    if fg.params.use_msg_likelihoods:
        raise NotImplementedError(
            "use_msg_likelihoods (joint up messages) is not ported yet")
    levels = tree.levels()
    up_msgs: Dict[int, LikelihoodMessage] = {}
    errors: List[Tuple[int, Exception]] = []

    def run_up(only: Optional[set] = None) -> None:
        for level in reversed(levels):
            for cid in level:
                if only is not None and cid not in only:
                    continue
                cl = tree.clique(cid)
                if only is not None and cl.status == CliqStatus.ERROR_STATUS:
                    continue
                child_msgs = [up_msgs[ch] for ch in cl.children
                              if ch in up_msgs]
                try:
                    up_msgs[cid] = up_solve_clique(fg, tree, cl, child_msgs,
                                                   solve_key)
                except Exception as e:          # noqa: BLE001
                    cl.status = CliqStatus.ERROR_STATUS
                    errors.append((cid, e))
                    up_msgs[cid] = LikelihoodMessage(
                        sender=cid, status=CliqStatus.ERROR_STATUS,
                        direction="up")

    def run_down() -> set:
        down_msgs: Dict[int, LikelihoodMessage] = {}
        down_inited: set = set()
        for level in levels:
            for cid in level:
                cl = tree.clique(cid)
                if cl.status == CliqStatus.ERROR_STATUS:
                    continue
                child_up = [up_msgs[ch] for ch in cl.children
                            if ch in up_msgs]
                try:
                    down_msgs.update(down_solve_clique(
                        fg, tree, cl, down_msgs.get(cid), solve_key,
                        child_msgs=child_up))
                    if cl.down_inited:
                        down_inited.add(cid)
                except Exception as e:          # noqa: BLE001
                    cl.status = CliqStatus.ERROR_STATUS
                    errors.append((cid, e))
        tree.down_msgs = down_msgs
        return down_inited

    if up:
        run_up()
    if down and not up:
        # down-only solve: every clique must carry a previous solution
        for cl in tree.cliques.values():
            if cl.status in (CliqStatus.NULL, CliqStatus.NO_INIT,
                             CliqStatus.INITIALIZED):
                if all(fg.var(v).get_solved_count(solve_key) > 0
                       for v in cl.all_vars):
                    cl.status = CliqStatus.UPRECYCLED
                else:
                    raise RuntimeError(
                        f"down-only solve: clique {cl.cid} variables were "
                        "never solved (set upsolve=True)")
    if down:
        limit = max(1, int(fg.params.limit_treeinit_iters))
        for _ in range(limit):
            down_inited = run_down()
            if not down_inited or not up or errors:
                break
            affected: set = set()
            for cid in down_inited:
                cur: Optional[int] = cid
                while cur is not None and cur not in affected:
                    affected.add(cur)
                    cur = tree.clique(cur).parent
            run_up(affected)
        still = [c.cid for c in tree.cliques.values()
                 if c.status == CliqStatus.NO_INIT]
        if still:
            logger.warning("tree init incomplete; cliques %s remain NO_INIT "
                           "(graph lacks initializing information)", still)

    tree.up_msgs = up_msgs
    if errors:
        raise RuntimeError(
            f"clique solves failed for {[c for c, _ in errors]}: "
            f"{errors[0][1]}") from errors[0][1]

"""Level-ordered Bayes-tree sweeps.

Counterpart of ``incrementalinference/jl_tpu/parallel/scheduler.py`` (reference clique
state machine, CliqueStateMachine.jl): an up sweep from the leaves to the
root, then a down sweep, each clique solved on a subgraph of its variables,
potentials and message factors.  Cliques the up sweep cannot initialize are
initialized from their parent's down message; the up sweep then re-runs
over them and their ancestors and the down sweep repeats, at most
``SolverParams.limit_treeinit_iters`` times.

Incremental solves: a clique recycled from the previous tree
(tree/bayestree.py ``build_tree_reset``) re-emits its up message from the
graph's beliefs instead of solving, and the wildfire gate
(``SolverParams.wildfire_tol``) lets a recycled clique skip its down-solve
when its incoming down message has not moved.  ``record_cliques`` keeps a
:class:`CliqueTrace` per clique, with the inputs that replay its up-solve
(``debugging.replay_clique_up``).  Fault injection (the reference's
solveTree! skipcliqids/delaycliqs and its timeout): skipped cliques are
left untouched, delayed ones sleep before their up-solve, and an expired
deadline marks every clique not yet solved ERROR_STATUS.

Batched levels (``SolverParams.batch_cliques``: True, "auto" for levels at
least ``batch_min_width`` wide, False): a level's up-solves run in lock
step (:func:`up_solve_level`).  Isomorphic cliques (equal
:func:`_clique_class_signature`) keep their particles stacked along a
member axis and every update of their schedule is one batched update
(ops/fused.py ``_make_update_batched``).  ``batch_cliques`` decides
whether a level batches; the attribute ``batch_stacked = False`` (no
field of SolverParams, kept only because the JAX package reads it) only
picks :func:`_lockstep_gibbs`, which groups equal update plans position
by position instead.  Chain segments
(``fuse_sweep=True``): runs of single-child cliques up-solve through one
call (:func:`up_solve_segment`).  The down sweep stays per clique.
Distribution over a :class:`~.mesh.Mesh`: a batched class splits its
members over the mesh's devices (the clique axis), a clique outside a
batch splits its per-particle solves (the particle axis,
``shard_particles``), and ``devices=`` places same-level cliques round
robin.  Batching and segments are taken only without fault injection and
without round-robin placement, as in the JAX package.
"""

from __future__ import annotations

import copy
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import keys as _keys
from ..beliefs import Belief, LazyPPE
from ..graph import FactorGraph, Variable
from ..graphinit import doautoinit
from ..ops.graphops import (UpdatePlan, canonical_factors, conv_entry,
                            ipc_of, local_product_and_update,
                            model_structure, prepare_update)
from ..fgos import find_factors_between_from
from ..tree.accessors import get_cliq_vars_with_frontal_neighbors
from ..tree.bayestree import BayesTree, Clique, CliqStatus
from .messages import (MSG_TAG, LikelihoodMessage, add_msg_factors,
                       prep_msg_down, prep_msg_up)

__all__ = ["build_clique_subgraph", "transfer_update_subgraph",
           "add_down_variable_factors", "up_solve_clique",
           "down_solve_clique", "solve_tree_sweeps", "up_solve_level",
           "up_solve_segment", "cliq_var_init_order_up", "CliqueTrace"]

logger = logging.getLogger(__name__)


@dataclass
class CliqueTrace:
    """Per-clique record of the steps a solve took (the reference's CSM
    history): ``events`` are (time, step, detail).  With
    ``record_cliques`` the sweep also keeps the up-solve's child messages,
    the incoming down message and the clique subgraph (its tensors shared,
    not copied), for replay (reference repeatCSMStep!,
    getCliqSubgraphFromHistory)."""

    cid: int
    events: List[Tuple[float, str, str]] = field(default_factory=list)
    child_msgs: Optional[List[LikelihoodMessage]] = None
    down_msg: Optional[LikelihoodMessage] = None
    subfg: Optional[FactorGraph] = None

    def log(self, step: str, detail: str = "") -> None:
        self.events.append((time.time(), step, detail))


def _belief_on(b: Belief, device) -> Belief:
    return b if b.points.device == device else Belief(
        *(t.to(device) for t in b))


def _msg_on(msg: LikelihoodMessage, device) -> LikelihoodMessage:
    """The message with its beliefs on ``device`` (itself when they are
    there already)."""
    if all(b.points.device == device for b in msg.beliefs.values()) \
            and msg.jointmsg is None:
        return msg
    out = copy.copy(msg)
    out.beliefs = {v: _belief_on(b, device) for v, b in msg.beliefs.items()}
    if msg.jointmsg is not None:
        out.jointmsg = copy.copy(msg.jointmsg)
        out.jointmsg.relatives = [(a, c, _belief_on(b, device))
                                  for a, c, b in msg.jointmsg.relatives]
        out.jointmsg.priors = {v: _belief_on(b, device)
                               for v, b in msg.jointmsg.priors.items()}
    return out


def _copy_variable(v: Variable, device=None) -> Variable:
    """A subgraph's view of a variable: its own dicts, shared tensors (or
    copies on ``device``)."""
    beliefs = dict(v.beliefs)
    if device is not None:
        beliefs = {k: _belief_on(b, device) for k, b in beliefs.items()}
    return Variable(label=v.label, vartype=v.vartype, N=v.N,
                    tags=set(v.tags), solvable=v.solvable,
                    timestamp=v.timestamp, data=v.data,
                    beliefs=beliefs, initialized=dict(v.initialized),
                    ppe=dict(v.ppe), parametric_point=v.parametric_point,
                    parametric_cov=v.parametric_cov,
                    marginalized=v.marginalized)


def build_clique_subgraph(fg: FactorGraph, clique: Clique,
                          device=None) -> FactorGraph:
    """Frontal + separator variables and the clique's potentials as a local
    subgraph (reference buildCliqSubgraph!), with its own key stream.
    ``device`` places the subgraph and copies of its beliefs there, so
    that its solve runs on that device (the round-robin placement of
    same-level cliques)."""
    device = fg.device if device is None else torch.device(device)
    sub = FactorGraph(fg.params, device=device)
    sub.reseed(fg.next_key())
    for vl in clique.all_vars:
        sub.variables[vl] = _copy_variable(
            fg.var(vl), None if device == fg.device else device)
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
        b = fg.set_belief(vl, b.points, solve_key=solve_key, bw=b.bw,
                          ipc=b.ipc, initialized=sv.is_initialized(solve_key))
        fg.var(vl).ppe[solve_key] = LazyPPE(sv.manifold, b)


def _msg_summary(msg: LikelihoodMessage) -> dict:
    """What the wildfire comparison needs of a down message, per variable:
    (shape, mean (d,), mean per-dim std as a 0-d tensor).

    The JAX package keeps references to the particle arrays, which are
    immutable there.  A tensor can be written in place after the solve, so
    the summary holds the statistics themselves: small tensors made on the
    message's device with no read back to the host."""
    out = {}
    for vlbl, b in msg.beliefs.items():
        sd, mean = torch.std_mean(b.points, dim=0, correction=0)
        out[vlbl] = (tuple(b.points.shape), mean, sd.mean())
    return out


def _wildfire_stat(new: dict, old: dict) -> torch.Tensor:
    """Max over the variables of |mean_new - mean_old| / max(spread_new,
    spread_old, 1e-9): the gate statistic of a whole clique as one 0-d
    tensor (the JAX package's ``_wildfire_stat_many``)."""
    stats = []
    for vlbl, (_, mn, sn) in new.items():
        _, mo, so = old[vlbl]
        stats.append(torch.linalg.norm(mn - mo)
                     / torch.clamp(torch.maximum(sn, so), min=1e-9))
    return torch.stack(stats).max()


#: ``wildfire_tol="auto"`` turns the gate on, at this tolerance, once a tree
#: has this many recycled cliques.  Both are the JAX package's values, kept
#: so that the port takes the same branches; where the gate starts to pay
#: on an H100 has not been measured.
WILDFIRE_AUTO_MIN_RECYCLED = 64
WILDFIRE_AUTO_TOL = 0.8


def _wildfire_unchanged(new: dict, old: Optional[dict], tol: float) -> bool:
    """True when every separator mean moved at most ``tol`` spreads: the
    incoming down message carries nothing worth re-solving for (the iSAM2
    wildfire threshold).  One device-to-host read."""
    if old is None or set(new) != set(old):
        return False
    if any(new[v][0] != old[v][0] for v in new):
        return False
    if not new:
        return True
    return _wildfire_stat(new, old).item() <= tol


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
    the per-variable path: mixed particle counts).  The plan's
    ``labels_*`` name each step's factors, in the order of its models."""
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
            "models_iter": [], "labels_direct": [], "labels_iter": [],
            "touched": {}}
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
        plan["labels_" + which].append(tuple(f.label for f in factors))
        plan["touched"][local[var]] = tuple(masks)
    if not plan["direct"] and not plan["iter"]:
        return True, None, live
    return plan, store, live


def _gibbs_solve_chain(sub: FactorGraph, direct: List[str],
                       iter_vars: List[str], solve_key: str = "default",
                       mesh=None) -> bool:
    """The clique's Gibbs schedule on a local store (ops/fused.py
    fused_clique_gibbs): direct variables once, iterated variables
    ``gibbs_iters`` rounds; beliefs are written back at the end.  Returns
    False when the clique needs the per-variable path.  ``mesh`` splits
    the per-particle solves over its devices (the particle axis)."""
    from ..ops.fused import fused_clique_gibbs

    plan, store, live = _build_chain_plan(sub, direct, iter_vars, solve_key)
    if plan is True or plan is False:
        return plan
    new_store, dbws, ibws = fused_clique_gibbs(
        plan["direct"], plan["iter"], sub.params.gibbs_iters,
        plan["models_direct"], plan["models_iter"], store, sub.next_key(),
        mesh=mesh)
    bw_of = {step[0]: bw for step, bw in zip(plan["direct"], dbws)}
    bw_of.update({step[0]: bw for step, bw in zip(plan["iter"], ibws)})
    for li, masks in plan["touched"].items():
        sub.set_belief(live[li], new_store[li], solve_key=solve_key,
                       bw=bw_of[li], ipc=ipc_of(masks, sub.device))
    return True


def _solve_clique_vars(sub: FactorGraph, direct: List[str],
                       iter_vars: List[str], solve_key: str,
                       mesh=None) -> None:
    if _use_chain(sub.params) and _gibbs_solve_chain(sub, direct, iter_vars,
                                                     solve_key, mesh=mesh):
        return
    _gibbs_solve(sub, direct, 1, solve_key)
    if iter_vars:
        _gibbs_solve(sub, iter_vars, sub.params.gibbs_iters, solve_key)


def up_solve_clique(fg: FactorGraph, tree: BayesTree, clique: Clique,
                    child_msgs: List[LikelihoodMessage],
                    solve_key: str = "default",
                    trace: Optional[CliqueTrace] = None,
                    device=None, mesh=None) -> LikelihoodMessage:
    """One clique up-solve (reference CSM preUpSolve_ → solveUp_ →
    postUpSolve_, Gibbs body of upGibbsCliqueDensity).  ``device`` solves
    the clique there (its message comes back on the graph's device);
    ``mesh`` splits its per-particle solves over the mesh's devices."""
    device = fg.device if device is None else torch.device(device)
    child_msgs = [_msg_on(m, device) for m in child_msgs]
    return _msg_on(_up_solve(fg, clique, child_msgs, solve_key,
                             trace or CliqueTrace(clique.cid), device, mesh),
                   fg.device)


def _up_solve(fg: FactorGraph, clique: Clique,
              child_msgs: List[LikelihoodMessage], solve_key: str,
              t: CliqueTrace, device, mesh) -> LikelihoodMessage:
    """The body of :func:`up_solve_clique`, on ``device``."""
    if clique.is_marginalized or (clique.is_recycled and
                                  clique.status == CliqStatus.UPRECYCLED):
        # recycled or marginalized: the message is the graph's beliefs
        t.log("recycle", "skip up-solve")
        msg = LikelihoodMessage(sender=clique.cid, status=clique.status,
                                direction="up")
        for vlbl in clique.separator:
            msg.beliefs[vlbl] = fg.get_belief(vlbl, solve_key)
        return msg

    sub = build_clique_subgraph(fg, clique, device=device)
    if fg.params.record_cliques:
        t.subfg = sub
    t.log("build_subgraph", f"{len(sub.variables)} vars, "
                            f"{len(sub.factors)} factors")
    for msg in child_msgs:
        if msg.status == CliqStatus.ERROR_STATUS:
            clique.status = CliqStatus.ERROR_STATUS
            raise RuntimeError(
                f"clique {clique.cid}: child {msg.sender} errored")
        add_msg_factors(sub, msg)
    t.log("add_msg_factors", f"{len(child_msgs)} child messages")

    if not _cycle_init_by_var_order(sub, clique, solve_key):
        # parents may still initialize it downward
        t.log("no_init")
        clique.status = CliqStatus.NO_INIT
        msg = prep_msg_up(sub, clique, CliqStatus.NO_INIT, solve_key)
        transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
        return msg

    _solve_clique_vars(sub, list(clique.direct_vars), clique.iter_vars,
                       solve_key, mesh=mesh)
    t.log("up_gibbs", f"direct={len(clique.direct_vars)} "
                      f"iter={len(clique.iter_vars)}")
    clique.status = CliqStatus.UPSOLVED
    msg = prep_msg_up(sub, clique, CliqStatus.UPSOLVED, solve_key)
    transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
    t.log("up_done")
    return msg


def down_solve_clique(fg: FactorGraph, tree: BayesTree, clique: Clique,
                      down_msg: Optional[LikelihoodMessage],
                      solve_key: str = "default",
                      child_msgs: Optional[List[LikelihoodMessage]] = None,
                      trace: Optional[CliqueTrace] = None, mesh=None
                      ) -> Dict[int, LikelihoodMessage]:
    """One clique down-solve (reference CSM down states; frontal products
    of solveCliqDownFrontalProducts!).  The children's up messages stay
    attached, as in the reference's down phase.  Returns the down messages
    for each child.  ``mesh`` as in :func:`up_solve_clique`."""
    t = trace or CliqueTrace(clique.cid)
    sub = build_clique_subgraph(fg, clique)
    if clique.is_marginalized:
        t.log("marginalized", "skip down-solve")
        return {ch.cid: prep_msg_down(sub, clique, ch, clique.status,
                                      solve_key)
                for ch in tree.children(clique.cid)}
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
        newly = [v for v in pre_uninit
                 if sub.var(v).is_initialized(solve_key)]
        clique.down_inited = bool(newly)
        t.log("down_init", f"{len(newly)}/{len(pre_uninit)} vars")
        if not all_init():
            transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
            t.log("down_no_init")
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
        t.log("down_no_init")
        return no_init_msgs()
    t.log("down_start")

    iter_frontals = [v for v in clique.iter_vars if v in clique.frontals]
    direct_frontals = [v for v in clique.frontals if v not in iter_frontals]
    _solve_clique_vars(sub, direct_frontals, iter_frontals, solve_key,
                       mesh=mesh)
    t.log("down_gibbs", f"direct={len(direct_frontals)} "
                        f"iter={len(iter_frontals)}")
    clique.status = CliqStatus.DOWNSOLVED
    transfer_update_subgraph(fg, sub, clique.frontals, solve_key)
    out = {ch.cid: prep_msg_down(sub, clique, ch, CliqStatus.DOWNSOLVED,
                                 solve_key)
           for ch in tree.children(clique.cid)}
    t.log("down_done")
    return out


def _particle_mesh(params, mesh):
    """The mesh a clique outside a batched level splits its per-particle
    solves over: ``mesh`` unless ``shard_particles`` turns the particle
    axis off."""
    if mesh is None:
        return None
    sp = getattr(params, "shard_particles", "auto")
    return mesh if sp in (True, "auto") else None


def _use_sweep(params) -> bool:
    """``fuse_sweep``: True fuses chain segments; "auto" resolves to off,
    as in the JAX package (there the merged program compiled and ran
    slower than the per-clique chains)."""
    fs = getattr(params, "fuse_sweep", "auto")
    return fs is True


def _segment_eligible(fg: FactorGraph, cl: Clique, solve_key: str) -> bool:
    """A clique can join a chain segment when its up-solve needs no
    host-side control flow: fully initialized, neither recycled nor
    marginalized."""
    if cl.is_marginalized or (cl.is_recycled
                              and cl.status == CliqStatus.UPRECYCLED):
        return False
    return all(fg.var(v).is_initialized(solve_key) for v in cl.all_vars)


def _find_up_segments(fg: FactorGraph, tree: BayesTree, skip_set,
                      delay_cliques, dev_of, solve_key: str,
                      excluded: Optional[set] = None
                      ) -> Dict[int, List[Clique]]:
    """Maximal chains (at least two long) of single-child eligible cliques,
    keyed by the bottom clique's id."""
    if fg.params.use_msg_likelihoods:
        return {}
    excluded = excluded or set()
    in_chain: Dict[int, int] = {}
    segments: Dict[int, List[Clique]] = {}

    def blocked(cid):
        return (cid in skip_set or cid in delay_cliques or cid in dev_of
                or cid in excluded)

    for cid0 in [cid for level in reversed(tree.levels()) for cid in level]:
        cl = tree.clique(cid0)
        if cl.cid in in_chain or blocked(cl.cid) or \
                not _segment_eligible(fg, cl, solve_key):
            continue
        chain = [cl]
        cur = cl
        while cur.parent is not None:
            par = tree.clique(cur.parent)
            if par.children != [cur.cid] or blocked(par.cid) \
                    or par.cid in in_chain \
                    or not _segment_eligible(fg, par, solve_key):
                break
            chain.append(par)
            cur = par
        if len(chain) >= 2:
            for c in chain:
                in_chain[c.cid] = chain[0].cid
            segments[chain[0].cid] = chain
    return segments


def up_solve_segment(fg: FactorGraph, tree: BayesTree, chain: List[Clique],
                     bottom_msgs: List[LikelihoodMessage], solve_key: str,
                     trace_for) -> Optional[Dict[int, LikelihoodMessage]]:
    """Up-solve a chain of cliques bottom first through one call
    (ops/fused.py ``fused_up_segment``): each clique's up message reaches
    its parent inside that call, in place of a placeholder message built
    from the graph's current beliefs.  Returns the up messages of every
    clique (the down sweep still reads them), or None when a member needs
    the general path (the caller then solves clique by clique)."""
    from ..ops.fused import fused_up_segment

    seg_static, models_d_all, models_i_all = [], [], []
    stores, keys, metas = [], [], []
    prev_live: Optional[List[str]] = None
    prev_cl: Optional[Clique] = None
    for idx, cl in enumerate(chain):
        sub = build_clique_subgraph(fg, cl)
        msg_var: Dict[str, str] = {}
        if idx == 0:
            for m in bottom_msgs:
                if m.status == CliqStatus.ERROR_STATUS:
                    return None
                add_msg_factors(sub, m)
        else:
            pm = LikelihoodMessage(sender=prev_cl.cid,
                                   status=CliqStatus.UPSOLVED,
                                   direction="up")
            for vlbl in prev_cl.separator:
                if vlbl in fg.variables and \
                        solve_key in fg.var(vlbl).beliefs:
                    pm.beliefs[vlbl] = fg.get_belief(vlbl, solve_key)
            for fl in add_msg_factors(sub, pm):
                msg_var[fl] = fl.split(f"_{MSG_TAG}_")[0]
            if set(msg_var.values()) != set(prev_cl.separator):
                return None
        plan, store, live = _build_chain_plan(sub, cl.direct_vars,
                                              cl.iter_vars, solve_key)
        if plan is True or plan is False:
            return None
        msg_subs = []
        if idx > 0:
            child_local = {v: i for i, v in enumerate(prev_live)}
            for which, groups in ((0, plan["labels_direct"]),
                                  (1, plan["labels_iter"])):
                for si, fls in enumerate(groups):
                    for fi, fl in enumerate(fls):
                        vl = msg_var.get(fl)
                        if vl is not None:
                            msg_subs.append((which, si, fi, child_local[vl],
                                             sub.var(vl).manifold))
        seg_static.append((plan["direct"], plan["iter"], tuple(msg_subs)))
        models_d_all.append(plan["models_direct"])
        models_i_all.append(plan["models_iter"])
        stores.append(tuple(store))
        keys.append(fg.next_key())
        metas.append((cl, sub, live, plan))
        prev_live, prev_cl = live, cl

    outs = fused_up_segment(seg_static, fg.params.gibbs_iters, models_d_all,
                            models_i_all, stores, keys)
    up_out: Dict[int, LikelihoodMessage] = {}
    for (cl, sub, live, plan), (store, dbws, ibws) in zip(metas, outs):
        bw_of = {s[0]: bw for s, bw in zip(plan["direct"], dbws)}
        bw_of.update({s[0]: bw for s, bw in zip(plan["iter"], ibws)})
        for li, masks in plan["touched"].items():
            sub.set_belief(live[li], store[li], solve_key=solve_key,
                           bw=bw_of[li], ipc=ipc_of(masks, sub.device))
        cl.status = CliqStatus.UPSOLVED
        up_out[cl.cid] = prep_msg_up(sub, cl, CliqStatus.UPSOLVED, solve_key)
        transfer_update_subgraph(fg, sub, cl.frontals, solve_key)
        tr = trace_for(cl.cid)
        tr.log("up_gibbs", "fused-segment")
        tr.log("up_done")
    return up_out


def _lockstep_gibbs(fg: FactorGraph, subs: Dict[int, FactorGraph],
                    cliques: List[Clique], solve_key: str) -> None:
    """Lock-step Gibbs across a level's cliques: position p of every
    clique's update sequence runs in the same round, and the updates of
    equal structure run as one batched update (ops/fused.py
    ``fused_variable_update_batched``).  Within a clique the update order
    is that of the per-variable path.  Taken only under the attribute
    ``batch_stacked = False``, which the JAX package reads and the port
    keeps for parity; :func:`_lockstep_gibbs_stacked` is the default."""
    from ..ops.fused import (fused_variable_update,
                             fused_variable_update_batched)

    params = fg.params
    sequences = {cl.cid: list(cl.direct_vars)
                 + list(cl.iter_vars) * params.gibbs_iters
                 for cl in cliques}
    max_len = max((len(q) for q in sequences.values()), default=0)
    for pos in range(max_len):
        groups: Dict = {}
        for cl in cliques:
            seq = sequences[cl.cid]
            if pos >= len(seq) or subs[cl.cid].var(seq[pos]).marginalized:
                continue
            sub, var = subs[cl.cid], seq[pos]
            plan = prepare_update(sub, var, sub.factors_of(var),
                                  solve_key=solve_key)
            if isinstance(plan, UpdatePlan):
                groups.setdefault(plan.structure_key, []).append(
                    (plan, cl.cid, var))
        for entries in groups.values():
            keys = [subs[cid].next_key() for _, cid, _ in entries]
            if len(entries) == 1:
                plan, cid, var = entries[0]
                pts, bw = fused_variable_update(
                    plan.manifold, plan.models, plan.nested,
                    plan.old_points, plan.specs, plan.masks, keys[0],
                    plan.n_out)
                subs[cid].set_belief(var, pts, solve_key=solve_key, bw=bw,
                                     ipc=plan.ipc())
                continue
            pts_b, bw_b = fused_variable_update_batched(
                [e[0] for e in entries], keys)
            for b, (plan, cid, var) in enumerate(entries):
                subs[cid].set_belief(var, pts_b[b], solve_key=solve_key,
                                     bw=bw_b[b], ipc=plan.ipc())


def up_solve_level(fg: FactorGraph, tree: BayesTree, cliques: List[Clique],
                   child_msgs_of: Dict[int, List[LikelihoodMessage]],
                   solve_key: str = "default",
                   traces: Optional[Dict[int, CliqueTrace]] = None,
                   mesh=None) -> Dict[int, LikelihoodMessage]:
    """Batched up-solve of one level: subgraphs, messages and init clique
    by clique, then lock-step batched Gibbs over the level, then the
    messages out.  ``mesh`` splits each stacked class's members over its
    devices (the clique axis)."""
    traces = traces or {}
    out: Dict[int, LikelihoodMessage] = {}
    active: List[Clique] = []
    subs: Dict[int, FactorGraph] = {}
    for cl in cliques:
        t = traces.get(cl.cid) or CliqueTrace(cl.cid)
        if cl.is_marginalized or (cl.is_recycled and
                                  cl.status == CliqStatus.UPRECYCLED):
            t.log("recycle", "skip up-solve")
            msg = LikelihoodMessage(sender=cl.cid, status=cl.status,
                                    direction="up")
            for vlbl in cl.separator:
                msg.beliefs[vlbl] = fg.get_belief(vlbl, solve_key)
            out[cl.cid] = msg
            continue
        sub = build_clique_subgraph(fg, cl)
        if fg.params.record_cliques:
            t.subfg = sub
        for msg in child_msgs_of.get(cl.cid, []):
            if msg.status == CliqStatus.ERROR_STATUS:
                cl.status = CliqStatus.ERROR_STATUS
                raise RuntimeError(
                    f"clique {cl.cid}: child {msg.sender} errored")
            add_msg_factors(sub, msg)
        if not _cycle_init_by_var_order(sub, cl, solve_key):
            t.log("no_init")
            cl.status = CliqStatus.NO_INIT
            out[cl.cid] = prep_msg_up(sub, cl, CliqStatus.NO_INIT, solve_key)
            transfer_update_subgraph(fg, sub, cl.frontals, solve_key)
            continue
        subs[cl.cid] = sub
        active.append(cl)

    if active:
        if getattr(fg.params, "batch_stacked", True):
            _lockstep_gibbs_stacked(fg, subs, active, solve_key, mesh=mesh)
        else:
            _lockstep_gibbs(fg, subs, active, solve_key)

    for cl in active:
        t = traces.get(cl.cid) or CliqueTrace(cl.cid)
        cl.status = CliqStatus.UPSOLVED
        out[cl.cid] = prep_msg_up(subs[cl.cid], cl, CliqStatus.UPSOLVED,
                                  solve_key)
        transfer_update_subgraph(fg, subs[cl.cid], cl.frontals, solve_key)
        t.log("up_done", "batched level solve")
    return out


def _canonical_factors(sub: FactorGraph, var: str):
    return canonical_factors(sub, var, sub.factors_of(var))


def _clique_class_signature(sub: FactorGraph, clique: Clique,
                            solve_key: str):
    """The structure of a clique's local solve: cliques with equal
    signatures run their whole Gibbs schedules stacked."""
    from ..ops.convolve import null_surplus_map

    local = {v: i for i, v in enumerate(clique.all_vars)}
    params = sub.params
    seq = list(clique.direct_vars) + list(clique.iter_vars) \
        * params.gibbs_iters
    sig = []
    for var in seq:
        fs = _canonical_factors(sub, var)
        nsrp = null_surplus_map(params, fs)
        fsig = tuple((model_structure(f.model),
                      tuple(local[v] for v in f.variables if v in local),
                      conv_entry(sub, f, var, nsrp[f.label])[0])
                     for f in fs)
        v = sub.var(var)
        sig.append((local[var], v.N, v.manifold, fsig))
    return tuple(sig)


def _member_factors(sub: FactorGraph, member: Clique, rep: Clique,
                    var: str, rep_factors) -> list:
    """The member's factors for the representative's update of ``var``,
    one to one with ``rep_factors`` (``_canonical_factors`` of the
    representative): the member's own canonical factors of the variable at
    the same local position.  Equal class signatures give equal structure
    position by position, so two factors of one kind on the same variables
    (the message priors of two children with a shared separator, two
    Priors) each keep a partner of their own.  The JAX package matches by
    the first factor of the right kind and positions instead, which maps
    both of such a pair onto one of them."""
    local_rep = {v: i for i, v in enumerate(rep.all_vars)}
    mine = _canonical_factors(sub, member.all_vars[local_rep[var]])
    if len(mine) != len(rep_factors):
        raise KeyError(f"clique {member.cid} has {len(mine)} factors on "
                       f"{member.all_vars[local_rep[var]]}, the class "
                       f"{len(rep_factors)}")
    local_mem = {v: i for i, v in enumerate(member.all_vars)}
    for f, g in zip(rep_factors, mine):
        want = (type(f.model).__name__,
                tuple(local_rep[v] for v in f.variables if v in local_rep),
                f.multihypo or (), f.nullhypo)
        got = (type(g.model).__name__,
               tuple(local_mem[v] for v in g.variables if v in local_mem),
               g.multihypo or (), g.nullhypo)
        if got != want:
            raise KeyError(f"no isomorphic factor for {f.label}: "
                           f"{g.label} is {got}, not {want}")
    return mine


def _model_on(model, device):
    """The model with a belief it carries (a message prior) on
    ``device``."""
    b = getattr(model, "belief", None)
    if not isinstance(b, Belief) or b.points.device == device:
        return model
    out = copy.copy(model)
    out.belief = _belief_on(b, device)
    return out


def _run_members(fn, models, nested, old, keys, mesh, home):
    """One batched update of every member; with a mesh, the members split
    into one contiguous chunk per device, each chunk one batched update
    there, gathered back onto ``home``."""
    if mesh is None:
        return fn(models, nested, old, keys)
    devices = list(mesh.devices)
    per = len(keys) // len(devices)
    pts, bws = [], []
    for c, dev in enumerate(devices):
        sl = slice(c * per, (c + 1) * per)
        p, b = fn(tuple(tuple(_model_on(m, dev) for m in ms[sl])
                        for ms in models),
                  tuple(tuple(t[sl].to(dev) for t in v) for v in nested),
                  old[sl].to(dev), keys[sl])
        pts.append(p.to(home))
        bws.append(b.to(home))
    return torch.cat(pts), torch.cat(bws)


def _lockstep_gibbs_stacked(fg: FactorGraph, subs: Dict[int, FactorGraph],
                            cliques: List[Clique], solve_key: str,
                            mesh=None) -> None:
    """Stacked lock-step Gibbs: the cliques of one isomorphism class keep
    their variables' particles in (B, N, pd) stacks for the whole schedule,
    and every update of it is one batched update of the class
    (ops/fused.py ``_make_update_batched``: one pass of per-particle
    solves, one kernel launch per large product stage).  A class of one
    clique takes the per-variable path.

    ``mesh``: a class of at least as many members as the mesh has devices
    is padded with copies of its last member to a multiple of that number
    and split over the devices, a contiguous chunk each (the JAX package
    shards the member axis); the copies' results are dropped."""
    from ..ops.convolve import null_surplus_map
    from ..ops.fused import _make_update_batched

    classes: Dict = {}
    for cl in cliques:
        sig = _clique_class_signature(subs[cl.cid], cl, solve_key)
        classes.setdefault(sig, []).append(cl)

    for members in classes.values():
        if len(members) == 1:
            cl = members[0]
            sub = subs[cl.cid]
            _gibbs_solve(sub, list(cl.direct_vars), 1, solve_key)
            if cl.iter_vars:
                _gibbs_solve(sub, cl.iter_vars, sub.params.gibbs_iters,
                             solve_key)
            continue
        B = len(members)
        stackees = list(members)
        class_mesh = None
        if mesh is not None and B >= len(mesh.devices):
            per = len(mesh.devices)
            stackees += [members[-1]] * (-(-B // per) * per - B)
            class_mesh = mesh
        rep = members[0]
        rep_sub = subs[rep.cid]
        params = rep_sub.params
        local = {v: i for i, v in enumerate(rep.all_vars)}
        store = {i: torch.stack([subs[m.cid].points(m.all_vars[i], solve_key)
                                 for m in stackees])
                 for i in range(len(rep.all_vars))}
        bw_out: Dict[int, torch.Tensor] = {}
        ipc_out: Dict[int, torch.Tensor] = {}
        seq = list(rep.direct_vars) + list(rep.iter_vars) * params.gibbs_iters
        for var in seq:
            li = local[var]
            fs = _canonical_factors(rep_sub, var)
            if not fs:
                continue
            manifold = rep_sub.var(var).manifold
            nsrp = null_surplus_map(params, fs)
            theirs = [_member_factors(subs[m.cid], m, rep, var, fs)
                      for m in stackees]
            specs, masks, models, nested = [], [], [], []
            for k, f in enumerate(fs):
                spec, mask = conv_entry(rep_sub, f, var, nsrp[f.label])
                specs.append(spec)
                masks.append(mask)
                models.append(tuple(mf[k].model for mf in theirs))
                nested.append(tuple(store[local[v]] for v in f.variables))
            fn = _make_update_batched(manifold, tuple(specs), tuple(masks),
                                      rep_sub.var(var).N)
            keys = _keys.split(fg.next_key(), len(stackees))
            pts, bw = _run_members(fn, tuple(models), tuple(nested),
                                   store[li], keys, class_mesh,
                                   store[li].device)
            store[li] = pts
            bw_out[li] = bw
            ipc_out[li] = ipc_of(tuple(masks), pts.device)
        for b, m in enumerate(members):
            sub = subs[m.cid]
            for i in bw_out:
                sub.set_belief(m.all_vars[i], store[i][b],
                               solve_key=solve_key, bw=bw_out[i][b],
                               ipc=ipc_out[i])


def _resolve_wildfire_tol(params, tree: BayesTree) -> Tuple[float, bool]:
    """(tolerance of this solve's gate, whether to record down-message
    summaries).  0.0 is off: recycled cliques re-run their down pass, as in
    the reference.  "auto" turns the gate on once the tree has
    ``WILDFIRE_AUTO_MIN_RECYCLED`` recycled cliques, and records summaries
    on every solve so that the first gated solve has a baseline."""
    wtol = params.wildfire_tol
    if isinstance(wtol, str):
        if wtol != "auto":
            raise ValueError(
                f"SolverParams.wildfire_tol={wtol!r}: expected a float "
                "tolerance, 0.0 (off, reference semantics) or \"auto\"")
        n_recycled = sum(1 for c in tree.cliques.values()
                         if c.is_recycled
                         and c.status == CliqStatus.UPRECYCLED)
        return (WILDFIRE_AUTO_TOL
                if n_recycled >= WILDFIRE_AUTO_MIN_RECYCLED else 0.0), True
    return float(wtol), wtol > 0.0


def solve_tree_sweeps(fg: FactorGraph, tree: BayesTree,
                      solve_key: str = "default", up: bool = True,
                      down: bool = True, skip_cliques: Sequence[int] = (),
                      delay_cliques: Optional[Dict[int, float]] = None,
                      timeout: Optional[float] = None,
                      devices: Optional[Sequence] = None, mesh=None
                      ) -> Dict[int, CliqueTrace]:
    """Up sweep (deepest level first), then down sweeps with the tree-init
    fixed point.  A clique whose solve raises is marked ERROR_STATUS, its
    error message floods the rest of the schedule, and the first error
    re-raises after the sweeps.  Returns the per-clique traces (empty
    unless ``params.record_cliques``).

    Levels that ``batch_cliques`` selects up-solve as one batch
    (:func:`up_solve_level`), and with ``fuse_sweep=True`` chains of
    single-child cliques as one segment (:func:`up_solve_segment`; a
    segment that raises fails its bottom clique, as a clique's solve
    does).  ``mesh`` splits batched classes over its devices, and the
    per-particle solves of every other clique (``shard_particles``);
    ``devices`` places the cliques of each level round robin.

    Fault injection (reference solveTree! skipcliqids, delaycliqs and
    timeout): ``skip_cliques`` are logged and left untouched;
    ``delay_cliques`` maps a clique to seconds slept before its up-solve;
    ``timeout`` is a wall-clock budget in seconds, checked between clique
    solves: once it has expired, each clique reached is marked
    ERROR_STATUS, as a failed one is.  Batched levels and segments are
    taken only without skipped or delayed cliques and without
    ``devices``."""
    traces: Dict[int, CliqueTrace] = {}
    levels = tree.levels()
    up_msgs: Dict[int, LikelihoodMessage] = {}
    errors: List[Tuple[int, Exception]] = []
    skip_set = set(skip_cliques)
    delay_cliques = delay_cliques or {}
    deadline = time.time() + timeout if timeout else None
    params = fg.params
    record = params.record_cliques
    dev_of = {}
    if devices:
        for level in levels:
            for i, cid in enumerate(level):
                dev_of[cid] = devices[i % len(devices)]
    bc = getattr(params, "batch_cliques", False)
    min_width = getattr(params, "batch_min_width", 8)
    batching = bool(bc) and not skip_set and not delay_cliques and not dev_of

    def batch_level(level) -> bool:
        return batching and (bc is True
                             or (bc == "auto" and len(level) >= min_width))

    def timed_out(cl: Clique) -> bool:
        if deadline is None or time.time() <= deadline:
            return False
        cl.status = CliqStatus.ERROR_STATUS
        errors.append((cl.cid, TimeoutError(
            f"solve timeout ({timeout}s) before clique {cl.cid}")))
        return True

    def trace_for(cid: int) -> CliqueTrace:
        if record:
            return traces.setdefault(cid, CliqueTrace(cid))
        return CliqueTrace(cid)

    def failed(cl: Clique, tr: CliqueTrace, e: Exception) -> None:
        cl.status = CliqStatus.ERROR_STATUS
        tr.log("error", str(e))
        errors.append((cl.cid, e))

    def error_msg(cid: int) -> LikelihoodMessage:
        return LikelihoodMessage(sender=cid, status=CliqStatus.ERROR_STATUS,
                                 direction="up")

    def solve_level(level) -> None:
        cls = [tree.clique(cid) for cid in level]
        if timed_out(cls[0]):
            for cl in cls:
                cl.status = CliqStatus.ERROR_STATUS
                up_msgs[cl.cid] = error_msg(cl.cid)
            return
        child_msgs_of = {cl.cid: [up_msgs[ch] for ch in cl.children
                                  if ch in up_msgs] for cl in cls}
        if record:
            for cl in cls:
                trace_for(cl.cid).child_msgs = child_msgs_of[cl.cid]
        try:
            up_msgs.update(up_solve_level(fg, tree, cls, child_msgs_of,
                                          solve_key, traces=traces,
                                          mesh=mesh))
        except Exception as e:                  # noqa: BLE001
            for cl in cls:
                if cl.status != CliqStatus.UPSOLVED:
                    failed(cl, trace_for(cl.cid), e)
                    up_msgs[cl.cid] = error_msg(cl.cid)

    def run_up(only: Optional[set] = None) -> None:
        segments: Dict[int, List[Clique]] = {}
        if only is None and _use_sweep(params):
            segments = _find_up_segments(
                fg, tree, skip_set, delay_cliques, dev_of, solve_key,
                excluded={cid for level in levels if batch_level(level)
                          for cid in level})
        seg_handled: set = set()
        for level in reversed(levels):
            if only is None and batch_level(level):
                solve_level(level)
                continue
            for cid in level:
                if cid in seg_handled:
                    continue
                if only is not None and (cid not in only
                                         or cid in skip_set):
                    continue
                cl = tree.clique(cid)
                if only is not None and cl.status == CliqStatus.ERROR_STATUS:
                    continue
                if timed_out(cl):
                    if only is None:
                        up_msgs[cid] = error_msg(cid)
                    continue
                child_msgs = [up_msgs[ch] for ch in cl.children
                              if ch in up_msgs]
                tr = trace_for(cid)
                if only is not None:
                    tr.log("re_up", "tree-init fixed point")
                else:
                    if record:
                        tr.child_msgs = list(child_msgs)
                    if cid in segments:
                        try:
                            out = up_solve_segment(fg, tree, segments[cid],
                                                   child_msgs, solve_key,
                                                   trace_for)
                        except Exception as e:  # noqa: BLE001
                            failed(cl, tr, e)
                            up_msgs[cid] = error_msg(cid)
                            continue
                        if out is not None:
                            up_msgs.update(out)
                            seg_handled.update(c.cid for c in segments[cid])
                            continue
                    if cid in skip_set:
                        tr.log("skip", "skip_cliques fault injection")
                        up_msgs[cid] = LikelihoodMessage(
                            sender=cid, status=cl.status, direction="up")
                        continue
                    if cid in delay_cliques:
                        time.sleep(delay_cliques[cid])
                try:
                    up_msgs[cid] = up_solve_clique(
                        fg, tree, cl, child_msgs, solve_key, trace=tr,
                        device=dev_of.get(cid) if only is None else None,
                        mesh=(_particle_mesh(params, mesh) if only is None
                              else None))
                except Exception as e:          # noqa: BLE001
                    failed(cl, tr, e)
                    up_msgs[cid] = error_msg(cid)

    def run_down() -> set:
        down_msgs: Dict[int, LikelihoodMessage] = {}
        down_inited: set = set()
        # cliques whose down pass left their beliefs as they were: a
        # recycled child of one sees the down message of the last solve
        down_unchanged: set = set()
        wtol, record_summaries = _resolve_wildfire_tol(fg.params, tree)
        # consults of the statistic (one device-to-host read each), the
        # skips they gave, the skips the exact parent-unchanged rule gave,
        # and the down-solves that ran
        wf = tree.wildfire_stats = {"exact_skips": 0, "stat_syncs": 0,
                                    "wildfire_skips": 0, "down_solves": 0}
        for level in levels:
            for cid in level:
                cl = tree.clique(cid)
                tr = trace_for(cid)
                if record:
                    tr.down_msg = down_msgs.get(cid)
                if cid in skip_set or cl.status == CliqStatus.ERROR_STATUS \
                        or timed_out(cl):
                    continue
                incoming = down_msgs.get(cid)
                summary = (_msg_summary(incoming)
                           if record_summaries and incoming is not None
                           else None)
                sig = cl.signature()
                skip = False
                if (wtol > 0.0 and cl.is_recycled
                        and cl.status == CliqStatus.UPRECYCLED):
                    if cl.parent is None or cl.parent in down_unchanged:
                        # exact: the parent's beliefs did not change
                        tr.log("recycle", "skip down-solve")
                        skip = True
                        wf["exact_skips"] += 1
                    elif summary is not None:
                        wf["stat_syncs"] += 1
                        if _wildfire_unchanged(
                                summary, tree.down_cache.get(sig), wtol):
                            tr.log("recycle", "wildfire skip down-solve")
                            skip = True
                            wf["wildfire_skips"] += 1
                if summary is not None:
                    tree.down_cache[sig] = summary
                if skip:
                    cl.status = CliqStatus.DOWNSOLVED
                    for ch in tree.children(cid):
                        down_msgs[ch.cid] = prep_msg_down(
                            fg, cl, ch, CliqStatus.DOWNSOLVED, solve_key)
                    down_unchanged.add(cid)
                    continue
                if cl.is_marginalized:
                    down_unchanged.add(cid)
                child_up = [up_msgs[ch] for ch in cl.children
                            if ch in up_msgs]
                try:
                    wf["down_solves"] += 1
                    down_msgs.update(down_solve_clique(
                        fg, tree, cl, incoming, solve_key,
                        child_msgs=child_up, trace=tr,
                        mesh=_particle_mesh(params, mesh)))
                    if cl.down_inited:
                        down_inited.add(cid)
                except Exception as e:          # noqa: BLE001
                    failed(cl, tr, e)
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
    return traces

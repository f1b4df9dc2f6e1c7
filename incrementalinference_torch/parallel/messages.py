"""Inter-clique belief messages.

Counterpart of ``incrementalinference/jl_tpu/parallel/messages.py``
(reference LikelihoodMessage, addMsgFactors!, prepCliqueMsgUp): a message
carries separator beliefs and enters a clique subgraph as one MsgPrior per
belief.  With ``SolverParams.use_msg_likelihoods`` a solved up message also
carries a joint payload (:class:`JointMsg`): relative likelihoods between
separator pairs, taken from the solved clique, and anchoring priors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import tracing
from ..beliefs import Belief, make_belief
from ..manifolds import Euclidean
from ..models.factors import MsgPrior, MsgRelativeLikelihood
from ..tree.bayestree import CliqStatus

__all__ = ["LikelihoodMessage", "JointMsg", "add_msg_factors",
           "delete_msg_factors", "prep_msg_up", "prep_msg_down", "generate_msg_joint", "MSG_TAG"]

MSG_TAG = "__LIKELIHOODMESSAGE__"


@dataclass
class JointMsg:
    """Joint up-message payload (reference _MsgJointLikelihood):
    deconv-derived relative likelihoods between separator pairs plus one
    anchoring prior per disconnected class of separators."""

    # [(var_a, var_b, Belief over the tangent difference)]
    relatives: list = field(default_factory=list)
    # {var: Belief}: the class-anchor priors
    priors: Dict[str, Belief] = field(default_factory=dict)


@dataclass
class LikelihoodMessage:
    """Belief message over separator variables."""

    sender: int
    status: CliqStatus
    beliefs: Dict[str, Belief] = field(default_factory=dict)
    direction: str = "up"
    # joint differential payload (reference LikelihoodMessage.jointmsg)
    jointmsg: Optional[JointMsg] = None
    # whether the sending clique carried any prior potential (reference
    # LikelihoodMessage.hasPriors; gates where the joint priors go)
    has_priors: bool = False


@tracing.spanned("message")
def add_msg_factors(subfg, msg: LikelihoodMessage) -> List[str]:
    """Insert a message into a clique subgraph as factors (reference
    addMsgFactors!).

    Default path: one MsgPrior per separator belief.  Joint path (an up
    message with a joint payload under ``use_msg_likelihoods``): the
    relative likelihoods, plus the class-anchor priors, the latter only
    when the sender saw priors or the variable would otherwise have no
    factor (reference addLikelihoodPriorCommon!)."""
    added = []
    use_joint = (subfg.params.use_msg_likelihoods and msg.direction == "up"
                 and msg.jointmsg is not None and msg.beliefs)
    if use_joint:
        jm = msg.jointmsg
        for va, vb, diff_belief in jm.relatives:
            if va not in subfg.variables or vb not in subfg.variables:
                continue
            manifold = subfg.var(va).manifold
            f = subfg.add_factor(
                [va, vb], MsgRelativeLikelihood(diff_belief, manifold),
                label=f"{va}{vb}_{MSG_TAG}J_{msg.sender}_{msg.direction}",
                graphinit=False, tags=(MSG_TAG, "__UPWARD_DIFFERENTIAL__"))
            added.append(f.label)
        for vlbl, belief in jm.priors.items():
            if vlbl not in subfg.variables:
                continue
            if not (msg.has_priors or len(subfg.factors_of(vlbl)) == 0):
                continue
            manifold = subfg.var(vlbl).manifold
            f = subfg.add_factor(
                [vlbl], MsgPrior(belief, manifold),
                label=f"{vlbl}_{MSG_TAG}_{msg.sender}_{msg.direction}",
                graphinit=False, tags=(MSG_TAG, "__UPWARD_COMMON__"))
            added.append(f.label)
        return added

    for vlbl, belief in msg.beliefs.items():
        if vlbl not in subfg.variables:
            continue
        manifold = subfg.var(vlbl).manifold
        f = subfg.add_factor(
            [vlbl], MsgPrior(belief, manifold),
            label=f"{vlbl}_{MSG_TAG}_{msg.sender}_{msg.direction}",
            graphinit=False, tags=(MSG_TAG,))
        added.append(f.label)
    return added


def delete_msg_factors(subfg, labels: Optional[List[str]] = None) -> None:
    """Remove message factors, by default every one (reference
    deleteMsgFactors!)."""
    if labels is None:
        labels = [fl for fl in subfg.lsf() if MSG_TAG in fl]
    for fl in labels:
        if fl in subfg.factors:
            subfg.remove_factor(fl)


def _subfg_has_priors(subfg) -> bool:
    """Whether the clique subgraph carries any prior potential, message
    priors from child messages included, so that the flag travels up a
    branch (reference prepCliqueMsgUp: "true only if a prior occurred here
    or lower down in tree branch")."""
    return any(subfg.factor(fl).is_prior for fl in subfg.lsf())


def generate_msg_joint(subfg, clique, solve_key: str = "default",
                       has_priors: bool | None = None) -> JointMsg:
    """Build the joint up-message payload (reference
    _generateMsgJointRelativesPriors).

    Relatives: for separator pairs (by descending manifold dimension) whose
    connecting factor path inside the clique subgraph is homogeneous AND of
    the pair's default factor type, a relative likelihood from the
    per-particle tangent differences of the solved beliefs, which is the
    closed-form deconvolution of LinearRelative and ManifoldFactor.

    Priors: separators are grouped into connectivity classes by paths
    restricted to the default factor type; each class contributes one
    anchor prior on its variable of highest dimension and adjacency."""
    from ..ops.graphops import (find_shortest_path_dijkstra,
                                is_path_factors_homogeneous)
    from ..utils.defaults import select_factor_type

    jm = JointMsg()
    if has_priors is None:
        has_priors = _subfg_has_priors(subfg)
    seps = [s for s in clique.separator
            if subfg.var(s).is_initialized(solve_key)]
    if not seps:
        return jm

    def _default_type(va, vb):
        try:
            return type(select_factor_type(subfg.var(va).vartype,
                                           subfg.var(vb).vartype))
        except ValueError:
            return None

    # 1. relatives over homogeneous paths of the pair's default type
    order = sorted(seps, key=lambda s: -subfg.var(s).manifold.dof)
    rel_count = {s: 0 for s in seps}
    for i, va in enumerate(order):
        for vb in order[i + 1:]:
            ma = subfg.var(va).manifold
            if ma != subfg.var(vb).manifold:
                continue
            is_hom, ftypes = is_path_factors_homogeneous(subfg, va, vb)
            if not is_hom or not ftypes:
                continue
            dtype = _default_type(va, vb)
            if dtype is None or dtype.__name__ != ftypes[0]:
                continue
            pa = subfg.points(va, solve_key)
            pb = subfg.points(vb, solve_key)
            n = min(pa.shape[0], pb.shape[0])
            diffs = ma.log(pa[:n], pb[:n])
            jm.relatives.append((va, vb,
                                 make_belief(Euclidean(ma.dof), diffs)))
            rel_count[va] += 1
            rel_count[vb] += 1

    # 2. connectivity classes under the default factor type
    assigned: Dict[str, int] = {}
    nclass = 0
    for s in seps:                     # separators without a relative first
        if rel_count[s] == 0:
            assigned[s] = nclass
            nclass += 1
    remaining = [s for s in seps if s not in assigned]
    for k, va in enumerate(remaining):
        if va not in assigned:
            assigned[va] = nclass
            nclass += 1
        for vb in remaining[k + 1:]:
            if vb in assigned:
                continue
            dtype = _default_type(va, vb)
            path = [] if dtype is None else find_shortest_path_dijkstra(
                subfg, va, vb, type_factors=(dtype,), initialized=True,
                solve_key=solve_key)
            if path:
                assigned[vb] = assigned[va]
            else:
                assigned[vb] = nclass
                nclass += 1
    classes: Dict[int, list] = {}
    for s, c in assigned.items():
        classes.setdefault(c, []).append(s)

    # 3. one anchor prior per class on its best candidate: only for
    # singleton classes unless the clique itself saw priors
    for syms in classes.values():
        if not (len(syms) == 1 or has_priors):
            continue
        max_dof = max(subfg.var(s).manifold.dof for s in syms)
        cands = [s for s in syms if subfg.var(s).manifold.dof == max_dof]
        best = max(cands, key=lambda s: len(subfg.factors_of(s)))
        jm.priors[best] = subfg.get_belief(best, solve_key)
    return jm


@tracing.spanned("message")
def prep_msg_up(subfg, clique, status: CliqStatus,
                solve_key: str = "default") -> LikelihoodMessage:
    """Separator beliefs → up message (reference prepCliqueMsgUp); a
    NO_INIT message carries only the beliefs that exist.  With
    ``use_msg_likelihoods`` a solved message also carries the joint
    payload (the reference builds it after the clique's up-solve; messages
    of the init phase carry plain beliefs)."""
    msg = LikelihoodMessage(sender=clique.cid, status=status, direction="up")
    for vlbl in clique.separator:
        if solve_key in subfg.var(vlbl).beliefs:
            msg.beliefs[vlbl] = subfg.get_belief(vlbl, solve_key)
    msg.has_priors = _subfg_has_priors(subfg)
    if (subfg.params.use_msg_likelihoods and clique.separator
            and status == CliqStatus.UPSOLVED):
        msg.jointmsg = generate_msg_joint(subfg, clique, solve_key,
                                          has_priors=msg.has_priors)
    return msg


@tracing.spanned("message")
def prep_msg_down(subfg, clique, child, status: CliqStatus,
                  solve_key: str = "default") -> LikelihoodMessage:
    """Beliefs of a child's separator vars → down message."""
    msg = LikelihoodMessage(sender=clique.cid, status=status,
                            direction="down")
    for vlbl in child.separator:
        if vlbl in subfg.variables and \
                solve_key in subfg.var(vlbl).beliefs:
            msg.beliefs[vlbl] = subfg.get_belief(vlbl, solve_key)
    return msg

"""Inter-clique belief messages.

Counterpart of ``incrementalinference/jl_tpu/parallel/messages.py``
(reference LikelihoodMessage, addMsgFactors!, prepCliqueMsgUp): a message
carries separator beliefs and enters a clique subgraph as one MsgPrior per
belief.  The joint-likelihood messages (``use_msg_likelihoods``) are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..beliefs import Belief
from ..models.factors import MsgPrior
from ..tree.bayestree import CliqStatus

__all__ = ["LikelihoodMessage", "add_msg_factors", "prep_msg_up",
           "prep_msg_down", "MSG_TAG"]

MSG_TAG = "__LIKELIHOODMESSAGE__"


@dataclass
class LikelihoodMessage:
    """Belief message over separator variables."""

    sender: int
    status: CliqStatus
    beliefs: Dict[str, Belief] = field(default_factory=dict)
    direction: str = "up"


def add_msg_factors(subfg, msg: LikelihoodMessage) -> List[str]:
    """Insert a message into a clique subgraph as MsgPrior factors
    (reference addMsgFactors!)."""
    added = []
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


def prep_msg_up(subfg, clique, status: CliqStatus,
                solve_key: str = "default") -> LikelihoodMessage:
    """Separator beliefs → up message (reference prepCliqueMsgUp); a
    NO_INIT message carries only the beliefs that exist."""
    msg = LikelihoodMessage(sender=clique.cid, status=status, direction="up")
    for vlbl in clique.separator:
        if solve_key in subfg.var(vlbl).beliefs:
            msg.beliefs[vlbl] = subfg.get_belief(vlbl, solve_key)
    return msg


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

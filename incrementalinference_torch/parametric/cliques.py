"""Parametric tree solve: clique-wise Gaussian message passing.

Counterpart of ``incrementalinference/jl_tpu/parametric/cliques.py``
(reference ParametricCSMFunctions.jl solveUp_ParametricStateMachine :8-97,
solveDown_ParametricStateMachine :105-194, and calculateCoBeliefMessage,
ParametricUtils.jl:744-796).  The up message of a clique is its joint
Gaussian marginal over its separator; the down solve pins the separator at
the parent's solution and re-solves the frontals.  Cliques of one level
solve as one batch where their problems share a signature.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..graph import FactorGraph
from ..models.factors import GaussianJoint
from ..parallel.scheduler import build_clique_subgraph
from ..tree.bayestree import BayesTree, CliqStatus, build_tree_reset
from .solver import (ParametricProblem, autoinit_parametric,
                     init_parametric_from, solve_problems_batched)

__all__ = ["solve_tree_parametric", "GaussianMessage"]


class GaussianMessage:
    """Parametric inter-clique message: a joint Gaussian over the sender's
    separator variables (points, tangent dofs and their joint covariance)."""

    def __init__(self, sender: int, variables: List[str], points, cov,
                 dofs: List[int]):
        self.sender = sender
        self.variables = list(variables)
        self.points = list(points)
        self.cov = cov
        self.dofs = list(dofs)


def _tangent_rows(blocks, device) -> torch.Tensor:
    """The tangent coordinates of (first coordinate, dof) blocks."""
    return torch.as_tensor([s + k for s, d in blocks for k in range(d)],
                           dtype=torch.int64, device=device)


def _attach_message(sub: FactorGraph, msg: GaussianMessage, tag: str) -> None:
    """Add a message to a clique subgraph as a GaussianJoint prior over the
    variables of the message that the subgraph holds (the parametric
    addMsgFactors!)."""
    keep = [i for i, v in enumerate(msg.variables) if v in sub.variables]
    if not keep:
        return
    cov = msg.cov
    if len(keep) < len(msg.variables):
        starts = np.concatenate([[0], np.cumsum(msg.dofs)])
        sel = _tangent_rows([(int(starts[i]), msg.dofs[i]) for i in keep],
                            cov.device)
        cov = cov.index_select(0, sel).index_select(1, sel)
    labels = [msg.variables[i] for i in keep]
    sub.add_factor(labels, GaussianJoint(
        [sub.var(v).manifold for v in labels],
        [msg.points[i] for i in keep], cov),
        label=f"__PARAMMSG_{tag}_{msg.sender}", graphinit=False)


def _finalize_clique(prob: ParametricProblem, sub: FactorGraph,
                     points, cov) -> None:
    for i, v in enumerate(prob.var_labels):
        s, d = int(prob.offsets[i]), prob.dofs[i]
        sv = sub.var(v)
        sv.parametric_point = points[i]
        sv.parametric_cov = cov[s:s + d, s:s + d]
    prob.full_cov = cov


def _marginal_message(prob: ParametricProblem, sub: FactorGraph,
                      clique) -> GaussianMessage:
    seps = clique.separator
    sel = _tangent_rows([(int(prob.offsets[prob.slot[v]]),
                          prob.dofs[prob.slot[v]]) for v in seps],
                        prob.full_cov.device)
    cov = prob.full_cov.index_select(0, sel).index_select(1, sel)
    return GaussianMessage(clique.cid, seps,
                           [sub.var(v).parametric_point for v in seps], cov,
                           [prob.dofs[prob.slot[v]] for v in seps])


def _copy_frontals(fg: FactorGraph, sub: FactorGraph, clique) -> None:
    for v in clique.frontals:
        fv, sv = fg.var(v), sub.var(v)
        fv.parametric_point = sv.parametric_point
        fv.parametric_cov = sv.parametric_cov


def solve_tree_parametric(fg: FactorGraph,
                          old_tree: Optional[BayesTree] = None,
                          order=None, mesh=None) -> BayesTree:
    """Clique-wise parametric solve over the Bayes tree (reference
    solveTree!(...; algorithm=:parametric), SolverAPI.jl:423).

    Linearization points come from the nonparametric beliefs where there
    are any (initParametricFrom!), then from ``autoinit_parametric``.  With
    ``old_tree``, a clique whose whole subtree is unchanged re-sends its
    previous up message instead of solving (the parametric UPRECYCLED).
    That rests on factor models not being edited in place: an edited
    measurement under an unchanged label makes the recycled message stale,
    as it would in the reference (attemptTreeSimilarClique matches labels).
    ``tree.param_batches`` lists the size of every batched LM call.
    ``mesh`` splits each batch over the mesh's devices
    (``solve_problems_batched``)."""
    if any(fg.var(v).parametric_point is None for v in fg.ls()):
        init_parametric_from(fg, only_missing=True)
    if any(fg.var(v).parametric_point is None for v in fg.ls()):
        autoinit_parametric(fg)

    tree = build_tree_reset(fg, order=order, old_tree=old_tree)
    levels = tree.levels()
    up_msgs: Dict[int, GaussianMessage] = {}
    old_msgs = old_tree.param_up_msgs if old_tree is not None else {}

    # up sweep, leaves first; a level's cliques batch where they can
    for level in reversed(levels):
        entries = []
        for cid in level:
            cl = tree.clique(cid)
            cached = old_msgs.get(cl.signature()) \
                if cl.is_recycled and cl.status == CliqStatus.UPRECYCLED \
                else None
            if cached is not None:
                msg = GaussianMessage(cl.cid, cached.variables,
                                      cached.points, cached.cov, cached.dofs)
                up_msgs[cl.cid] = msg
                tree.param_up_msgs[cl.signature()] = msg
                continue
            sub = build_clique_subgraph(fg, cl)
            for ch in cl.children:
                if ch in up_msgs:
                    _attach_message(sub, up_msgs[ch], "up")
            entries.append((cl, sub, ParametricProblem(sub)))
        res = solve_problems_batched([p for _, _, p in entries],
                                     batch_sizes=tree.param_batches,
                                     mesh=mesh)
        for (cl, sub, prob), (points, cov, _) in zip(entries, res):
            _finalize_clique(prob, sub, points, cov)
            msg = _marginal_message(prob, sub, cl)
            up_msgs[cl.cid] = msg
            tree.param_up_msgs[cl.signature()] = msg
            cl.status = CliqStatus.UPSOLVED
            _copy_frontals(fg, sub, cl)

    # down sweep, root first: separators pinned at the parent's solution
    for level in levels:
        entries = []
        for cid in level:
            cl = tree.clique(cid)
            if cl.parent is None:
                cl.status = CliqStatus.DOWNSOLVED
                continue
            sub = build_clique_subgraph(fg, cl)
            for ch in cl.children:
                if ch in up_msgs:
                    _attach_message(sub, up_msgs[ch], "dwn")
            entries.append((cl, sub,
                            ParametricProblem(sub, frozen=cl.separator)))
        res = solve_problems_batched([p for _, _, p in entries],
                                     batch_sizes=tree.param_batches,
                                     mesh=mesh)
        for (cl, sub, prob), (points, cov, _) in zip(entries, res):
            _finalize_clique(prob, sub, points, cov)
            cl.status = CliqStatus.DOWNSOLVED
            _copy_frontals(fg, sub, cl)
            for v in cl.frontals:
                p = fg.var(v).parametric_point
                fg.var(v).ppe["parametric"] = {"mean": p, "max": p,
                                               "suggested": p}

    for v in fg.variables.values():
        if v.solvable and v.parametric_point is not None:
            v.solved_count["parametric"] = \
                v.get_solved_count("parametric") + 1
    fg.solve_count += 1
    return tree

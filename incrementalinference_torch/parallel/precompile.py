"""Ahead-of-solve preparation of a tree solve's update structures.

Counterpart of ``incrementalinference/jl_tpu/parallel/precompile.py``.
There, every distinct fused-update and clique-chain structure is an XLA
program that compiles on first use, so the JAX package enumerates them and
compiles them ahead (in a thread pool, or in worker processes that fill a
persistent cache).  The port runs eagerly: nothing is compiled per
structure, and the only thing built ahead of a solve is the row-logsumexp
CUDA kernel (ops/kernels/row_lse.py), on a graph that lives on a CUDA
device.  The enumeration is kept, with the JAX package's job list and
count, so that a caller sees the same number of distinct structures.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from ..tree.bayestree import BayesTree, CliqStatus, build_tree
from .messages import LikelihoodMessage, add_msg_factors
from .scheduler import build_clique_subgraph

__all__ = ["precompile_updates", "precompile_processes"]

logger = logging.getLogger(__name__)


def _jobs(fg, tree: BayesTree, solve_key: str) -> list:
    """The distinct update structures (one per ``UpdatePlan``
    structure key) and clique-chain structures a solve of ``tree`` meets,
    in the JAX package's deterministic order.  Placeholder child messages
    stand in for the ones the up sweep will attach."""
    from ..beliefs import make_belief
    from ..ops.graphops import UpdatePlan, model_structure, prepare_update
    from .scheduler import (_DescendantFrontals, _build_chain_plan,
                            _use_chain, add_down_variable_factors)

    plans: Dict = {}
    chains: Dict = {}
    use_chain = _use_chain(fg.params)

    def note_chain(sub, direct, iters):
        plan, store, _ = _build_chain_plan(sub, list(direct), list(iters),
                                           solve_key)
        if plan is True or plan is False:
            return
        sig = (tuple(plan["direct"]), tuple(plan["iter"]),
               tuple(tuple(p.shape) for p in store),
               model_structure((tuple(plan["models_direct"]),
                                tuple(plan["models_iter"]))))
        chains.setdefault(sig, plan)

    def placeholder(sub, sender, variables, status, direction):
        msg = LikelihoodMessage(sender=sender, status=status,
                                direction=direction)
        for vlbl in variables:
            if vlbl in sub.variables:
                msg.beliefs[vlbl] = make_belief(
                    sub.var(vlbl).manifold, sub.points(vlbl, solve_key))
        add_msg_factors(sub, msg)

    def attach_child_msgs(sub, cl):
        for ch in tree.children(cl.cid):
            placeholder(sub, ch.cid, ch.separator, CliqStatus.UPSOLVED, "up")

    for cl in tree.cliques.values():
        sub = build_clique_subgraph(fg, cl)
        attach_child_msgs(sub, cl)
        for var in cl.all_vars:
            plan = prepare_update(sub, var, sub.factors_of(var),
                                  solve_key=solve_key)
            if isinstance(plan, UpdatePlan):
                plans.setdefault(plan.structure_key, plan)
        if not use_chain:
            continue
        note_chain(sub, cl.direct_vars, cl.iter_vars)
        # the down-solve's chain, built as down_solve_clique builds it;
        # only on an initialized graph does the widening match
        if all(fg.var(v).is_initialized(solve_key) for v in cl.all_vars):
            dsub = build_clique_subgraph(fg, cl)
            add_down_variable_factors(
                fg, dsub, cl, require_initialized=solve_key,
                exclude=_DescendantFrontals(tree, cl.cid))
            attach_child_msgs(dsub, cl)
            if cl.parent is not None:
                placeholder(dsub, cl.parent, cl.separator,
                            CliqStatus.DOWNSOLVED, "down")
                for vlbl in cl.separator:
                    if vlbl in dsub.variables:
                        dsub.var(vlbl).marginalized = True
            iter_f = [v for v in cl.iter_vars if v in cl.frontals]
            note_chain(dsub, [v for v in cl.frontals if v not in iter_f],
                       iter_f)
    return list(plans.values()) + list(chains.values())


def precompile_updates(fg, tree: Optional[BayesTree] = None,
                       max_workers: int = 8, solve_key: str = "default",
                       shard: Optional[tuple] = None) -> int:
    """Prepare a solve of ``tree`` (built from ``fg`` when omitted): on a
    graph on a CUDA device, build the row-logsumexp kernel.  Eager PyTorch
    has nothing else to compile ahead, so this is all the preparation
    there is.  Returns the number of distinct update and clique-chain
    structures the solve will run, the JAX package's count of programs it
    compiles; ``shard=(i, k)`` counts every k-th of them from the i-th, as
    a worker of the JAX package's farm takes them.  ``max_workers`` is
    kept for the JAX signature: there is no pool to size."""
    del max_workers
    if tree is None:
        tree = build_tree(fg)
    jobs = _jobs(fg, tree, solve_key)
    if shard is not None:
        i, k = shard
        jobs = jobs[i::k]
    if fg.device.type == "cuda":
        from ..ops.kernels import row_lse
        row_lse.build()
    return len(jobs)


class _DoneFarm:
    """The JAX package's farm handle for work already done in-process:
    ``wait()`` returns the structure count."""

    def __init__(self, n: int):
        self.n = n

    def wait(self) -> int:
        return self.n


def precompile_processes(fg, tree: Optional[BayesTree] = None,
                         n_procs: int = 2, solve_key: str = "default",
                         timeout: float = 600.0, wait: bool = True):
    """The JAX package's process farm fills a persistent XLA cache from
    ``n_procs`` workers.  The port has no such cache to fill, so this runs
    :func:`precompile_updates` in this process (the JAX package's own path
    when no cache is configured) and says so once in the log.  Returns the
    structure count, or with ``wait=False`` a handle whose ``wait()``
    returns it."""
    del timeout
    logger.info("precompile: no process farm to start (%d workers asked); "
                "eager PyTorch has no compile cache to fill, preparing "
                "in-process", n_procs)
    n = precompile_updates(fg, tree, solve_key=solve_key)
    return n if wait else _DoneFarm(n)

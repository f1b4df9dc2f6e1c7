"""Solver API — user entry points.

Counterpart of ``incrementalinference/jl_tpu/api.py`` (reference
solveTree! = solveGraph!, solveCliqUp!/solveCliqDown!): init → freeze →
tree build, recycling cliques of the previous solve's tree → up/down sweeps.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

from .beliefs import Belief, ppe as calc_ppe
from .canonical import generate_kaess
from .config import full_precision, resolve_device
from .graph import FactorGraph
from .graphinit import ensure_solvable, init_all
from .parallel.messages import (LikelihoodMessage, prep_msg_down,
                                prep_msg_up)
from .parallel.scheduler import (down_solve_clique, solve_tree_sweeps,
                                 up_solve_clique)
from .parametric import solve_graph_parametric
from .parametric.cliques import solve_tree_parametric
from .tree.bayestree import BayesTree, CliqStatus, build_tree_reset

__all__ = ["solve_tree", "solve_graph", "solve_cliq_up", "solve_cliq_down",
           "solve_cliq_with_state_machine", "approx_cliq_marginal_up",
           "fifo_freeze", "set_ppe", "warmup"]

logger = logging.getLogger(__name__)


def set_ppe(fg: FactorGraph, label: str, solve_key: str = "default") -> dict:
    """Compute and store one variable's posterior point estimate from its
    current belief (reference setPPE!).  Returns the stored dict (mean, max,
    suggested)."""
    v = fg.var(label)
    est = calc_ppe(v.manifold, fg.get_belief(label, solve_key))
    v.ppe[solve_key] = est
    return est


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


@full_precision()
def solve_tree(fg: FactorGraph, old_tree: Optional[BayesTree] = None,
               solve_key: str = "default", store_old: bool = False,
               up: Optional[bool] = None, down: Optional[bool] = None,
               order: Optional[Sequence[str]] = None,
               algorithm: str = "default",
               skip_cliques: Sequence[int] = (),
               delay_cliques: Optional[Dict[int, float]] = None,
               timeout: Optional[float] = None,
               mesh=None, distribute: str = "particles",
               precompile=False,
               verbose: bool = False) -> BayesTree:
    """Nonparametric MM-iSAM solve over the Bayes tree (reference
    solveTree!).  Runs on the graph's device.  Returns the tree: pass it
    back as ``old_tree`` after the graph has grown, and the cliques that
    are unchanged are recycled (``SolverParams.incremental``).

    ``algorithm="parametric"`` runs the clique-wise Gaussian solve instead
    (reference solveTree!(...; algorithm=:parametric), SolverAPI.jl:423;
    parametric/cliques.py).

    Fault injection (reference skipcliqids, delaycliqs, timeout):
    ``skip_cliques`` are left untouched, ``delay_cliques`` ({cid: seconds})
    sleep before their up-solve, and once ``timeout`` seconds have passed
    the cliques not yet solved are marked ERROR_STATUS and the solve raises
    after the sweep.  With ``record_cliques`` the traces are also written
    under ``params.logpath``: ``HistoryAll_<solve>.txt`` and, appended
    solve after solve, ``logs/cliq<cid>/log.txt``.

    ``mesh`` (parallel/mesh.py ``Mesh``) distributes the solve, as the JAX
    package's ``distribute`` policy does:
    - ``"particles"``: every clique splits its per-particle solves over the
      mesh (each variable's N must be a multiple of the mesh's size), and
      ``batch_cliques`` is switched off on the graph's params;
    - ``"cliques"``: with ``batch_cliques`` on, each batched level's
      classes split their members over the mesh (and the other cliques
      their particles); with it off, the cliques of each level are placed
      on the mesh's devices round robin;
    - ``"auto"``: batched levels split their members, the other levels
      their particles (the width-aware policy).
    The parametric algorithm splits each level's batches over the mesh.

    ``precompile``: True prepares the solve's update structures first
    (parallel/precompile.py ``precompile_updates``: on CUDA it builds the
    kernel); an int asks the JAX package's process farm, which the port
    does not have: it prepares in-process and says so in the log."""
    if algorithm == "parametric":
        return solve_tree_parametric(fg, old_tree=old_tree, order=order,
                                     mesh=mesh)
    if distribute not in ("particles", "cliques", "auto"):
        raise ValueError(f"unknown distribute {distribute!r}")
    if algorithm != "default":
        raise ValueError(f"unknown algorithm {algorithm!r}")
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
    if mesh is not None and distribute == "particles":
        for v in fg.variables.values():
            if v.N % len(mesh.devices):
                raise ValueError(
                    f"N={v.N} must divide the mesh size "
                    f"{len(mesh.devices)} for particle sharding")

    tree = build_tree_reset(fg, order=order, old_tree=old_tree)
    if precompile:
        from .parallel.precompile import (precompile_processes,
                                          precompile_updates)
        if isinstance(precompile, bool):
            n = precompile_updates(fg, tree, solve_key=solve_key)
        else:
            n = precompile_processes(fg, tree, n_procs=int(precompile),
                                     solve_key=solve_key)
        if verbose:
            logger.info("precompiled %d structures", n)
    if verbose:
        logger.info("tree: %d cliques, depth %d, build %.3fs",
                    tree.num_cliques(), len(tree.levels()), tree.build_time)

    # the distribution policy of the JAX package (jl_tpu/api.py:166-200)
    batched_mesh = (mesh if (mesh is not None
                             and distribute in ("cliques", "auto")
                             and bool(params.batch_cliques)) else None)
    if (mesh is not None and batched_mesh is None and distribute != "auto"
            and params.batch_cliques):
        fg.params = params = params.replace(batch_cliques=False)
    if mesh is None or distribute == "cliques" and batched_mesh is None:
        sweep_mesh = None
    else:
        sweep_mesh = mesh
    tree.traces = solve_tree_sweeps(
        fg, tree, solve_key=solve_key,
        up=params.upsolve if up is None else up,
        down=params.downsolve if down is None else down,
        skip_cliques=skip_cliques, delay_cliques=delay_cliques,
        timeout=timeout, mesh=sweep_mesh,
        devices=(list(mesh.devices) if mesh is not None
                 and distribute == "cliques" and batched_mesh is None
                 else None))
    if params.record_cliques and tree.traces:
        _write_history(params.logpath, fg.solve_count, tree.traces)
    for v in fg.variables.values():
        if v.solvable and v.is_initialized(solve_key):
            v.solved_count[solve_key] = v.get_solved_count(solve_key) + 1
    fg.solve_count += 1
    if verbose:
        logger.info("solve_tree done in %.3fs", time.time() - t0)
    return tree


def _write_history(logpath: str, solve: int, traces: dict) -> None:
    """The solve-wide trace dump (reference HistoryCSMAll.txt) and one
    appended log per clique (reference logpath/logs/cliqN/log.txt).  A
    directory that cannot be written costs a warning, not the solve."""
    try:
        os.makedirs(logpath, exist_ok=True)
        with open(os.path.join(logpath, f"HistoryAll_{solve}.txt"),
                  "w") as fp:
            for cid, tr in sorted(traces.items()):
                for ts, step, detail in tr.events:
                    fp.write(f"{ts:.3f}\tcliq{cid}\t{step}\t{detail}\n")
        for cid, tr in sorted(traces.items()):
            cliqdir = os.path.join(logpath, "logs", f"cliq{cid}")
            os.makedirs(cliqdir, exist_ok=True)
            with open(os.path.join(cliqdir, "log.txt"), "a") as fp:
                fp.write(f"# solve {solve}\n")
                for ts, step, detail in tr.events:
                    fp.write(f"{ts:.3f}\t{step}\t{detail}\n")
    except OSError:
        logger.warning("could not write the trace dump to %s", logpath)


def solve_graph(fg: FactorGraph, **kw) -> BayesTree:
    """Alias of :func:`solve_tree` (reference solveGraph! = solveTree!)."""
    return solve_tree(fg, **kw)


@full_precision()
def solve_cliq_up(fg: FactorGraph, tree: BayesTree, frontal: str,
                  child_msgs: Optional[List[LikelihoodMessage]] = None,
                  solve_key: str = "default") -> LikelihoodMessage:
    """Up-solve the one clique that holds ``frontal`` (reference
    solveCliqUp!).

    ``child_msgs=None`` builds each child's up message from the graph's
    current beliefs; pass ``[]`` for a solve without messages.  A child
    whose separator is not initialized under ``solve_key`` is left out with
    a warning: a message made of its placeholder points would enter the
    solve as a prior."""
    cl = tree.clique_of(frontal)
    if child_msgs is None:
        child_msgs = []
        for ch in tree.children(cl.cid):
            if all(fg.var(v).is_initialized(solve_key)
                   for v in ch.separator if v in fg.variables):
                child_msgs.append(prep_msg_up(fg, ch, CliqStatus.UPSOLVED,
                                              solve_key))
            else:
                logger.warning(
                    "solve_cliq_up(%s): no message from child clique %d, "
                    "its separator is not initialized under %r", frontal,
                    ch.cid, solve_key)
    return up_solve_clique(fg, tree, cl, child_msgs, solve_key)


# reference solveCliqWithStateMachine: one clique's solve in isolation is
# the harness above (the state machine became the static schedule)
solve_cliq_with_state_machine = solve_cliq_up


@full_precision()
def approx_cliq_marginal_up(fg: FactorGraph, tree: BayesTree, frontal: str,
                            child_msgs: Optional[List[LikelihoodMessage]]
                            = None, solve_key: str = "default"
                            ) -> Dict[str, Belief]:
    """Run one clique's up Gibbs and return the marginal belief of each of
    its variables, frontals and separator (reference
    approxCliqMarginalUp!)."""
    cl = tree.clique_of(frontal)
    up_solve_clique(fg, tree, cl, child_msgs or [], solve_key)
    return {v: fg.get_belief(v, solve_key) for v in cl.all_vars}


@full_precision()
def solve_cliq_down(fg: FactorGraph, tree: BayesTree, frontal: str,
                    down_msg: Optional[LikelihoodMessage] = None,
                    child_msgs: Optional[List[LikelihoodMessage]] = None,
                    solve_key: str = "default"
                    ) -> Dict[int, LikelihoodMessage]:
    """Down-solve the one clique that holds ``frontal`` (reference
    solveCliqDown!).  ``down_msg=None`` on a clique with a parent builds the
    incoming message from the parent's current beliefs."""
    cl = tree.clique_of(frontal)
    if down_msg is None and cl.parent is not None:
        down_msg = prep_msg_down(fg, tree.clique(cl.parent), cl,
                                 CliqStatus.DOWNSOLVED, solve_key)
    return down_solve_clique(fg, tree, cl, down_msg, solve_key,
                             child_msgs=child_msgs)


@full_precision()
def warmup(parametric: bool = True, device=None) -> None:
    """Make the first real solve fast: on CUDA, build the row-logsumexp
    kernel; then solve the Kaess example, and with ``parametric`` its
    parametric form (the reference's precompile workload,
    src/IncrementalInference.jl:242-249)."""
    device = resolve_device(device)
    if device.type == "cuda":
        from .ops.kernels import row_lse
        row_lse.build()
    solve_tree(generate_kaess(graphinit=True, device=device))
    if parametric:
        solve_graph_parametric(generate_kaess(graphinit=False,
                                              device=device))

"""Variable auto-initialization from factor neighborhoods.

Counterpart of ``incrementalinference/jl_tpu/graphinit.py`` (reference
src/services/GraphInit.jl: factorCanInitFromOtherVars, doautoinit!,
initVariable!, resetInitialValues!, initAll!, ensureSolvable!).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import keys as _keys
from . import tracing
from .beliefs import Belief, LazyPPE
from .models.factors import GenericMarginal, MetaPrior
from .ops.graphops import propagate_belief

logger = logging.getLogger(__name__)

__all__ = ["factor_can_init", "doautoinit", "init_variable",
           "reset_initial_values", "init_all", "ensure_solvable"]


def factor_can_init(fg, factor_label: str, target: str,
                    solve_key: str = "default") -> bool:
    """Can ``factor`` propose for ``target``?  Every other variable must be
    initialized, except uninitialized *uncertain* multihypo siblings."""
    f = fg.factor(factor_label)
    if isinstance(f.model, (MetaPrior, GenericMarginal)):
        return False
    if target not in f.variables:
        return False
    for i, vl in enumerate(f.variables):
        if vl == target or fg.var(vl).is_initialized(solve_key):
            continue
        if f.multihypo is not None and f.multihypo[i] < 1.0 - 1e-9:
            continue
        return False
    return True


@tracing.spanned("graphinit", lambda fg, label, *a, **k: {"variable": label})
def doautoinit(fg, label: str, solve_key: str = "default") -> bool:
    """Initialize ``label`` from its usable neighbor factors if possible
    (reference doautoinit!); keeps a copy under the "graphinit" key."""
    v = fg.var(label)
    if v.is_initialized(solve_key):
        return True
    usable = [fl for fl in fg.factors_of(label)
              if factor_can_init(fg, fl, label, solve_key)]
    if not usable:
        return False
    belief, ipc = propagate_belief(fg, label, usable, solve_key=solve_key)
    fg.set_belief(label, belief.points, solve_key=solve_key,
                  bw=belief.bw, ipc=ipc, initialized=True)
    v.ppe[solve_key] = LazyPPE(v.manifold, belief)
    fg.set_belief(label, belief.points, solve_key="graphinit",
                  bw=belief.bw, ipc=ipc, initialized=True)
    return True


def init_variable(fg, label: str, value, solve_key: str = "default",
                  bw=None) -> Belief:
    """Initialize a variable by hand from a Belief, a distribution (N draws
    from the graph's key stream) or points; one point is repeated N times
    (reference initVariable!)."""
    v = fg.var(label)
    if isinstance(value, Belief):
        pts, bw = value.points, value.bw
    elif hasattr(value, "sample"):
        pts = value.sample(_keys.generator(fg.next_key(), fg.device), v.N)
    else:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value, np.float32))
        pts = value.to(device=fg.device, dtype=torch.float32)
        if pts.ndim == 1:
            pts = pts.expand((v.N,) + pts.shape).clone()
    b = fg.set_belief(label, pts, solve_key=solve_key, bw=bw,
                      initialized=True)
    v.ppe[solve_key] = LazyPPE(v.manifold, b)
    return b


def reset_initial_values(fg, solve_key: str = "default",
                         src_key: str = "graphinit") -> None:
    """Restore every belief from its "graphinit" snapshot (reference
    resetInitialValues!)."""
    for lbl, v in fg.variables.items():
        if src_key in v.beliefs:
            b = v.beliefs[src_key]
            fg.set_belief(lbl, b.points, solve_key=solve_key, bw=b.bw,
                          ipc=b.ipc, initialized=True)


def ensure_solvable(fg, solvable_target: int = 1,
                    solvable_fallback: int = 0) -> list:
    """Demote solvable variables with no solvable factor to
    ``solvable_fallback`` (reference ensureSolvable!); variables demoted
    here are promoted again once they gain a solvable factor.  Returns the
    demoted labels."""
    demoted = getattr(fg, "_auto_demoted", set())
    for lbl in list(demoted):
        v = fg.variables.get(lbl)
        if v is None:
            demoted.discard(lbl)
            continue
        if v.solvable == solvable_fallback and any(
                fg.factor(fl).solvable >= solvable_target
                for fl in fg.factors_of(lbl)):
            v.solvable = solvable_target
            demoted.discard(lbl)
    blank = []
    for lbl, v in fg.variables.items():
        if v.solvable != solvable_target:
            continue
        if not any(fg.factor(fl).solvable >= solvable_target
                   for fl in fg.factors_of(lbl)):
            v.solvable = solvable_fallback
            blank.append(lbl)
            demoted.add(lbl)
    fg._auto_demoted = demoted
    if blank:
        logger.warning("solve disallows solvable variables without any "
                       "connected solvable factors -- forcing solvable=0 "
                       "on %s", blank)
    return blank


def init_all(fg, solve_key: str = "default", max_passes: int = 10) -> bool:
    """Fixed-point init over all variables until nothing changes
    (reference initAll!, at most 10 passes)."""
    for _ in range(max_passes):
        changed = False
        for lbl in fg.ls():
            if not fg.var(lbl).is_initialized(solve_key):
                if doautoinit(fg, lbl, solve_key=solve_key):
                    changed = True
        if all(fg.var(lbl).is_initialized(solve_key) for lbl in fg.ls()):
            return True
        if not changed:
            break
    return all(fg.var(lbl).is_initialized(solve_key) for lbl in fg.ls())

"""Solver configuration and device selection.

PyTorch counterpart of ``incrementalinference/jl_tpu/config.py``: the same
``SolverParams`` fields with the same defaults (reference:
src/entities/SolverParams.jl:12-75), so a graph configured for one package
means the same thing in the other.  Fields whose behaviour this port does not
implement yet are kept for parity and documented as such.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
from typing import Any

import torch


@dataclasses.dataclass
class SolverParams:
    """Global solver knobs (field parity with the JAX package)."""

    # Particle count per marginal belief (reference default N=100).
    N: int = 100
    # Solve-key bookkeeping: which algorithms get per-variable solver data.
    algorithms: tuple = ("default", "parametric")
    # Auto-initialize variables from factor neighborhoods on addFactor.
    graphinit: bool = True
    # Incremental tree recycling between solves: with an ``old_tree``,
    # cliques whose signature and subtree are unchanged skip their up-solve.
    incremental: bool = True
    # Joint/likelihood up-messages (reference useMsgLikelihoods): solved up
    # messages also carry relative likelihoods between separator pairs
    # (parallel/messages.py generate_msg_joint).
    use_msg_likelihoods: bool = False
    # Entropy inflation factor for convolution proposals (reference 5.0).
    inflation: float = 5.0
    # Spread multiplier for null-hypothesis entropy (reference spreadNH=3.0).
    spread_nh: float = 3.0
    # nullSurplus boost for relative non-multihypo siblings of a multihypo
    # factor at a proposal target (reference nullSurplusAdd=0.3).
    null_surplus_add: float = 0.3
    # Gibbs iterations per clique solve (reference gibbsIters=3).
    gibbs_iters: int = 3
    # Inflation/solve cycles per convolution (reference inflateCycles=3).
    inflate_cycles: int = 3
    # Fixed-lag marginalization window (0 = disabled).
    qfl: int = 0
    is_fixed_lag: bool = False
    fixed_lag_only_clique_side: bool = False
    # Bound on the per-clique init cycling passes.
    limit_iters: int = 500
    # Bound on tree-init fixed-point passes (reference limittreeinit_iters).
    limit_treeinit_iters: int = 10
    # Max factors per variable before the graph builder refuses.
    max_incidence: int = 500
    # Elimination ordering: "qr" | "colamd" | "ccolamd" (constrained
    # min-degree), as in the JAX package.
    ordering: str = "ccolamd"
    # Gauss-Newton iterations for the batched per-particle solve.
    conv_iters: int = 25
    # Levenberg damping for the batched per-particle solve.
    conv_damping: float = 1e-6
    # Gibbs sweeps inside the KDE manifold product (API parity only).
    product_gibbs_sweeps: int = 3
    # Upsolve only / downsolve only switches.
    upsolve: bool = True
    downsolve: bool = True
    # Where a solve with ``record_cliques`` writes its history files
    # (reference logpath): HistoryAll_<solve>.txt and logs/cliq<cid>/log.txt.
    # The JAX package's "/tmp/iitpu", under the temporary directory the
    # environment names.
    logpath: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "iitpu"))
    # Seed of the graph's host-side key stream (see keys.py).
    seed: int = 42
    # Record per-clique scheduler traces (tree.traces after a solve).
    record_cliques: bool = False
    # dtype for belief/particle arrays.
    dtype: str = "float32"
    # Batched same-level clique solves (parallel/scheduler.py
    # up_solve_level): True batches every level, "auto" the levels of at
    # least batch_min_width cliques, False none.  The isomorphic cliques of
    # a batched level keep their particles stacked and run each update of
    # their schedule as one batched update (one kernel launch per large
    # product stage for all of them).  Solves with skipped or delayed
    # cliques, or with round-robin devices, take the per-clique sweep.
    batch_cliques: object = "auto"
    batch_min_width: int = 8
    # With a mesh (solve_tree(mesh=...)): the cliques outside a batched
    # level split their per-particle solves over the mesh's devices
    # ("auto"/True), or stay on one device (False).
    shard_particles: object = "auto"
    # Whole-clique Gibbs schedule through one plan (ops/fused.py
    # fused_clique_gibbs) instead of one graph write per variable update.
    # True/"auto" take the clique chain, False the per-variable path; both
    # run the same update schedule.
    fuse_clique: object = "auto"
    # Chain segments of the JAX package (API parity only): every value
    # up-solves clique by clique, as the JAX package's "auto" does.  Kept
    # so that a graph saved with any value loads.
    fuse_sweep: object = "auto"
    # Wildfire down-solve gate for incremental solves: a recycled clique
    # whose incoming down message moved at most this many spreads since the
    # last solve skips its down-solve.  0.0 is off (reference semantics:
    # recycled cliques re-run the down pass); "auto" turns it on for trees
    # with many recycled cliques (parallel/scheduler.py).
    wildfire_tol: object = 0.0

    def replace(self, **kw: Any) -> "SolverParams":
        return dataclasses.replace(self, **kw)


def resolve_device(device=None) -> torch.device:
    """The device a graph lives on: CUDA unless the caller names another.

    Asking for CUDA where none is available raises; nothing falls back to
    the CPU.  Nothing global changes: the precision of the solves is pinned
    by :func:`full_precision`, for their span only."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


# The pin's state, shared by every thread: the settings are the process's.
_PIN_LOCK = threading.Lock()
_pin = {"depth": 0, "saved": None}


@contextlib.contextmanager
def full_precision():
    """Pin float32 matrix products and cuDNN convolutions to IEEE float32
    for the span of the ``with`` (or of a function it decorates), and give
    the caller's settings back on exit, also when an exception leaves it.

    TF32 rounds a product's inputs to 10 mantissa bits; the JAX package
    asks for ``Precision.HIGHEST`` on every small-K product instead.  The
    device entry points and the three functions where the JAX package asks
    for it (``_pair_logW``, ``condense_mixture``, ``loo_bandwidth``) run
    under this pin, so a caller's
    ``torch.set_float32_matmul_precision("high")`` (or TF32 set any other
    way) stays outside the solves and keeps acting on the caller's own
    work.  Only the per-backend ``fp32_precision`` settings
    are read and written: reading the legacy ``allow_tf32`` raises once a
    caller has set the new ones.

    The settings belong to the whole process, so the spans of all threads
    count as one: the first to enter saves the caller's settings, the last
    to leave gives them back, and every span in between runs pinned.  Two
    threads inside spans at once therefore both run in IEEE, and the
    caller's settings come back once both are done.  Spans nest the same
    way."""
    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    with _PIN_LOCK:
        if _pin["depth"] == 0:
            _pin["saved"] = mm.fp32_precision, conv.fp32_precision
        _pin["depth"] += 1
        mm.fp32_precision = conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        with _PIN_LOCK:
            _pin["depth"] -= 1
            if _pin["depth"] == 0:
                mm.fp32_precision, conv.fp32_precision = _pin["saved"]
                _pin["saved"] = None

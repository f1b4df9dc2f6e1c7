"""Solver configuration and device selection.

PyTorch counterpart of ``incrementalinference/jl_tpu/config.py``: the same
``SolverParams`` fields with the same defaults (reference:
src/entities/SolverParams.jl:12-75), so a graph configured for one package
means the same thing in the other.  Fields whose behaviour this port does not
implement yet are kept for parity and documented as such.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
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
    # Elimination ordering: "colamd" | "ccolamd" (constrained min-degree).
    # The JAX package also offers "qr"; the port does not yet.
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
    # Batched same-level clique solves (JAX package).  Kept for parity: the
    # port always sweeps cliques one at a time.
    batch_cliques: object = "auto"
    batch_min_width: int = 8
    # Multi-device particle sharding (JAX package); kept for parity.
    shard_particles: object = "auto"
    # Whole-clique Gibbs schedule through one plan (ops/fused.py
    # fused_clique_gibbs) instead of one graph write per variable update.
    # True/"auto" take the clique chain, False the per-variable path; both
    # run the same update schedule.
    fuse_clique: object = "auto"
    # Segment fusion (JAX package); kept for parity, not ported.
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
    the CPU.  On CUDA, float32 matrix products and convolutions are pinned
    to full IEEE precision: TF32 keeps ~3 decimal digits, which costs ~1e-2
    in the pair-product log-weights (the JAX package uses
    ``Precision.HIGHEST`` on every small-K product for the same reason)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

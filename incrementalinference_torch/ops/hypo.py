"""Multihypothesis / nullhypothesis recipes as per-particle masks.

Counterpart of ``incrementalinference/jl_tpu/ops/hypo.py``: one hypothesis
id is drawn per particle and the reference's particle partitions become
masks over a single batched solve.

Hypothesis id convention per particle (int64):
  0          -> null hypothesis (factor inactive; entropy only)
  j >= 1     -> 1-based index into the factor's variable list of the selected
                *uncertain* variable (plain factors: 1 = active).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import keys as _keys

__all__ = ["parse_multihypo", "draw_hypotheses", "HypoMasks", "build_masks"]


def parse_multihypo(multihypo: Optional[Tuple[float, ...]]):
    """Split a multihypo weight vector into (certain, uncertain, weights);
    None when every variable is certain.  Weights of 1.0 mark certain
    variables; the fractional ones must sum to 1."""
    if multihypo is None:
        return None
    mh = tuple(float(w) for w in multihypo)
    certain = tuple(i for i, w in enumerate(mh) if w >= 1.0 - 1e-9)
    uncertain = tuple(i for i, w in enumerate(mh) if w < 1.0 - 1e-9)
    if not uncertain:
        return None
    wsum = sum(mh[i] for i in uncertain)
    if abs(wsum - 1.0) > 1e-6:
        raise ValueError(
            f"multihypo fractional weights must sum to 1, got {wsum}")
    weights = tuple(mh[i] for i in uncertain)
    return certain, uncertain, weights


def draw_hypotheses(key: int, n: int, nvars: int,
                    multihypo: Optional[Tuple[float, ...]],
                    nullhypo: float, device) -> torch.Tensor:
    """Per-particle hypothesis ids (reference mhidx)."""
    parsed = parse_multihypo(multihypo)
    if parsed is None:
        if nullhypo <= 0.0:
            # the JAX package draws from log([1e-30, 1]): never the null
            return torch.ones((n,), dtype=torch.int64, device=device)
        probs = [nullhypo, 1.0 - nullhypo]
    else:
        _, uncertain, weights = parsed
        probs = [nullhypo] + [0.0] * nvars
        for i, w in zip(uncertain, weights):
            probs[i + 1] = w * (1.0 - nullhypo)
    logits = torch.tensor([math.log(max(p, 1e-30)) for p in probs],
                          dtype=torch.float32, device=device)
    return _keys.categorical(key, logits, n)


class HypoMasks:
    """Masks + gather plan for one convolution solve-for."""

    def __init__(self, solve_mask, null_mask, snap_mask, uncertain_slot,
                 gather_idx, mech_vars):
        # (n,) bool: particles solved through the factor residual
        self.solve_mask = solve_mask
        # (n,) bool: null-hypothesis particles (entropy only)
        self.null_mask = null_mask
        # (n,) bool: other hypothesis selected while solving an uncertain var
        self.snap_mask = snap_mask
        # mechanics slot of the selected uncertain variable, or None
        self.uncertain_slot = uncertain_slot
        # (n,) index into the factor's variable list filling that slot
        self.gather_idx = gather_idx
        # ordered factor-variable indices feeding the mechanics residual
        self.mech_vars = mech_vars


def build_masks(mhidx: torch.Tensor, sfidx: int, nvars: int,
                multihypo: Optional[Tuple[float, ...]]) -> HypoMasks:
    """Turn per-particle hypothesis ids into solve/null masks and the
    uncertain-variable gather plan."""
    parsed = parse_multihypo(multihypo)
    null_mask = mhidx == 0
    if parsed is None:
        return HypoMasks(~null_mask, null_mask, torch.zeros_like(null_mask),
                         None, None, tuple(range(nvars)))
    certain, uncertain, _ = parsed
    if sfidx in certain:
        solve_mask = ~null_mask
        snap_mask = torch.zeros_like(null_mask)
        gather_idx = torch.clamp(mhidx - 1, min=0)
        uncertain_rep = min(uncertain)
    else:
        selected = mhidx == (sfidx + 1)
        solve_mask = selected
        snap_mask = (~null_mask) & (~selected)
        gather_idx = torch.full_like(mhidx, sfidx)
        uncertain_rep = sfidx
    mech_vars = tuple(sorted(certain + (uncertain_rep,)))
    uncertain_slot = mech_vars.index(uncertain_rep)
    return HypoMasks(solve_mask, null_mask, snap_mask, uncertain_slot,
                     gather_idx, mech_vars)

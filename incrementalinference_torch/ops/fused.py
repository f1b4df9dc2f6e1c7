"""Per-variable belief update and the whole-clique Gibbs chain.

Counterpart of ``incrementalinference/jl_tpu/ops/fused.py``.  One variable
update convolves every connected factor, selects each proposal's LOO
bandwidth, multiplies the proposals with the exact pair cascade and selects
the output bandwidth (reference doFMCIteration → propagateBelief →
manifoldProduct).  The JAX package traces this into one jitted program per
structure; here it is the same schedule run eagerly.  The clique chain runs
direct variables once and iterated variables ``gibbs_iters`` rounds, with
the same key layout as the JAX chain.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import keys as _keys
from ..beliefs import loo_bandwidth
from ..manifolds import Manifold
from .convolve import ConvSpec, eval_factor_core
from .product import _final_draw, _pair_stage

__all__ = ["product_traceable", "fused_variable_update",
           "fused_clique_gibbs"]


def product_traceable(manifold: Manifold, pts_list, bw_list,
                      static_masks: Tuple[Tuple[bool, ...], ...],
                      old_points: torch.Tensor, key: int, n_out: int):
    """Exact-cascade product with static per-proposal dim masks: dims no
    proposal constrains keep ``old_points``' values."""
    D = len(pts_list)
    if D == 1 and all(static_masks[0]):
        return pts_list[0][:n_out]

    dev = pts_list[0].device
    pooled = torch.cat(pts_list, dim=0)
    ref = manifold.mean(pooled)
    mus, precs = [], []
    for pts, bw, mask in zip(pts_list, bw_list, static_masks):
        t = manifold.log(ref[None, :], pts)
        m = torch.tensor(mask, device=dev)
        lam = torch.where(m, 1.0 / torch.clamp(bw ** 2, min=1e-12),
                          torch.zeros_like(bw))
        mus.append(t)
        precs.append(lam.expand(t.shape))

    ks = _keys.split(key, 2 * D + 1)
    mu, prec = mus[0], precs[0]
    if D == 1:
        idx = torch.randint(0, mu.shape[0], (n_out,),
                            generator=_keys.generator(ks[0], dev),
                            device=dev)
        mu, prec = mu[idx], prec[idx]
    for j in range(1, D):
        mu, prec = _pair_stage(mu, prec, mus[j], precs[j], ks[j], ks[D + j],
                               n_out)
    samples = _final_draw(mu, prec, ks[-1])

    any_mask = [any(m[d] for m in static_masks)
                for d in range(manifold.dof)]
    if not all(any_mask):
        old_t = manifold.log(ref[None, :], old_points[:n_out])
        keep = torch.tensor(any_mask, device=dev)
        samples = torch.where(keep[None, :], samples, old_t)
    return manifold.project(
        manifold.exp(ref.expand((n_out,) + ref.shape), samples))


def _factor_groups(specs, models, var_points_nested):
    """Same-structure factor groups (spec, model type, input shapes), in
    first-appearance order.  The JAX package evaluates a group as one
    vmapped program; every member keeps its own key either way, so the
    draws that feed each factor do not depend on the grouping."""
    groups: dict = {}
    for i, spec in enumerate(specs):
        gk = (spec, type(models[i]),
              tuple(tuple(a.shape) for a in var_points_nested[i]))
        groups.setdefault(gk, []).append(i)
    return list(groups.values())


def _make_update(manifold: Manifold, specs: Tuple[ConvSpec, ...],
                 masks: Tuple[Tuple[bool, ...], ...], n_out: int):
    def update(models, var_points_nested, old_points, key: int):
        F = len(specs)
        ks = _keys.split(key, F + 1)
        pts_list = [None] * F
        for idxs in _factor_groups(specs, models, var_points_nested):
            for i in idxs:
                pts_list[i] = eval_factor_core(manifold, models[i], ks[i],
                                               var_points_nested[i],
                                               specs[i])
        if F == 1 and all(masks[0]):
            # the single full proposal is the product: its bandwidth is
            # never read
            bw_list = [torch.ones((manifold.dof,), dtype=pts_list[0].dtype,
                                  device=pts_list[0].device)]
        elif len({tuple(p.shape) for p in pts_list}) == 1:
            bws = loo_bandwidth(manifold, torch.stack(pts_list))
            bw_list = list(bws)
        else:
            bw_list = [loo_bandwidth(manifold, p) for p in pts_list]
        out = product_traceable(manifold, pts_list, bw_list, masks,
                                old_points, ks[-1], n_out)
        return out, loo_bandwidth(manifold, out)

    return update


def fused_variable_update(manifold: Manifold, models, var_points_nested,
                          old_points: torch.Tensor, specs, masks, key: int,
                          n_out: int):
    """One variable update: returns (points, bw)."""
    return _make_update(manifold, tuple(specs), tuple(masks), n_out)(
        tuple(models), tuple(tuple(v) for v in var_points_nested),
        old_points, key)


def fused_clique_gibbs(direct_steps, iter_steps, n_rounds: int,
                       models_direct, models_iter, store, key: int):
    """A whole-clique Gibbs schedule over a clique-local points store.

    Steps are (target_local_idx, manifold, specs, masks, n_out,
    factor_var_idx).  Direct steps run once, iterated steps ``n_rounds``
    rounds.  Returns (store, direct bws aligned to direct_steps, iter bws
    aligned to iter_steps)."""
    store = list(store)

    def apply(step, models, k):
        li, manifold, specs, masks, n_out, fvidx = step
        nested = tuple(tuple(store[j] for j in idxs) for idxs in fvidx)
        pts, bw = _make_update(manifold, specs, masks, n_out)(
            models, nested, store[li], k)
        store[li] = pts
        return bw

    kd, ki0, kr = _keys.split(key, 3)
    dks = _keys.split(kd, max(1, len(direct_steps)))
    dbws = tuple(apply(step, models_direct[s], dks[s])
                 for s, step in enumerate(direct_steps))
    ibws: tuple = ()
    if iter_steps:
        round_keys = [ki0] + (_keys.split(kr, n_rounds - 1)
                              if n_rounds > 1 else [])
        for rk in round_keys:
            sks = _keys.split(rk, max(1, len(iter_steps)))
            bw_of = {}
            for s, step in enumerate(iter_steps):
                bw_of[step[0]] = apply(step, models_iter[s], sks[s])
            ibws = tuple(bw_of[step[0]] for step in iter_steps)
    return tuple(store), dbws, ibws

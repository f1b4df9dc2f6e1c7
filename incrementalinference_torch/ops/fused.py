"""Per-variable belief update, batched updates across same-level cliques
and the whole-clique Gibbs chain.

Counterpart of ``incrementalinference/jl_tpu/ops/fused.py``.  One variable
update convolves every connected factor, selects each proposal's LOO
bandwidth, multiplies the proposals with the exact pair cascade and selects
the output bandwidth (reference doFMCIteration → propagateBelief →
manifoldProduct).  The JAX package traces this into one jitted program per
structure and ``jax.vmap``s it over the isomorphic cliques of a level;
here the same schedule runs eagerly with the member axis written out
(:func:`_make_update_batched`): each member draws on its own key, the
per-particle solves of all members run as one pass, the bandwidth
selections as one batched call, and each product stage of the large-pair
path as one kernel launch.  The single update is the batch of one.  The
clique chain runs direct variables once and iterated variables
``gibbs_iters`` rounds, with the same key layout as the JAX chain.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import keys as _keys
from .. import tracing
from ..beliefs import loo_bandwidth
from ..manifolds import Manifold
from .convolve import ConvSpec, eval_factor_core_batched
from .product import _final_draw, _pair_stage, _resample

__all__ = ["fused_variable_update", "fused_clique_gibbs"]


@tracing.spanned("product", lambda manifold, pts_list, bw_list, static_masks,
                 old_points, keys, n_out: {"densities": len(pts_list),
                                           "members": len(keys), "N": n_out})
def _product_members(manifold, pts_list, bw_list, static_masks, old_points,
                     keys, n_out):
    D = len(pts_list)
    if D == 1 and all(static_masks[0]):
        return pts_list[0][:, :n_out]

    dev = pts_list[0].device
    B = len(keys)
    pooled = torch.cat(pts_list, dim=1)
    ref = manifold.mean(pooled)                               # (B, pd)
    mus, precs = [], []
    for pts, bw, mask in zip(pts_list, bw_list, static_masks):
        t = manifold.log(ref[:, None, :], pts)
        m = torch.tensor(mask, device=dev)
        lam = torch.where(m, 1.0 / torch.clamp(bw ** 2, min=1e-12),
                          torch.zeros_like(bw))
        mus.append(t)
        precs.append(lam[:, None, :].expand(t.shape))

    ks = [_keys.split(k, 2 * D + 1) for k in keys]
    mu, prec = mus[0], precs[0]
    if D == 1:
        mu, prec = _resample(mu, prec, [k[0] for k in ks], n_out)
    for j in range(1, D):
        mu, prec = _pair_stage(mu, prec, mus[j], precs[j],
                               [k[j] for k in ks], [k[D + j] for k in ks],
                               n_out)
    samples = _final_draw(mu, prec, [k[-1] for k in ks])

    any_mask = [any(m[d] for m in static_masks)
                for d in range(manifold.dof)]
    if not all(any_mask):
        old_t = manifold.log(ref[:, None, :], old_points[:, :n_out])
        keep = torch.tensor(any_mask, device=dev)
        samples = torch.where(keep, samples, old_t)
    return manifold.project(manifold.exp(
        ref[:, None, :].expand((B, n_out) + ref.shape[1:]), samples))


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


def _make_update_batched(manifold: Manifold, specs: Tuple[ConvSpec, ...],
                         masks: Tuple[Tuple[bool, ...], ...], n_out: int,
                         mesh=None):
    """The variable update over a leading member axis (the JAX package's
    ``jax.vmap`` of the update): ``models`` holds, per factor, the B
    members' models; ``var_points_nested`` per factor its variables'
    points (B, N, pd); ``old_points`` (B, N, pd); ``keys`` B ints.
    Returns (points (B, n_out, pd), bw (B, dof))."""
    @tracing.spanned("update", lambda models, var_points_nested, old_points,
                     keys: {"members": len(keys), "N": n_out,
                            "factors": len(specs)})
    def update(models, var_points_nested, old_points, keys):
        F = len(specs)
        ks = [_keys.split(k, F + 1) for k in keys]
        pts_list = [None] * F
        for idxs in _factor_groups(specs, [m[0] for m in models],
                                   var_points_nested):
            for i in idxs:
                pts_list[i] = eval_factor_core_batched(
                    manifold, models[i], [k[i] for k in ks],
                    var_points_nested[i], specs[i], mesh)
        if F == 1 and all(masks[0]):
            # the single full proposal is the product: its bandwidth is
            # never read
            bw_list = [torch.ones((len(keys), manifold.dof),
                                  dtype=pts_list[0].dtype,
                                  device=pts_list[0].device)]
        elif len({tuple(p.shape) for p in pts_list}) == 1:
            bws = loo_bandwidth(manifold, torch.stack(pts_list, dim=1))
            bw_list = list(bws.unbind(1))
        else:
            bw_list = [loo_bandwidth(manifold, p) for p in pts_list]
        out = _product_members(manifold, pts_list, bw_list, masks,
                               old_points, [k[-1] for k in ks], n_out)
        return out, loo_bandwidth(manifold, out)

    return update


def _make_update(manifold: Manifold, specs: Tuple[ConvSpec, ...],
                 masks: Tuple[Tuple[bool, ...], ...], n_out: int,
                 mesh=None):
    """The update of one variable: the batched update of one member."""
    batched = _make_update_batched(manifold, specs, masks, n_out, mesh)

    def update(models, var_points_nested, old_points, key: int):
        pts, bw = batched(tuple((m,) for m in models),
                          tuple(tuple(p[None] for p in v)
                                for v in var_points_nested),
                          old_points[None], [key])
        return pts[0], bw[0]

    return update


def fused_variable_update(manifold: Manifold, models, var_points_nested,
                          old_points: torch.Tensor, specs, masks, key: int,
                          n_out: int):
    """One variable update: returns (points, bw)."""
    return _make_update(manifold, tuple(specs), tuple(masks), n_out)(
        tuple(models), tuple(tuple(v) for v in var_points_nested),
        old_points, key)


@tracing.spanned("gibbs", lambda direct_steps, iter_steps, n_rounds, *a,
                 **k: {"rounds": n_rounds})
def fused_clique_gibbs(direct_steps, iter_steps, n_rounds: int,
                       models_direct, models_iter, store, key: int,
                       mesh=None):
    """A whole-clique Gibbs schedule over a clique-local points store.

    Steps are (target_local_idx, manifold, specs, masks, n_out,
    factor_var_idx).  Direct steps run once, iterated steps ``n_rounds``
    rounds.  Returns (store, direct bws aligned to direct_steps, iter bws
    aligned to iter_steps).  ``mesh`` splits each update's per-particle
    solves over the mesh's devices (ops/convolve.py)."""
    store = list(store)

    def apply(step, models, k):
        li, manifold, specs, masks, n_out, fvidx = step
        nested = tuple(tuple(store[j] for j in idxs) for idxs in fvidx)
        pts, bw = _make_update(manifold, specs, masks, n_out, mesh)(
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

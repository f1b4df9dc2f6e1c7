"""Chapman-Kolmogorov approximate convolution — batched Gauss-Newton.

Counterpart of ``incrementalinference/jl_tpu/ops/convolve.py``.  All N
particles solve at once: a damped Gauss-Newton in tangent coordinates with
Jacobians from ``torch.func.jacfwd`` under ``torch.func.vmap`` over the
particle axis.  Models that declare ``linear_residual`` take the
closed-form branch (one exact step); the rest run the Levenberg-Marquardt
accept/reject loop.  Entropy inflation is uniform tangent noise re-solved
``inflate_cycles`` times; multihypothesis partitions are masks
(ops/hypo.py).

:func:`eval_factor_core_batched` evaluates one factor for the B members of
a batched clique level: every draw is made on the member's own key, as it
would be alone, and the Gauss-Newton solve runs once over the B·N
particles, each particle reading its member's residual parameters.  With a
``mesh`` that solve is split over the mesh's devices along the particle
axis (the draws are made on the full N first) and gathered back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from .. import keys as _keys
from ..beliefs import Belief, loo_bandwidth, make_belief, spread_estimate
from ..manifolds import Manifold
from ..models.factors import residual_at, stackable_residual_params
from .hypo import build_masks, draw_hypotheses, parse_multihypo
from .product import Proposal

__all__ = ["batched_gauss_newton", "add_entropy", "ConvSpec",
           "make_conv_spec", "null_surplus_map", "static_dim_mask",
           "eval_factor_core", "eval_factor_core_batched", "eval_factor",
           "sample_factor",
           "approx_conv_belief", "proposal_from_factor"]


def _free_mask(dof: int, partial_dims, device) -> torch.Tensor:
    free = torch.zeros((dof,), dtype=torch.bool, device=device)
    if partial_dims is None:
        return ~free
    free[list(partial_dims)] = True
    return free


def batched_gauss_newton(manifold: Manifold, model, meas: torch.Tensor,
                         others: Tuple[torch.Tensor, ...], x0: torch.Tensor,
                         sf_slot: int, iters: int = 25,
                         damping: float = 1e-6,
                         partial_dims: Optional[Tuple[int, ...]] = None,
                         linear: bool = False,
                         params: Tuple[torch.Tensor, ...] = ()
                         ) -> torch.Tensor:
    """For every particle i, minimise ||residual(meas_i, ..., x, ...)||²
    over x in argument slot ``sf_slot``.

    meas (n, zdim); others: tuple of (n, point_dim_k); x0 (n, point_dim).
    ``params``: per-particle residual tensors (n, ...) read in place of the
    model's own (models/factors.py ``residual_at``), so that particles of
    several same-structure factors solve in one pass.
    ``linear``: one closed-form GN step (exact for affine residuals).
    Otherwise an LM loop: a step is kept only when finite and not worse;
    rejection raises the damping ×10 (≤ 1e8), acceptance lowers it ÷3
    (≥ ``damping``).  ``partial_dims`` pins all other tangent dims."""
    dof = manifold.dof
    dt, dev = x0.dtype, x0.device
    free = _free_mask(dof, partial_dims, dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    eye = torch.eye(dof, dtype=dt, device=dev)
    z = torch.zeros((x0.shape[0], dof), dtype=dt, device=dev)

    n_params = len(params)

    def res(X, x, meas_i, *rest):
        X = torch.where(free, X, zero)
        pts = list(rest[n_params:])
        pts.insert(sf_slot, manifold.exp(x, X))
        if n_params:
            return residual_at(model, rest[:n_params], meas_i, *pts)
        return model.residual(meas_i, *pts)

    jac = vmap(jacfwd(res, argnums=0))
    resv = vmap(res)
    others = tuple(params) + tuple(others)

    def gn_step(x, lam):
        r0 = resv(z, x, meas, *others)                       # (n, resdim)
        J = jac(z, x, meas, *others)                         # (n, res, dof)
        Jt = J.transpose(-1, -2)
        JtJ = Jt @ J + lam[:, None, None] * eye
        step = torch.linalg.solve(JtJ, (Jt @ r0[..., None]))[..., 0]
        step = torch.where(free, step, zero)
        return manifold.exp(x, -step), r0

    lam0 = torch.full((x0.shape[0],), damping, dtype=dt, device=dev)
    if linear:
        return gn_step(x0, lam0)[0]

    x, lam = x0, lam0
    for _ in range(iters):
        x_new, r0 = gn_step(x, lam)
        c0 = torch.sum(r0 * r0, dim=-1)
        r1 = resv(z, x_new, meas, *others)
        c1 = torch.sum(r1 * r1, dim=-1)
        ok = torch.isfinite(c1) & (c1 <= c0)
        x = torch.where(ok[:, None], x_new, x)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=damping),
                          torch.clamp(lam * 10.0, max=1e8))
    return x


def add_entropy(manifold: Manifold, points: torch.Tensor, key,
                spread, partial_dims: Optional[Tuple[int, ...]] = None):
    """Uniform tangent perturbation X_d ~ spread·U(-0.5, 0.5) (reference
    addEntropyOnManifold!).  With a sequence of keys, ``points`` is
    (B, n, point_dim) and ``spread`` (B,): member b draws from key b."""
    if isinstance(key, (list, tuple)):
        n = points.shape[1]
        spread = torch.as_tensor(spread, device=points.device)
        if spread.dim():
            spread = spread[:, None, None]
    else:
        n, key = points.shape[0], [key]
    dof = manifold.dof
    u = torch.stack([torch.rand((n, dof),
                                generator=_keys.generator(k, points.device),
                                device=points.device, dtype=points.dtype)
                     for k in key])
    if points.dim() == 2:
        u = u[0]
    noise = spread * (u - 0.5)
    if partial_dims is not None:
        noise = torch.where(_free_mask(dof, partial_dims, points.device),
                            noise, torch.zeros_like(noise))
    return manifold.exp(points, noise)


def _overlay_partial(manifold: Manifold, base: torch.Tensor,
                     sampled: torch.Tensor,
                     partial_dims: Tuple[int, ...]) -> torch.Tensor:
    """Overlay sampled coords onto ``partial_dims`` of existing points.
    Point coordinates are written by tangent index, so this is valid on
    coordinate manifolds only (Euclidean, Circle: ``point_dim == dof``), as
    in the JAX package and the reference's setPointPartial!."""
    out = base.clone()
    out[:, list(partial_dims)] = sampled[:, :len(partial_dims)]
    return out


class ConvSpec:
    """Static (hashable) convolution plan for one factor ⊗ solve target."""

    def __init__(self, is_prior, sfidx, nvars, partial_dims, multihypo,
                 nullhypo, iters, cycles, inflation, spread_nh, damping,
                 linear=False):
        self.is_prior = is_prior
        self.sfidx = sfidx
        self.nvars = nvars
        self.partial_dims = partial_dims
        self.multihypo = multihypo
        self.nullhypo = float(nullhypo)
        self.iters = iters
        self.cycles = cycles
        self.inflation = float(inflation)
        self.spread_nh = float(spread_nh)
        self.damping = float(damping)
        self.linear = bool(linear)

    def _key(self):
        return (self.is_prior, self.sfidx, self.nvars, self.partial_dims,
                self.multihypo, self.nullhypo, self.iters, self.cycles,
                self.inflation, self.spread_nh, self.damping, self.linear)

    def __eq__(self, other):
        return isinstance(other, ConvSpec) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def make_conv_spec(fg, factor, solvefor: str, inflate: bool = True,
                   null_surplus: float = 0.0) -> ConvSpec:
    """The plan the JAX package builds: a fully constrained linear relative
    solves in closed form from any start, so its inflate/re-solve cycles
    collapse to one cycle without entropy (same particles)."""
    params = fg.params
    model = factor.model
    linear = getattr(model, "linear_residual", False)
    quasi = getattr(model, "quasi_linear_residual", False)
    nullhypo = max(factor.nullhypo, float(null_surplus))
    closed_form = (linear and not factor.is_prior
                   and factor.multihypo is None and nullhypo == 0.0
                   and getattr(model, "partial", None) is None)
    return ConvSpec(
        is_prior=factor.is_prior,
        sfidx=factor.variables.index(solvefor),
        nvars=len(factor.variables),
        partial_dims=getattr(model, "partial", None),
        multihypo=factor.multihypo,
        nullhypo=nullhypo,
        iters=3 if linear else (8 if quasi else params.conv_iters),
        cycles=1 if closed_form else
        (params.inflate_cycles if inflate else 1),
        inflation=0.0 if closed_form else
        (params.inflation if inflate else 0.0),
        spread_nh=params.spread_nh,
        damping=params.conv_damping,
        linear=linear,
    )


def null_surplus_map(params, factors) -> dict:
    """Per-factor nullSurplus boost at one proposal target: when any factor
    there is multihypo, every relative non-multihypo sibling proposes with
    ``nullhypo >= params.null_surplus_add``."""
    if not any(f.is_multihypo for f in factors):
        return {f.label: 0.0 for f in factors}
    return {f.label: (params.null_surplus_add
                      if (not f.is_prior and not f.is_multihypo) else 0.0)
            for f in factors}


def static_dim_mask(manifold: Manifold, partial_dims) -> Tuple[bool, ...]:
    if partial_dims is None:
        return tuple([True] * manifold.dof)
    return tuple(i in set(partial_dims) for i in range(manifold.dof))


def eval_factor_core(manifold: Manifold, model, key: int,
                     var_points: Tuple[torch.Tensor, ...],
                     spec: ConvSpec, mesh=None) -> torch.Tensor:
    """Proposal particles for the solve target (reference evalFactor →
    evalPotentialSpecific); ``var_points`` share one particle count."""
    return eval_factor_core_batched(
        manifold, (model,), (key,), tuple(p[None] for p in var_points),
        spec, mesh)[0]


def _member_residuals(models, n: int, device):
    """(model, per-particle residual tensors) for one Gauss-Newton pass
    over the particles of every member (n each), or None when the members'
    residuals cannot be stacked (then each member solves alone)."""
    m0 = models[0]
    if all(m is m0 for m in models):
        return m0, ()
    try:
        per = [stackable_residual_params(m, device) for m in models]
    except NotImplementedError:
        return None
    if not per[0]:
        return m0, ()
    return m0, tuple(torch.repeat_interleave(torch.stack(c), n, dim=0)
                     for c in zip(*per))


def _solve_particles(manifold, models, meas, others, x0, sf_slot,
                     spec: ConvSpec, mesh) -> torch.Tensor:
    """The Gauss-Newton solve of every member's particles, member-major
    (B·n rows); with a mesh, split along the particle axis over its
    devices (when the rows divide evenly) and gathered back."""
    kw = dict(iters=spec.iters, damping=spec.damping,
              partial_dims=spec.partial_dims, linear=spec.linear)
    rows = x0.shape[0]
    n = rows // len(models)
    plan = _member_residuals(models, n, x0.device)
    if plan is None:
        return torch.cat([_solve_particles(
            manifold, (m,), meas[b * n:(b + 1) * n],
            tuple(o[b * n:(b + 1) * n] for o in others),
            x0[b * n:(b + 1) * n], sf_slot, spec, mesh)
            for b, m in enumerate(models)])
    model, params = plan
    devices = list(mesh.devices) if mesh is not None else []
    if len(devices) < 2 or rows % len(devices):
        return batched_gauss_newton(manifold, model, meas, others, x0,
                                    sf_slot, params=params, **kw)
    per = rows // len(devices)
    parts = []
    for c, dev in enumerate(devices):
        def part(t, c=c, dev=dev):
            return t[c * per:(c + 1) * per].to(dev)
        parts.append(batched_gauss_newton(
            manifold, model, part(meas), tuple(part(o) for o in others),
            part(x0), sf_slot, params=tuple(part(p) for p in params), **kw))
    return torch.cat([p.to(x0.device) for p in parts])


def eval_factor_core_batched(manifold: Manifold, models, keys,
                             var_points: Tuple[torch.Tensor, ...],
                             spec: ConvSpec, mesh=None) -> torch.Tensor:
    """Proposal particles (B, N, point_dim) for the B members of a batched
    level: ``models`` and ``keys`` hold each member's factor model and key,
    ``var_points`` each (B, N, point_dim).  Every draw is made on the
    member's key exactly as :func:`eval_factor_core` makes it for that
    member alone; the per-particle solve runs once over all B·N
    particles."""
    partial_dims = spec.partial_dims
    sfidx, nvars = spec.sfidx, spec.nvars
    x_cur = var_points[sfidx]
    B, maxlen = x_cur.shape[:2]
    dev = x_cur.device
    ks = [_keys.split(k, 4) for k in keys]      # hypo, meas, null, inflate
    null_keys = [k[2] for k in ks]

    def flat(t):
        return t.reshape((B * maxlen,) + t.shape[2:])

    def unflat(t):
        return t.reshape((B, maxlen) + t.shape[1:])

    def hypotheses():
        return torch.cat([draw_hypotheses(k[0], maxlen, nvars,
                                          spec.multihypo, spec.nullhypo,
                                          dev) for k in ks])

    if spec.is_prior:
        pts = torch.stack([m.sample_points(_keys.generator(k[1], dev),
                                           maxlen, manifold)
                           for m, k in zip(models, ks)])
        if partial_dims is not None:
            pts = unflat(_overlay_partial(manifold, flat(x_cur), flat(pts),
                                          partial_dims))
        if spec.nullhypo > 0.0:
            mh = hypotheses()
            spread = spec.spread_nh * spread_estimate(manifold, x_cur, x_cur)
            nulled = add_entropy(manifold, x_cur, null_keys, spread,
                                 partial_dims)
            pts = unflat(torch.where((mh == 0)[:, None], flat(nulled),
                                     flat(pts)))
        return pts

    mhidx = hypotheses()
    masks = build_masks(mhidx, sfidx, nvars, spec.multihypo)
    meas = torch.cat([m.sample(_keys.generator(k[1], dev), maxlen)
                      for m, k in zip(models, ks)])
    vp = [flat(p) for p in var_points]

    if masks.uncertain_slot is None:
        others = tuple(vp[i] for i in range(nvars) if i != sfidx)
        sf_slot = sfidx
    else:
        # the selected hypothesis variable per particle fills the uncertain
        # slot; only uncertain candidates stack (they share a manifold)
        _, uncertain, _ = parse_multihypo(spec.multihypo)
        cand = torch.stack([vp[i] for i in uncertain])
        lookup = [0] * nvars
        for pos, i in enumerate(uncertain):
            lookup[i] = pos
        gidx = torch.tensor(lookup, device=dev)[masks.gather_idx]
        gathered = cand[gidx, torch.arange(B * maxlen, device=dev)]
        mech_points = []
        for slot, fvidx in enumerate(masks.mech_vars):
            if slot == masks.uncertain_slot and fvidx != sfidx:
                mech_points.append(gathered)
            else:
                mech_points.append(vp[fvidx])
        sf_slot = masks.mech_vars.index(sfidx)
        others = tuple(p for i, p in enumerate(mech_points) if i != sf_slot)

    other_cloud = x_cur
    if others and others[0].shape[-1] == x_cur.shape[-1]:
        other_cloud = unflat(others[0])
    base_spread = spread_estimate(manifold, x_cur, other_cloud)   # (B,)

    x, kc = vp[sfidx], [k[3] for k in ks]
    for _ in range(spec.cycles):
        pairs = [_keys.split(k, 2) for k in kc]
        kc = [p[0] for p in pairs]
        if spec.inflation > 0.0:
            x = flat(add_entropy(manifold, unflat(x), [p[1] for p in pairs],
                                 spec.inflation * base_spread, partial_dims))
        solved = _solve_particles(manifold, models, meas, others, x,
                                  sf_slot, spec, mesh)
        x = torch.where(masks.solve_mask[:, None], solved, x)

    if spec.nullhypo > 0.0 or spec.multihypo is not None:
        inactive = masks.null_mask | masks.snap_mask
        nulled = add_entropy(manifold, x_cur, null_keys,
                             spec.spread_nh * base_spread, partial_dims)
        x = torch.where(inactive[:, None], flat(nulled), x)
    return unflat(x)


def _tile_to(p: torch.Tensor, maxlen: int) -> torch.Tensor:
    if p.shape[0] == maxlen:
        return p
    if p.shape[0] < maxlen:
        reps = -(-maxlen // p.shape[0])
        return p.repeat(reps, 1)[:maxlen]
    return p[:maxlen]


def eval_factor(fg, factor, solvefor: str, key: int | None = None,
                solve_key: str = "default", n: int | None = None,
                inflate: bool = True):
    """Proposal particles for ``solvefor`` through ``factor`` (reference
    evalFactor).  Returns (points (n, point_dim), dim_mask (dof,) bool)."""
    if isinstance(factor, str):
        factor = fg.factor(factor)
    manifold = fg.var(solvefor).manifold
    key = key if key is not None else fg.next_key()
    var_points = [fg.points(lbl, solve_key) for lbl in factor.variables]
    maxlen = max([n or fg.params.N] + [p.shape[0] for p in var_points])
    var_points = tuple(_tile_to(p, maxlen) for p in var_points)
    spec = make_conv_spec(fg, factor, solvefor, inflate=inflate)
    pts = eval_factor_core(manifold, factor.model, key, var_points, spec)
    dim_mask = torch.tensor(static_dim_mask(manifold, spec.partial_dims),
                            device=pts.device)
    return pts, dim_mask


def sample_factor(fg, factor, n: int | None = None,
                  key: int | None = None) -> torch.Tensor:
    """``n`` fresh measurement rows ``(n, zdim)`` from a factor's
    measurement model (reference sampleFactor)."""
    if isinstance(factor, str):
        factor = fg.factor(factor)
    key = key if key is not None else fg.next_key()
    return factor.model.sample(_keys.generator(key, fg.device),
                               int(n or fg.params.N))


def approx_conv_belief(fg, factor_label: str, target: str,
                       key: int | None = None, solve_key: str = "default",
                       n: int | None = None) -> Belief:
    """Factor → target belief (reference approxConvBelief); a partial
    factor's belief has zero infoPerCoord on the dims it leaves alone."""
    pts, dim_mask = eval_factor(fg, factor_label, target, key=key,
                                solve_key=solve_key, n=n)
    return make_belief(fg.var(target).manifold, pts,
                       ipc=dim_mask.to(pts.dtype))


def proposal_from_factor(fg, factor, target: str, key: int | None = None,
                         solve_key: str = "default",
                         n: int | None = None) -> Proposal:
    """Proposal for the belief-product stage (reference
    calcProposalBelief)."""
    pts, dim_mask = eval_factor(fg, factor, target, key=key,
                                solve_key=solve_key, n=n)
    return Proposal(pts, loo_bandwidth(fg.var(target).manifold, pts),
                    dim_mask)

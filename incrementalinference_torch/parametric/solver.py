"""Batch parametric solver: Levenberg-Marquardt over tangent coordinates.

Counterpart of ``incrementalinference/jl_tpu/parametric/solver.py``
(reference ParametricUtils.jl solveGraphParametric!, ParametricManopt.jl
solve_RLM).  The variables of a (sub)graph flatten into one tangent vector
at per-variable linearization points, grouped by manifold type in
first-seen order.  Factors of one structure stack into a group: their
whitened residuals and local Jacobians come from one
``torch.func.vmap(jacrev(..., has_aux=True))`` over the group's factors,
and the Jacobian's columns are placed by index.  A Levenberg-Marquardt loop
moves the tangent vector, solving the dense normal equations or, with
``solver="cg"``, conjugate gradients on jvp/vjp products; the covariance is
(JᵀJ)⁻¹, from a QR factor of J (reference ParametricManopt.jl:360-374).

Sizes are exact: no padding, no one-hot gathers.  Frozen variables enter
the normal equations through the free mask m as ``H' = mmᵀ⊙H + diag(1−m)``,
``g' = m⊙g``.  The loop is a Python loop that reads one device value an
iteration, its stopping test.  Problems of one structure solve as one batch
(``solve_problems_batched``), each member iterating until its own stopping
test holds, so each gets the result it would get alone.

Max-mixture factors contribute their best component's residual, chosen per
evaluation; multihypo factors pick the best candidate for their uncertain
slot before linearizing; nullhypo factors drop out of an iteration when the
null alternative is likelier (the reference's MaxMixture.jl, MaxMultihypo
and MaxNullhypo).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import jacrev, vmap

from ..beliefs import mean_cov as belief_mean_cov
from ..config import full_precision
from ..graph import FactorGraph
from ..models.factors import (GenericMarginal, MetaPrior, Mixture,
                              residual_at, stackable_residual_params)
from ..ops.hypo import parse_multihypo

__all__ = ["ParametricProblem", "solve_graph_parametric",
           "solve_conditionals_parametric", "autoinit_parametric",
           "init_parametric_from", "solve_problems_batched"]


def _sqrt_inv(cov: torch.Tensor) -> torch.Tensor:
    """Whitening W with WᵀW = Σ⁻¹ (the inverse Cholesky factor), batched
    over leading dimensions."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return torch.linalg.inv(torch.linalg.cholesky(cov + 1e-10 * eye))


def _stack(xs, device) -> torch.Tensor:
    """Host arrays stack on the host and go up in one copy."""
    if all(isinstance(x, np.ndarray) for x in xs):
        return torch.as_tensor(np.stack(xs), dtype=torch.float32,
                               device=device)
    return torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                        device=device) for x in xs])


# -- what a factor group stacks ----------------------------------------------

def _structure(model) -> tuple:
    """The non-tensor attributes the factors of one group share."""
    if isinstance(model, Mixture):
        return (Mixture, len(model.components), model.zdim,
                _structure(model.mechanics))
    return (type(model), getattr(model, "manifold", None),
            getattr(model, "partial", None),
            getattr(model, "manifolds", None), model.zdim)


class _Group:
    """Factors of one structure, their tensors stacked on a leading factor
    axis; in a batch of problems, the factors of every member one after
    the other (``brow`` holds each row's member)."""

    def __init__(self, key, model, params, meas, sqrt_inv, slots, brow,
                 arg_types, arg_manifolds, mix=None, hyp=None, null_p=None):
        self.key = key                  # structure, arity, multihypo, args
        self.model = model              # the first factor's (structure)
        self.params = params            # tuple of (F, ...) residual tensors
        self.meas = meas                # (F, z)
        self.sqrt_inv = sqrt_inv        # (F, z, z)
        self.slots = slots              # (F, arity) index within arg's type
        self.brow = brow                # (F,) member of each row
        self.arg_types = arg_types      # per arg: manifold-type index
        self.arg_manifolds = arg_manifolds
        self.mix = mix                  # (w (F,C), mus (F,C,z), sqi (F,C,z,z))
        self.hyp = hyp                  # (w (F,H), slots (F,H), upos)
        self.null_p = null_p            # (F,) or None where no factor has one


def _cat_groups(gs: List[_Group]) -> _Group:
    """One member's groups after another's, as one group of the batch."""
    if len(gs) == 1:
        return gs[0]

    def cat(xs):
        if isinstance(xs[0], tuple):
            return tuple(cat(list(c)) for c in zip(*xs))
        return torch.cat(xs)

    g0 = gs[0]
    brow = torch.cat([torch.full_like(g.brow, b) for b, g in enumerate(gs)])
    null = [g.null_p for g in gs]
    if all(p is None for p in null):
        null_p = None
    else:
        null_p = torch.cat([torch.zeros_like(g.brow, dtype=g.meas.dtype)
                            if g.null_p is None else g.null_p for g in gs])
    hyp = None if g0.hyp is None else (
        cat([g.hyp[0] for g in gs]), cat([g.hyp[1] for g in gs]), g0.hyp[2])
    return _Group(g0.key, g0.model, cat([g.params for g in gs]),
                  cat([g.meas for g in gs]), cat([g.sqrt_inv for g in gs]),
                  cat([g.slots for g in gs]), brow, g0.arg_types,
                  g0.arg_manifolds,
                  None if g0.mix is None else cat([g.mix for g in gs]),
                  hyp, null_p)


class ParametricProblem:
    """A (sub)graph as a tangent-space nonlinear least-squares problem.

    Variables are ordered by manifold type (first-seen order of the types,
    graph order within a type); ``offsets[i]`` is variable i's first
    tangent coordinate.  Linearization points: the parametric point, else
    the belief's mean, else the identity."""

    def __init__(self, fg: FactorGraph,
                 variables: Optional[Sequence[str]] = None,
                 factors: Optional[Sequence[str]] = None,
                 frozen: Sequence[str] = ()):
        self.fg = fg
        dev = fg.device
        labels = list(variables or fg.ls())
        by_man: Dict = {}
        for v in labels:
            by_man.setdefault(fg.var(v).manifold, []).append(v)

        # (manifold, count, first tangent coordinate) per manifold type
        self.type_groups: List[tuple] = []
        self.var_labels: List[str] = []
        self._type_of: Dict[str, int] = {}
        self._idx_in_type: Dict[str, int] = {}
        base = 0
        for t, (man, vs) in enumerate(by_man.items()):
            self.type_groups.append((man, len(vs), base))
            for j, v in enumerate(vs):
                self._type_of[v] = t
                self._idx_in_type[v] = j
                self.var_labels.append(v)
            base += len(vs) * man.dof
        self.total_dof = base
        self.manifolds = [fg.var(v).manifold for v in self.var_labels]
        self.dofs = [m.dof for m in self.manifolds]
        self.offsets = np.asarray(
            [self.type_groups[self._type_of[v]][2]
             + self._idx_in_type[v] * m.dof
             for v, m in zip(self.var_labels, self.manifolds)] + [base])
        self.slot = {v: i for i, v in enumerate(self.var_labels)}

        mask = np.zeros(base, np.float32)
        frozen = set(frozen)
        for i, v in enumerate(self.var_labels):
            if v not in frozen:
                mask[self.offsets[i]:self.offsets[i] + self.dofs[i]] = 1.0
        self.free_mask = torch.as_tensor(mask, device=dev)

        self.p0: List[torch.Tensor] = []
        for v, m in zip(self.var_labels, self.manifolds):
            var = fg.var(v)
            if var.parametric_point is not None:
                p = torch.as_tensor(var.parametric_point,
                                    dtype=torch.float32, device=dev)
            elif var.is_initialized():
                p = m.mean(var.belief().points)
            else:
                p = m.identity(dev)
            self.p0.append(p)
        self.groups = self._build_groups(factors)
        self.n_residuals = sum(g.meas.shape[0] * g.meas.shape[1]
                               for g in self.groups)

    # -- factor groups ------------------------------------------------------
    def _build_groups(self, factors) -> List[_Group]:
        buckets: Dict[tuple, list] = {}
        for fl in (factors if factors is not None else self.fg.lsf()):
            f = self.fg.factor(fl)
            if isinstance(f.model, (MetaPrior, GenericMarginal)) \
                    or f.solvable <= 0 \
                    or any(v not in self.slot for v in f.variables):
                continue
            mh = parse_multihypo(f.multihypo)
            if mh is not None and isinstance(f.model, Mixture):
                raise NotImplementedError(
                    "parametric Mixture+multihypo on one factor: use the "
                    "nonparametric solver (the reference's parametric "
                    "multihypo is likewise unimplemented, MaxMixture.jl)")
            if mh is None:
                mh_key, argvars = None, list(f.variables)
            else:
                # condensed arguments: the certain variables in order and
                # ONE uncertain slot (candidates contiguous, one manifold;
                # reference parseusermultihypo, FactorGraph.jl:634-654)
                certain, uncertain, weights = mh
                if uncertain != tuple(range(uncertain[0],
                                            uncertain[0] + len(uncertain))):
                    raise ValueError("multihypo candidates must be contiguous")
                if len({self.manifolds[self.slot[f.variables[i]]]
                        for i in uncertain}) != 1:
                    raise ValueError("multihypo candidates must share a "
                                     "manifold")
                cond = [i for i in certain if i < uncertain[0]] \
                    + [uncertain[0]] \
                    + [i for i in certain if i > uncertain[-1]]
                mh_key = (len(uncertain), cond.index(uncertain[0]), weights)
                argvars = [f.variables[i] for i in cond]
            argman = tuple(self.manifolds[self.slot[v]] for v in argvars)
            key = (_structure(f.model), len(f.variables), mh_key, argman)
            buckets.setdefault(key, []).append((f, argvars, mh))
        return [self._stack_group(key, items)
                for key, items in buckets.items()]

    def _stack_group(self, key, items) -> _Group:
        dev = self.fg.device
        fs = [f for f, _, _ in items]
        model = fs[0].model

        def idx(rows):
            return torch.as_tensor(np.asarray(rows, np.int64), device=dev)

        slots = idx([[self._idx_in_type[v] for v in av] for _, av, _ in items])
        per_factor = [stackable_residual_params(f.model, dev) for f in fs]
        params = tuple(torch.stack(c) for c in zip(*per_factor))
        mix = None
        if isinstance(model, Mixture):
            ws, mus, covs = zip(*(f.model.mixture_mean_cov() for f in fs))
            mix = (_stack(ws, dev), _stack(mus, dev),
                   _sqrt_inv(_stack(covs, dev)))
            # meas/sqrt_inv only give the group its shape here
            meas, sqi = mix[1][:, 0], mix[2][:, 0]
        else:
            mus, covs = zip(*(f.model.mean_cov() for f in fs))
            meas, sqi = _stack(mus, dev), _sqrt_inv(_stack(covs, dev))
        hyp = None
        if key[2] is not None:
            w = [mh[2] for _, _, mh in items]
            cand = [[self._idx_in_type[f.variables[i]] for i in mh[1]]
                    for f, _, mh in items]
            hyp = (torch.as_tensor(np.asarray(w, np.float32), device=dev),
                   idx(cand), key[2][1])
        null = [f.nullhypo for f in fs]
        null_p = (torch.as_tensor(np.asarray(null, np.float32), device=dev)
                  if any(p > 0 for p in null) else None)
        argvars0 = items[0][1]
        return _Group(key, model, params, meas, sqi, slots,
                      torch.zeros(len(fs), dtype=torch.int64, device=dev),
                      tuple(self._type_of[v] for v in argvars0),
                      tuple(self.manifolds[self.slot[v]] for v in argvars0),
                      mix, hyp, null_p)

    # -- layout -------------------------------------------------------------
    def _real_layout(self) -> tuple:
        return tuple((self._type_of[v], self._idx_in_type[v])
                     for v in self.var_labels)

    def signature(self) -> tuple:
        """Problems with equal signatures solve as one batch."""
        return (tuple((man, n) for man, n, _ in self.type_groups),
                self._real_layout(),
                tuple((g.key, g.meas.shape[0]) for g in self.groups))

    def p0_stacked(self) -> List[torch.Tensor]:
        """Linearization points per manifold type, (count_t, point_dim_t)."""
        return [torch.stack([self.p0[self.slot[v]] for v in self.var_labels
                             if self._type_of[v] == t])
                for t in range(len(self.type_groups))]

    def points_of(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [m.exp(p, x[s:s + m.dof])
                for m, p, s in zip(self.manifolds, self.p0, self.offsets)]

    # -- one problem's residuals --------------------------------------------
    def residuals(self, x: torch.Tensor, p0s=None) -> torch.Tensor:
        """Stacked whitened residuals (R,) at tangent coordinates x (D,)."""
        bt = _Batch([self])
        return bt.residuals(x[None], bt.p0s if p0s is None
                            else [p[None] for p in p0s])[0]

    def res_jac(self, x: torch.Tensor, p0s=None):
        """(r (R,), J (R, D)) at tangent coordinates x (D,)."""
        bt = _Batch([self])
        r, J = bt.res_jac(x[None], bt.p0s if p0s is None
                          else [p[None] for p in p0s])
        return r[0], J[0]

    # -- LM solve -----------------------------------------------------------
    def solve(self, x0: Optional[torch.Tensor] = None, max_iters: int = 50,
              relinearize: int = 2, lam0: float = 1e-4, tol: float = 1e-8,
              compute_cov: bool = True, solver: str = "dense"):
        """``relinearize`` rounds of LM from the tangent origin, each ending
        in a retraction of the linearization points.  Returns (points,
        covariance or None, cost).

        ``solver="dense"`` assembles H = JᵀJ; ``"cg"`` solves each LM step
        (JᵀJ + λI)s = Jᵀr by conjugate gradients on jvp/vjp products of the
        stacked residual, never forming J or H (pair it with
        ``compute_cov=False``: the covariance is itself dense)."""
        return _solve_batch([self], None if x0 is None else x0[None],
                            max_iters, relinearize, lam0, tol, compute_cov,
                            solver)[0]


class _Batch:
    """B problems of one signature as stacked tensors: tangent coordinates
    (B, D), linearization points per manifold type (B, count_t,
    point_dim_t), and each group's factors of all members."""

    def __init__(self, probs: Sequence[ParametricProblem]):
        p = probs[0]
        self.B = len(probs)
        self.D = p.total_dof
        self.types = p.type_groups
        self.free = torch.stack([q.free_mask for q in probs])
        self.groups = [_cat_groups([q.groups[i] for q in probs])
                       for i in range(len(p.groups))]
        stacks = [q.p0_stacked() for q in probs]
        self.p0s = [torch.stack([s[t] for s in stacks])
                    for t in range(len(self.types))]

    def _gather(self, g: _Group, slots, x, p0s):
        """Per argument, the linearization points (F, point_dim) of the
        group's variables; and their tangent coordinates (F, local dof)."""
        bases, xls = [], []
        for k, t in enumerate(g.arg_types):
            man, n, tbase = self.types[t]
            rows = g.brow * n + slots[:, k]
            bases.append(p0s[t].reshape(self.B * n, -1)[rows])
            xls.append(x[:, tbase:tbase + n * man.dof]
                       .reshape(self.B * n, man.dof)[rows])
        return bases, torch.cat(xls, dim=-1)

    def _eval(self, g: _Group, slots, x, p0s, with_jac: bool):
        """Whitened residuals (F, z) and, with ``with_jac``, local Jacobians
        (F, z, local dof) of the group's factors at ``slots``."""
        bases, xl = self._gather(g, slots, x, p0s)
        model, mans = g.model, g.arg_manifolds

        def points(xl_f, base_f):
            pts, o = [], 0
            for man, b in zip(mans, base_f):
                pts.append(man.exp(b, xl_f[o:o + man.dof]))
                o += man.dof
            return pts

        if g.mix is None:
            def res(xl_f, params, meas, sqi, *base_f):
                r = sqi @ residual_at(model, params, meas,
                                    *points(xl_f, base_f))
                return r, r
            args = (g.params, g.meas, g.sqrt_inv)
        else:
            def res(xl_f, params, w, mus, sqis, *base_f):
                pts = points(xl_f, base_f)

                def comp(mu, sqi):
                    return sqi @ residual_at(model, params, mu, *pts)

                rs = vmap(comp)(mus, sqis)                        # (C, z)
                score = 0.5 * torch.sum(rs * rs, dim=-1) \
                    - torch.log(torch.clamp(w, min=1e-30))
                # the best component as a one-hot sum, which vmap batches
                pick = (torch.arange(rs.shape[0], device=rs.device)
                        == torch.argmin(score)).to(rs.dtype)
                r = torch.sum(pick[:, None] * rs, dim=0)
                return r, r
            args = (g.params, *g.mix)
        if with_jac:
            J, r = vmap(jacrev(res, has_aux=True))(xl, *args, *bases)
            return r, J
        return vmap(res)(xl, *args, *bases)[0]

    def _select_hypo_slots(self, g: _Group, x, p0s):
        """Max-multihypo association: score every candidate for the
        uncertain slot by its whitened residual less its log-weight, and
        take the best per factor before linearizing."""
        w, cand, upos = g.hyp
        scores = []
        for h in range(cand.shape[1]):
            s_h = torch.cat([g.slots[:, :upos], cand[:, h:h + 1],
                             g.slots[:, upos + 1:]], dim=1)
            r_h = self._eval(g, s_h, x, p0s, with_jac=False)
            scores.append(0.5 * torch.sum(r_h * r_h, dim=-1)
                          - torch.log(torch.clamp(w[:, h], min=1e-30)))
        sel = torch.argmin(torch.stack(scores, dim=1), dim=1)
        return torch.cat([g.slots[:, :upos], cand.gather(1, sel[:, None]),
                          g.slots[:, upos + 1:]], dim=1)

    def _group_res(self, g: _Group, x, p0s, with_jac: bool):
        slots = g.slots if g.hyp is None else self._select_hypo_slots(
            g, x, p0s)
        out = self._eval(g, slots, x, p0s, with_jac)
        if g.null_p is None:
            return out, slots
        # max-nullhypo gate: the null alternative has likelihood p against
        # the factor's (1-p) N(r; 0, I); where it wins the factor gives
        # nothing this evaluation
        r = out[0] if with_jac else out
        p = g.null_p
        thresh = torch.log(torch.clamp(1.0 - p, min=1e-9)) \
            - torch.log(torch.clamp(p, min=1e-30))
        keep = ((p <= 0.0) | (0.5 * torch.sum(r * r, dim=-1) <= thresh)
                ).to(r.dtype)
        if with_jac:
            return (r * keep[:, None], out[1] * keep[:, None, None]), slots
        return r * keep[:, None], slots

    def residuals(self, x, p0s) -> torch.Tensor:
        """(B, R) whitened residuals."""
        rs = [self._group_res(g, x, p0s, False)[0].reshape(self.B, -1)
              for g in self.groups]
        if not rs:
            return x.new_zeros((self.B, 0))
        return torch.cat(rs, dim=1)

    def res_jac(self, x, p0s):
        """(B, R) residuals and (B, R, D) Jacobians, columns placed from
        each group's local Jacobians by index."""
        rs, Js = [], []
        for g in self.groups:
            (r, J), slots = self._group_res(g, x, p0s, True)
            F, z = r.shape
            Jg = J.new_zeros((F, z, self.D))
            o = 0
            for k, t in enumerate(g.arg_types):
                man, _, tbase = self.types[t]
                d = man.dof
                cols = tbase + slots[:, k:k + 1] * d \
                    + torch.arange(d, device=J.device)
                Jg.scatter_add_(2, cols[:, None, :].expand(F, z, d),
                                J[:, :, o:o + d])
                o += d
            rs.append(r.reshape(self.B, -1))
            Js.append(Jg.reshape(self.B, -1, self.D))
        if not rs:
            return x.new_zeros((self.B, 0)), x.new_zeros((self.B, 0, self.D))
        return torch.cat(rs, dim=1), torch.cat(Js, dim=1)

    def cost(self, x, p0s) -> torch.Tensor:
        r = self.residuals(x, p0s)
        return 0.5 * torch.sum(r * r, dim=-1)

    def retract(self, x, p0s) -> List[torch.Tensor]:
        out = []
        for (man, n, tbase), p in zip(self.types, p0s):
            out.append(man.exp(p, x[:, tbase:tbase + n * man.dof]
                               .reshape(self.B, n, man.dof)))
        return out

    def cov(self, p0s) -> torch.Tensor:
        """(B, D, D) covariance (H + 1e-8 I)⁻¹, H = mmᵀ⊙JᵀJ + diag(1−m), at
        the linearization points; frozen rows and columns are zero.

        The JAX package inverts H itself.  Here H = AᵀA for the rows
        A = [J·m; diag(1−m); 1e-4 I], and A = QR gives H⁻¹ = R⁻¹R⁻ᵀ: the
        same matrix, from a factor whose condition number is the square
        root of H's, and symmetric positive semidefinite by construction.
        In float32 it matters: the 200-pose SE(3) chain's H has condition
        number ~3e8, beyond float32, and inverting it leaves most 6 x 6
        marginal blocks indefinite."""
        _, J = self.res_jac(self.free.new_zeros((self.B, self.D)), p0s)
        m = self.free
        eye = torch.eye(self.D, dtype=J.dtype, device=J.device)
        A = torch.cat([J * m[:, None, :], torch.diag_embed(1.0 - m),
                       1e-4 * eye.expand(self.B, -1, -1)], dim=1)
        R = torch.linalg.qr(A, mode="r")[1]
        Rinv = torch.linalg.solve_triangular(
            R, eye.expand(self.B, -1, -1), upper=True)
        return (Rinv @ Rinv.transpose(1, 2)) * (m[:, :, None]
                                                 * m[:, None, :])


def _lm(bt: _Batch, x, p0s, max_iters: int, lam0: float, tol: float,
        step_fn):
    """Levenberg-Marquardt with multiplicative damping (×0.3 on a better
    cost, ×8 otherwise; reference ParametricManopt.jl:307-377), one member
    of the batch per row.  A member stops when the cost moved less than
    ``tol``·max(cost, 1), after ``max_iters`` steps, or at λ ≥ 1e8; the
    rest of the batch goes on without it.  ``step_fn(x, lam)`` gives the
    step.  One device read an iteration: whether any member goes on."""
    B = bt.B
    c = bt.cost(x, p0s)
    lam = torch.full((B,), lam0, dtype=x.dtype, device=x.device)
    it = torch.zeros((B,), dtype=torch.int64, device=x.device)
    done = torch.zeros((B,), dtype=torch.bool, device=x.device)
    m = bt.free
    while True:
        active = (it < max_iters) & ~done & (lam < 1e8)
        if not bool(active.any()):
            return x, c
        x_new = x - step_fn(x, lam) * m
        c_new = bt.cost(x_new, p0s)
        improve = c_new < c
        moved = active & improve
        x = torch.where(moved[:, None], x_new, x)
        lam = torch.where(active, torch.where(
            improve, torch.clamp(lam * 0.3, min=1e-10), lam * 8.0), lam)
        done = torch.where(
            active, torch.abs(c - c_new) < tol * torch.clamp(c, min=1.0),
            done)
        c = torch.where(moved, c_new, c)
        it = it + active.to(it.dtype)


def _dense_step(bt: _Batch, p0s):
    """The step solving (H + λ·diag(max(diag H, 1e-8))) s = g: Marquardt
    damping on the masked normal equations."""
    m = bt.free
    mm = m[:, :, None] * m[:, None, :]
    unfree = torch.diag_embed(1.0 - m)

    def step(x, lam):
        r, J = bt.res_jac(x, p0s)
        Jt = J.transpose(1, 2)
        g = m * (Jt @ r[..., None])[..., 0]
        H = mm * (Jt @ J) + unfree
        damp = torch.diag_embed(torch.clamp(
            torch.diagonal(H, dim1=1, dim2=2), min=1e-8))
        # solve_ex: no host sync; a singular system gives a non-finite
        # step, whose cost the LM rejects
        return torch.linalg.solve_ex(H + lam[:, None, None] * damp,
                                     g[..., None])[0][..., 0]
    return step


def _cg(Amv, b: torch.Tensor, maxiter: int, tol: float) -> torch.Tensor:
    """Conjugate gradients from zero, a row per member, with the stopping
    rule of jax.scipy.sparse.linalg.cg: a member stops once
    ‖r‖² ≤ (tol·‖b‖)² or after ``maxiter`` iterations.  Finished members
    are frozen; the host looks every 25 iterations whether any goes on."""
    x = torch.zeros_like(b)
    r, p = b, b
    gamma = torch.sum(r * r, dim=-1)
    atol2 = (tol * tol) * torch.sum(b * b, dim=-1)
    active = gamma > atol2
    for k in range(maxiter):
        if k % 25 == 0 and not bool(active.any()):
            break
        Ap = Amv(p)
        pAp = torch.sum(p * Ap, dim=-1)
        # a member at a zero residual divides nothing
        alpha = torch.where(active, gamma / torch.where(pAp != 0, pAp, 1.0),
                            0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        gamma_new = torch.sum(r * r, dim=-1)
        beta = gamma_new / torch.where(gamma != 0, gamma, 1.0)
        p = torch.where(active[:, None], r + beta[:, None] * p, p)
        gamma = torch.where(active, gamma_new, gamma)
        active = active & (gamma > atol2)
    return x


def _cg_step(bt: _Batch, p0s, cg_iters: int = 200):
    """The step solving (JᵀJ + λI) s = Jᵀr by CG on jvp/vjp products of the
    stacked residual, J never formed (classic λI damping: Marquardt's
    diagonal would itself need J).

    The residual's graph is built once a step.  A product Jᵀ(J·v) is two
    passes of the autograd engine over it: the vjp u ↦ Jᵀu is linear in u,
    so its own vjp at v is the jvp J·v, and the vjp of that is Jᵀ(J·v).  No
    Python runs through the residual's models inside the CG loop; through
    ``torch.func.jvp`` each product re-ran them."""
    m = bt.free

    def step(x, lam):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            r = bt.residuals(xg, p0s)
            u = torch.zeros_like(r, requires_grad=True)
            (jtu,) = torch.autograd.grad(r, xg, u, create_graph=True)
        g = m * torch.autograd.grad(r, xg, r.detach(), retain_graph=True)[0]

        def Hmv(v):
            (jv,) = torch.autograd.grad(jtu, u, m * v, retain_graph=True)
            (jtjv,) = torch.autograd.grad(r, xg, jv, retain_graph=True)
            return m * jtjv + (1.0 - m) * v + lam[:, None] * v

        return _cg(Hmv, g, cg_iters, 1e-12)
    return step


def _solve_batch(probs: Sequence[ParametricProblem], x0, max_iters: int,
                 relinearize: int, lam0: float, tol: float,
                 compute_cov: bool, solver: str = "dense"):
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    bt = _Batch(probs)
    x = x0 if x0 is not None else bt.free.new_zeros((bt.B, bt.D))
    p0s = bt.p0s
    cost = None
    for _ in range(max(relinearize, 1)):
        make = _cg_step if solver == "cg" else _dense_step
        x, cost = _lm(bt, x, p0s, max_iters, lam0, tol, make(bt, p0s))
        p0s = bt.retract(x, p0s)
        x = torch.zeros_like(x)
    cov = bt.cov(p0s) if compute_cov else None
    out = []
    for b, q in enumerate(probs):
        pts = [p0s[q._type_of[v]][b, q._idx_in_type[v]]
               for v in q.var_labels]
        q.p0 = list(pts)
        out.append((pts, None if cov is None else cov[b], cost[b]))
    return out


def _problem_on(prob: ParametricProblem, device) -> ParametricProblem:
    """A shallow copy of ``prob`` whose tensors are on ``device`` (``prob``
    itself when they are there)."""
    if prob.free_mask.device == device:
        return prob

    def mv(x):
        if x is None or isinstance(x, int):
            return x
        if isinstance(x, tuple):
            return tuple(mv(e) for e in x)
        return x.to(device)

    out = copy.copy(prob)
    out.groups = []
    for g in prob.groups:
        gc = copy.copy(g)
        for name in ("params", "meas", "sqrt_inv", "slots", "brow", "mix",
                     "hyp", "null_p"):
            setattr(gc, name, mv(getattr(g, name)))
        out.groups.append(gc)
    out.p0 = [p.to(device) for p in prob.p0]
    out.free_mask = prob.free_mask.to(device)
    return out


def _solve_on_mesh(batch: List[ParametricProblem], mesh, *args):
    """A batch padded with copies of its first problem to a multiple of
    the mesh, split into one contiguous chunk per device, each chunk one
    batched solve there; results (and each problem's ``p0``) come back to
    the first problem's device, the copies' dropped."""
    home = batch[0].free_mask.device
    per = len(mesh.devices)
    padded = batch + [copy.copy(batch[0])
                      for _ in range(-(-len(batch) // per) * per
                                     - len(batch))]
    chunk = len(padded) // per
    out = []
    for c, dev in enumerate(mesh.devices):
        part = padded[c * chunk:(c + 1) * chunk]
        moved = [_problem_on(q, dev) for q in part]
        for q, m, (pts, cov, cost) in zip(part, moved,
                                          _solve_batch(moved, None, *args)):
            q.p0 = [p.to(home) for p in m.p0]
            out.append(([p.to(home) for p in pts],
                        None if cov is None else cov.to(home),
                        cost.to(home)))
    return out[:len(batch)]


def solve_problems_batched(probs: Sequence[ParametricProblem],
                           max_iters: int = 50, relinearize: int = 2,
                           lam0: float = 1e-4, tol: float = 1e-8,
                           compute_cov: bool = True,
                           batch_sizes: Optional[List[int]] = None,
                           mesh=None):
    """Solve many problems, those of one signature as one batch (the
    reference runs one task per clique, ParametricCSMFunctions.jl).
    Returns ``[(points, cov or None, cost), ...]`` aligned with ``probs``
    and updates each problem's ``p0`` as ``ParametricProblem.solve`` does.
    ``batch_sizes``, where given, receives the size of each batch.

    ``mesh`` (parallel/mesh.py): every batch, a single problem too, is
    padded to a multiple of the mesh and split over its devices (the JAX
    package shards the batch axis, jl_tpu/parametric/solver.py:853-890);
    each member still gets the result it would get alone."""
    by_sig: Dict[tuple, List[int]] = {}
    for i, p in enumerate(probs):
        by_sig.setdefault(p.signature(), []).append(i)
    results: List = [None] * len(probs)
    args = (max_iters, relinearize, lam0, tol, compute_cov)
    for idxs in by_sig.values():
        if batch_sizes is not None:
            batch_sizes.append(len(idxs))
        if len(idxs) == 1 and mesh is None:
            results[idxs[0]] = probs[idxs[0]].solve(
                max_iters=max_iters, relinearize=relinearize, lam0=lam0,
                tol=tol, compute_cov=compute_cov)
            continue
        batch = [probs[i] for i in idxs]
        out = (_solve_batch(batch, None, *args) if mesh is None
               else _solve_on_mesh(batch, mesh, *args))
        for i, res in zip(idxs, out):
            results[i] = res
    return results


# ---------------------------------------------------------------------------
# public API (reference solveGraphParametric!, solveConditionalsParametric)
# ---------------------------------------------------------------------------

def _write_back(fg: FactorGraph, prob: ParametricProblem, points, cov,
                labels: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    out = {}
    labels = set(labels or prob.var_labels)
    for i, v in enumerate(prob.var_labels):
        if v not in labels:
            continue
        var = fg.var(v)
        var.parametric_point = points[i]
        if cov is not None:
            s = int(prob.offsets[i])
            var.parametric_cov = cov[s:s + prob.dofs[i], s:s + prob.dofs[i]]
        var.ppe["parametric"] = {"mean": points[i], "max": points[i],
                                 "suggested": points[i]}
        # this solve's covariance only, never an earlier one
        out[v] = {"point": points[i],
                  "cov": var.parametric_cov if cov is not None else None}
    return out


@full_precision()
def solve_graph_parametric(fg: FactorGraph, max_iters: int = 50,
                           relinearize: int = 2,
                           init_from_belief: bool = True,
                           solver: str = "dense",
                           compute_cov: bool = True) -> Dict[str, dict]:
    """Whole-graph parametric solve (reference solveGraphParametric!,
    ParametricManopt.jl:588-613) on the graph's device.  Returns
    ``{label: {"point", "cov"}, "_cost": cost}`` and sets each variable's
    ``parametric_point``, ``parametric_cov`` and ``ppe["parametric"]``.
    ``init_from_belief`` is accepted and ignored, as in the JAX package."""
    prob = ParametricProblem(fg)
    points, cov, cost = prob.solve(max_iters=max_iters,
                                   relinearize=relinearize,
                                   compute_cov=compute_cov, solver=solver)
    result = _write_back(fg, prob, points, cov)
    result["_cost"] = cost
    return result


@full_precision()
def solve_conditionals_parametric(fg: FactorGraph,
                                  frontals: Sequence[str],
                                  separators: Sequence[str] = (),
                                  max_iters: int = 50,
                                  compute_cov: bool = True) -> Dict[str, dict]:
    """Solve ``frontals`` with ``separators`` pinned (reference
    solveConditionalsParametric, ParametricUtils.jl:655-721)."""
    labels = list(frontals) + [s for s in separators if s not in frontals]
    scope, front = set(labels), set(frontals)
    factors = [fl for fl in fg.lsf()
               if all(v in scope for v in fg.factor(fl).variables)
               and any(v in front for v in fg.factor(fl).variables)]
    prob = ParametricProblem(fg, variables=labels, factors=factors,
                             frozen=tuple(separators))
    points, cov, cost = prob.solve(max_iters=max_iters,
                                   compute_cov=compute_cov)
    result = _write_back(fg, prob, points, cov, labels=frontals)
    result["_cost"] = cost
    return result


@full_precision()
def autoinit_parametric(fg: FactorGraph, max_iters: int = 50) -> None:
    """Initialize parametric points variable by variable from the priors
    outward (reference autoinitParametric!, ParametricManopt.jl:497-580).
    The variables ready in one round are independent given their solved
    neighbours; their conditional solves go to ``solve_problems_batched``
    together."""
    pending = [v for v in fg.ls() if fg.var(v).parametric_point is None]
    rounds = 0
    while pending and rounds < len(fg.ls()) + 2:
        rounds += 1
        round_probs, round_vars = [], []
        for v in pending:
            usable = []
            for fl in fg.factors_of(v):
                f = fg.factor(fl)
                if isinstance(f.model, (MetaPrior, GenericMarginal)):
                    continue
                if all(fg.var(o).parametric_point is not None
                       for o in f.variables if o != v):
                    usable.append(fl)
            if not usable:
                continue
            seps = sorted({o for fl in usable
                           for o in fg.factor(fl).variables if o != v})
            if not seps and not any(len(fg.factor(fl).variables) == 1
                                    for fl in usable):
                continue
            round_probs.append(ParametricProblem(
                fg, variables=[v] + seps, factors=usable, frozen=tuple(seps)))
            round_vars.append(v)
        if not round_vars:
            break
        res = solve_problems_batched(round_probs, max_iters=max_iters)
        for prob, v, (points, cov, _) in zip(round_probs, round_vars, res):
            _write_back(fg, prob, points, cov, labels=[v])
        done = set(round_vars)
        pending = [v for v in pending if v not in done]


def init_parametric_from(fg: FactorGraph, from_key: str = "default",
                         only_missing: bool = False) -> int:
    """Seed the parametric solution from another solve key's beliefs
    (reference initParametricFrom!, ParametricUtils.jl:866-889): each
    initialized variable gets the on-manifold mean and the tangent
    covariance of its particles.  ``only_missing`` keeps points already
    set.  Returns the number of variables seeded."""
    n = 0
    for vl in fg.ls():
        v = fg.var(vl)
        if only_missing and v.parametric_point is not None:
            continue
        if not v.is_initialized(from_key):
            continue
        v.parametric_point, v.parametric_cov = belief_mean_cov(
            v.manifold, v.beliefs[from_key].points)
        n += 1
    return n

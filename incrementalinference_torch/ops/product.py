"""Product of KDE beliefs on a manifold — exact cascaded-pair products.

Counterpart of ``incrementalinference/jl_tpu/ops/product.py``.  Each belief
is a Gaussian mixture with one diagonal bandwidth per density; the product
of two mixtures is a mixture whose Na×Nb component weights are closed-form:

    w[i,j] ∝ exp(-½ Σ_d (μA_id - μB_jd)² / (bwA_d² + bwB_d²))

Component pairs are drawn exactly from those weights (row by its
log-partition, then column given row), combined analytically, and the
D-density product cascades D−1 such pair products.  Above
``LARGE_PAIR_THRESHOLD`` pairs the row log-partitions come from the
streaming CUDA kernel (ops/kernels/row_lse.py), the columns from the
inverse-CDF draw kernel (ops/kernels/pair_draw.py), and the (Na, Nb) matrix
is never built.  Index selections are plain indexing: the JAX package's
one-hot matmuls were a TPU workaround and select the same values.

The pair products and the cascade take a leading member axis (B
independent problems of one shape, a sequence of B keys): each member
draws from its own key, as it would alone, and on the large-pair path the
row log-partitions of all members are one kernel launch, and their column
draws another.

Each route's draws (the rows and the columns, every member) run inside one
span ``product.draw`` a call, nested in ``product``, with stream marks on
the card (``tracing.span``), and count ``draw_pairs`` (members × n_out ×
Nb: the (row, column) pairs the column draws weigh); the columns the draw
kernel drew count ``draw_kernel_pairs`` the same way.  A route added later
counts the same work the same way.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import keys as _keys
from .. import tracing
from ..config import full_precision
from ..manifolds import Manifold
from .kernels.pair_draw import pair_column_draw
from .kernels.row_lse import pair_row_logsumexp, pair_row_terms

__all__ = ["manifold_product", "Proposal", "pair_product_tangent",
           "pair_product_tangent_weighted", "pair_product_tangent_large",
           "condense_mixture", "product_cascade_tangent",
           "LARGE_PAIR_THRESHOLD", "CONDENSE_MIN_NB", "CONDENSE_K"]

#: Pair count (Na·Nb) at and above which the pair product streams its row
#: log-partitions through the CUDA kernel.  Kept at the JAX package's value
#: so the port takes the same branches; the H100's own crossover is open.
LARGE_PAIR_THRESHOLD = 1 << 30
#: incoming densities with at least this many kernels are condensed to
#: CONDENSE_K weighted clusters before the pair product (JAX package value)
CONDENSE_MIN_NB = 768
CONDENSE_K = 256
_CONDENSE_ITERS = 6


class Proposal:
    """One input density to a product: particle points, per-dim tangent
    bandwidth and a per-dim constraint mask (False = not constrained)."""

    def __init__(self, points: torch.Tensor, bw: torch.Tensor,
                 dim_mask: torch.Tensor | None = None):
        self.points = points
        self.bw = bw
        self.dim_mask = (torch.ones(bw.shape[-1], dtype=torch.bool,
                                    device=bw.device)
                         if dim_mask is None
                         else torch.as_tensor(dim_mask, dtype=torch.bool,
                                              device=bw.device))


def _combine(qA, sA, qB, sB):
    """Precision-weighted merge of selected component pairs."""
    prec = qA + qB
    mu = torch.where(prec > 0, (qA * sA + qB * sB) /
                     torch.clamp(prec, min=1e-30), torch.zeros_like(prec))
    return mu, prec


def _members(key, *ts):
    """(keys, tensors with a leading member axis, batched?).  A sequence of
    keys means the tensors carry a member axis, one key a member; an int
    key means one problem, given the axis here."""
    if isinstance(key, (list, tuple)):
        if any(t.shape[0] != len(key) for t in ts):
            raise ValueError(f"{len(key)} keys for member axes "
                             f"{[tuple(t.shape) for t in ts]}")
        return list(key), ts, True
    return [key], tuple(t[None] for t in ts), False


def _out(pairs, batched):
    """Stack per-member (mu, prec) results, or unwrap the one member."""
    if not batched:
        return pairs[0]
    return tuple(torch.stack(c) for c in zip(*pairs))


def _take(x, idx):
    """Rows ``idx`` (B, n) of each member of ``x`` (B, N, d)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


@full_precision()
def _pair_logW(muA, precA, muB, precB):
    """Agreement log-weights in thin-matmul form, with an optional leading
    member axis.

    B always has one shared precision row in the cascade, so
    ivar = pA·pB/(pA+pB) depends only on (component of A, dim) and
    Σ_d ivar (a − b)² = Σ_d ivar a² + ivar·(b²)ᵀ − 2 (ivar⊙a)·bᵀ.
    Full float32 products (pinned by config.full_precision)."""
    pB0 = precB[..., :1, :]
    both = (precA > 0) & (pB0 > 0)
    ivar = torch.where(both, precA * pB0 / torch.clamp(precA + pB0,
                                                      min=1e-30),
                       torch.zeros_like(precA))
    a2 = torch.sum(ivar * muA * muA, dim=-1)
    muBt = muB.transpose(-1, -2)
    t2 = ivar @ (muBt * muBt)
    t3 = (ivar * muA) @ muBt
    return -0.5 * (a2[..., None] + t2 - 2.0 * t3)


def _count_draw(sp, route: str, muA, muB, members: int, n_out: int):
    """Inside a recording span ``product.draw`` (``sp``; None while
    nothing records): its attributes and the ``draw_pairs`` the call's
    column draws weigh, members × n_out × Nb."""
    if sp is None:
        return
    nb = muB.shape[-2]
    sp.attrs.update(route=route, members=members, rows=n_out,
                    na=muA.shape[-2], nb=nb, dof=muA.shape[-1])
    tracing.count("draw_pairs", members * n_out * nb)


def pair_product_tangent(muA, precA, muB, precB, key, n_out: int):
    """Exact product of two diagonal-Gaussian mixtures in tangent coords;
    ``precB`` shares one precision row.  Returns (mu, prec) of ``n_out``
    exactly drawn product components: the row by its log-partition, then
    the column given the row.  With a sequence of keys the inputs carry a
    leading member axis, each member drawing from its own key."""
    keys, (muA, precA, muB, precB), batched = _members(key, muA, precA,
                                                        muB, precB)
    logW = _pair_logW(muA, precA, muB, precB)             # (B, Na, Nb)
    row_ls = torch.logsumexp(logW, dim=-1)
    ia, ib = [], []
    with tracing.span("product.draw", muA.device, marks=True) as sp:
        _count_draw(sp, "materialised", muA, muB, len(keys), n_out)
        for b, k in enumerate(keys):
            k_row, k_col = _keys.split(k, 2)
            i = _keys.categorical(k_row, row_ls[b], n_out)
            ia.append(i)
            ib.append(_keys.categorical_rows(k_col, logW[b][i]))
    ia, ib = torch.stack(ia), torch.stack(ib)
    mu, prec = _combine(_take(precA, ia), _take(muA, ia), _take(precB, ib),
                        _take(muB, ib))
    return (mu, prec) if batched else (mu[0], prec[0])


@full_precision()
def condense_mixture(mu, prec, key: int, k: int,
                     iters: int = _CONDENSE_ITERS):
    """Condense an (N, dof) mixture with a shared precision row to k
    weighted clusters (Lloyd iterations from a strided start; cluster
    variance folds into the kernel variance; counts become log-weights).
    Returns (centroids (k, dof), precisions (k, dof), log-weights (k,)).

    Cluster sums are one-hot matrix products, as in the JAX package: a
    scatter-add would add with atomics on CUDA, in an order that changes
    from run to run."""
    del key                                  # strided init, no draws
    lam = prec[0]
    x = mu * (lam > 0).to(mu.dtype)          # cluster constrained dims only
    A = _condense_assignment(x, k, iters)    # (N, k) one-hot, final
    cnt = torch.sum(A, dim=0)                # exact: sums of ones
    denom = torch.clamp(cnt, min=1.0)[:, None]
    mean = (A.T @ mu) / denom
    var = torch.clamp((A.T @ (mu * mu)) / denom - mean * mean, min=0.0)
    prec_c = torch.where(lam[None, :] > 0,
                         1.0 / (1.0 / torch.clamp(lam[None, :], min=1e-30)
                                + var),
                         torch.zeros_like(var))
    # dead clusters: a large finite negative weight, as in the JAX package
    logw = torch.where(cnt > 0, torch.log(torch.clamp(cnt, min=1.0)),
                       torch.full_like(cnt, -1e30))
    return mean, prec_c, logw


def _condense_assignment(x, k: int, iters: int):
    """The one-hot (N, k) cluster assignment after ``iters`` Lloyd steps
    from the strided start."""
    n = x.shape[0]
    stride = max(1, n // k)
    c = x[::stride][:k]
    if c.shape[0] < k:
        c = torch.cat([c, x[:k - c.shape[0]]], dim=0)
    x2 = torch.sum(x * x, 1)

    def assign(c):
        d2 = x2[:, None] - 2.0 * (x @ c.T) + torch.sum(c * c, 1)[None, :]
        lab = torch.argmin(d2, dim=1)
        return (lab[:, None] == torch.arange(k, device=x.device)).to(x.dtype)

    for _ in range(iters):
        A = assign(c)
        cnt = torch.sum(A, dim=0)[:, None]
        c = torch.where(cnt > 0, (A.T @ x) / torch.clamp(cnt, min=1.0), c)
    return assign(c)


def pair_product_tangent_weighted(muA, precA, muB, precB, logwB, key,
                                  n_out: int):
    """Exact pair product against a weighted mixture with per-component
    precisions (the condensed form; Nb is the small cluster count).  With
    a sequence of keys the inputs carry a leading member axis; the members
    are solved one after another."""
    keys, (muA, precA, muB, precB, logwB), batched = _members(
        key, muA, precA, muB, precB, logwB)
    row_ls = [torch.logsumexp(_logits_vs(muA[b], precA[b], muB[b], precB[b],
                                         logwB[b]), dim=1)
              for b in range(len(keys))]
    outs = []
    with tracing.span("product.draw", muA.device, marks=True) as sp:
        _count_draw(sp, "condensed", muA, muB, len(keys), n_out)
        for b, k in enumerate(keys):
            k_row, k_col = _keys.split(k, 2)
            ia = _keys.categorical(k_row, row_ls[b], n_out)
            sA, qA = muA[b][ia], precA[b][ia]
            ib = _keys.categorical_rows(k_col, _logits_vs(
                sA, qA, muB[b], precB[b], logwB[b]))
            outs.append(_combine(qA, sA, precB[b][ib], muB[b][ib]))
    return _out(outs, batched)


def _logits_vs(mu_rows, prec_rows, muB, precB, logwB):
    """(R, Nb) pair log-weights of the given rows against all of the
    weighted mixture B."""
    pa, pb = prec_rows[:, None, :], precB[None, :, :]
    both = (pa > 0) & (pb > 0)
    ivar = torch.where(both, pa * pb / torch.clamp(pa + pb, min=1e-30),
                       torch.zeros((), dtype=pa.dtype, device=pa.device))
    diff = mu_rows[:, None, :] - muB[None, :, :]
    return -0.5 * torch.sum(ivar * diff * diff, dim=-1) + logwB[None, :]


def pair_product_tangent_large(muA, precA, muB, precB, key, n_out: int):
    """Large-N exact pair product that never builds the (Na, Nb) matrix:
    row log-partitions stream through the row-logsumexp kernel, the rows
    are drawn against them, and each drawn row's column by inverse CDF
    through the column-draw kernel (``ops/kernels/pair_draw.py``; their
    plain versions on the CPU) on two uniforms a row from the member's key.

    With a sequence of keys the inputs carry a leading member axis: the
    row log-partitions of every member are ONE kernel launch (the JAX
    package's vmapped Pallas call), and so are the column draws."""
    row_ls = pair_row_logsumexp(muA, precA, muB, precB)  # ([B,] Na)
    keys, (muA, precA, muB, precB, row_ls), batched = _members(
        key, muA, precA, muB, precB, row_ls)
    with tracing.span("product.draw", muA.device, marks=True) as sp:
        _count_draw(sp, "large", muA, muB, len(keys), n_out)
        ia, u = [], []
        for b, k in enumerate(keys):
            k_row, k_col = _keys.split(k, 2)
            ia.append(_keys.categorical(k_row, row_ls[b], n_out))
            u.append(torch.rand((n_out, 2), generator=_keys.generator(
                k_col, muA.device), device=muA.device, dtype=muA.dtype))
        ia, u = torch.stack(ia), torch.stack(u)
        muA_s, precA_s = _take(muA, ia), _take(precA, ia)
        a2, ivar, ivmuA = pair_row_terms(muA_s, precA_s, muB, precB)
        ib = pair_column_draw(a2.contiguous(), ivar.contiguous(),
                              ivmuA.contiguous(), muB.contiguous(), u)
        mu, prec = _combine(precA_s, muA_s, _take(precB, ib),
                            _take(muB, ib))
    return (mu, prec) if batched else (mu[0], prec[0])


def _pair_stage(mu, prec, mu_b, prec_b, key_pair, key_condense, n_out: int):
    """One stage of the cascade, routed as in the JAX package by the pair
    count of one member: condensed when B is large but the pair count is
    not, streamed when the pair count reaches ``LARGE_PAIR_THRESHOLD``,
    exact and materialised otherwise.  Keys as in
    :func:`pair_product_tangent`."""
    nb = mu_b.shape[-2]
    pairs = mu.shape[-2] * nb
    if nb >= CONDENSE_MIN_NB and pairs < LARGE_PAIR_THRESHOLD:
        kc, ts, batched = _members(key_condense, mu_b, prec_b)
        cond = [condense_mixture(m, p, k, k=min(CONDENSE_K, nb))
                for m, p, k in zip(*ts, kc)]
        cB, pB, lwB = (tuple(torch.stack(c) for c in zip(*cond)) if batched
                       else cond[0])
        return pair_product_tangent_weighted(mu, prec, cB, pB, lwB,
                                             key_pair, n_out)
    if pairs >= LARGE_PAIR_THRESHOLD:
        return pair_product_tangent_large(mu, prec, mu_b, prec_b, key_pair,
                                          n_out)
    return pair_product_tangent(mu, prec, mu_b, prec_b, key_pair, n_out)


def _final_draw(mu, prec, key):
    """One draw inside each selected product component; with a sequence
    of keys, one per member of the leading axis."""
    keys, (mu, prec), batched = _members(key, mu, prec)
    noise = torch.stack([torch.randn(
        mu.shape[1:], generator=_keys.generator(k, mu.device),
        device=mu.device, dtype=mu.dtype) for k in keys]) \
        / torch.sqrt(torch.clamp(prec, min=1e-30))
    out = torch.where(prec > 0, mu + noise, torch.zeros_like(mu))
    return out if batched else out[0]


def _resample(mu, prec, keys, n_out: int):
    """``n_out`` uniformly drawn rows of each member (B, N, d)."""
    idx = torch.stack([torch.randint(
        0, mu.shape[1], (n_out,), generator=_keys.generator(k, mu.device),
        device=mu.device) for k in keys])
    return _take(mu, idx), _take(prec, idx)


def product_cascade_tangent(tangs, precs, key, n_out: int):
    """Cascade exact pairwise products over D densities.  tangs/precs:
    lists of (N_j, dof), or of (B, N_j, dof) with a sequence of B keys.
    Returns sampled points (n_out, dof) (or (B, n_out, dof)) and the
    per-dim total precision."""
    keys, _, batched = _members(key, tangs[0])
    if not batched:
        tangs = [t[None] for t in tangs]
        precs = [p[None] for p in precs]
    ks = [_keys.split(k, 2 * len(tangs)) for k in keys]
    mu, prec = tangs[0], precs[0]
    noise_keys = [k[0] for k in ks]
    if mu.shape[1] != n_out and len(tangs) == 1:
        mu, prec = _resample(mu, prec, noise_keys, n_out)
        noise_keys = [_keys.split(k, 1)[0] for k in noise_keys]
    for j in range(1, len(tangs)):
        mu, prec = _pair_stage(mu, prec, tangs[j], precs[j],
                               [k[j] for k in ks],
                               [k[len(tangs) + j] for k in ks], n_out)
    out = _final_draw(mu, prec, noise_keys)
    return (out, prec) if batched else (out[0], prec[0])


@full_precision()
@tracing.spanned("product", lambda manifold, proposals, key, n_out, *a, **k: {
    "densities": len(proposals), "N": n_out})
def manifold_product(manifold: Manifold, proposals: Sequence[Proposal],
                     key: int, n_out: int,
                     old_points: torch.Tensor | None = None,
                     sweeps: int = 0) -> torch.Tensor:
    """Product of proposal densities → ``n_out`` particle points;
    ``old_points`` fill dims no proposal constrains.  ``sweeps`` is kept for
    API parity (the exact cascade needs no Gibbs sweeps)."""
    D = len(proposals)
    if D == 0:
        if old_points is None:
            raise ValueError("empty product with no fallback points")
        return old_points
    if D == 1 and bool(torch.all(proposals[0].dim_mask)):
        return proposals[0].points[:n_out]

    pooled = torch.cat([p.points for p in proposals], dim=0)
    ref = manifold.mean(pooled)
    tangs, precs = [], []
    for p in proposals:
        t = manifold.log(ref[None, :], p.points)
        lam = torch.where(p.dim_mask, 1.0 / torch.clamp(p.bw ** 2, min=1e-12),
                          torch.zeros_like(p.bw))
        tangs.append(t)
        precs.append(lam.expand(t.shape))
    samples, _ = product_cascade_tangent(tangs, precs, key, n_out)
    if old_points is not None:
        unconstrained = torch.stack(
            [torch.max(q, dim=0).values for q in precs]).max(dim=0).values <= 0
        if bool(torch.any(unconstrained)):
            old_t = manifold.log(ref[None, :], old_points[:n_out])
            samples = torch.where(unconstrained[None, :], old_t, samples)
    return manifold.exp(ref.expand((n_out,) + ref.shape), samples)

"""Factor deconvolution — invert a factor for its measurement.

Counterpart of ``incrementalinference/jl_tpu/ops/deconv.py`` (reference
approxDeconv, approxDeconvBelief): given the beliefs of a factor's
variables, solve per particle for the *measurement* that zeroes the
residual.  It powers the joint "differential" up-messages and
factor-against-data consistency checks.  All particles solve at once: a
damped Gauss-Newton over the measurement coordinates, Jacobians from
``torch.func.jacrev`` under ``vmap``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacrev, vmap

from .. import keys as _keys
from ..beliefs import Belief, make_belief
from ..manifolds import Euclidean

__all__ = ["approx_deconv", "approx_deconv_belief", "mmd"]


def _solve_measurement(model, meas0: torch.Tensor, points, iters: int = 25,
                       damping: float = 1e-6) -> torch.Tensor:
    """Per particle: min_z ||residual(z, pts_i)||², batched."""
    zdim = meas0.shape[-1]
    eye = torch.eye(zdim, dtype=meas0.dtype, device=meas0.device)
    res = vmap(model.residual)
    jac = vmap(jacrev(model.residual, argnums=0))
    z = meas0
    for _ in range(iters):
        r = res(z, *points)                                  # (n, resdim)
        J = jac(z, *points)                                  # (n, res, zdim)
        Jt = J.transpose(-1, -2)
        step = torch.linalg.solve(Jt @ J + damping * eye,
                                  Jt @ r[..., None])[..., 0]
        z = z - step
    return z


def approx_deconv(fg, factor_label: str, key: int | None = None,
                  solve_key: str = "default",
                  n: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (solved_measurements, sampled_measurements): the deconv
    estimate beside the factor's own generative samples (reference
    approxDeconv return convention)."""
    f = fg.factor(factor_label)
    key = key if key is not None else fg.next_key()
    n_out = n or fg.params.N
    pts = tuple(fg.points(v, solve_key)[:n_out] for v in f.variables)
    meas0 = f.model.sample(_keys.generator(key, fg.device), n_out)
    solved = _solve_measurement(f.model, meas0, pts,
                                iters=fg.params.conv_iters)
    return solved, meas0


def approx_deconv_belief(fg, factor_label: str, key: int | None = None,
                         solve_key: str = "default",
                         n: int | None = None) -> Belief:
    """Deconv result wrapped as a belief over measurement coordinates
    (reference approxDeconvBelief)."""
    solved, _ = approx_deconv(fg, factor_label, key=key, solve_key=solve_key,
                              n=n)
    return make_belief(Euclidean(solved.shape[-1]), solved)


def mmd(a: torch.Tensor, b: torch.Tensor, bw: float | None = None) -> float:
    """Maximum mean discrepancy between two particle sets (reference
    ``mmd``), the quality metric of the deconv and consistency tests; the
    kernel width defaults to the median squared pairwise distance of the
    pooled sets."""
    def sqdist(x, y):
        d = x[:, None, :] - y[None, :, :]
        return torch.sum(d * d, dim=-1)

    if bw is None:
        pooled = torch.cat([a, b])
        # the mean of the two middle values, as numpy and jax take a median
        bw = torch.quantile(sqdist(pooled, pooled).flatten(), 0.5) + 1e-9

    def k(x, y):
        return torch.mean(torch.exp(-sqdist(x, y) / bw))

    return float(k(a, a) + k(b, b) - 2.0 * k(a, b))

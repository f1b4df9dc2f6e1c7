"""Every variable's particles against its exact marginal, for a graph of
scalar priors and linear relatives (``reference/linear_gaussian.py``,
float64): the whole 1-D marginal, not only its two moments.

Counts, limit 0: ``unsolved``, beliefs the timed solve did not replace;
``bad_particles``, beliefs without N finite particles of the point size.
Gaps, each the worst over the variables and the checked steps:
``marg_mean_z``, |particle mean - exact mean| over the exact sd;
``marg_log_sd``, ½ |log(particle variance / exact variance)|;
``marg_ks``, the Kolmogorov-Smirnov distance between the particles'
empirical distribution and the exact Gaussian marginal; ``stale_share``,
the share of a belief's particles that are, bit for bit, particles it held
before the solve (graphinit's), as in ``checks/beliefs.py``.

For a control (``source`` a precision) the gaps are read from N draws of
the exact marginal, the posterior and the draws both formed in that
precision, in place of the particles; the counts stay the program's."""

from __future__ import annotations

import math

import torch

from . import worst
from .beliefs import _stale
from ..reference import linear_gaussian


def gaps(x, mean: float, var: float):
    """(mean in sds, ½ |log variance ratio|, KS distance) of the 1-D
    particles ``x`` against the Gaussian (mean, var)."""
    x = torch.sort(x.detach().double().reshape(-1).cpu()).values
    n = x.shape[0]
    sd = math.sqrt(var)
    z = abs(float(x.mean()) - mean) / sd
    v = float(x.var(correction=0))
    log_sd = 0.5 * abs(math.log(v / var)) if v > 0 else math.inf
    cdf = torch.special.ndtr((x - mean) / sd)
    k = torch.arange(n, dtype=torch.float64)
    ks = float(torch.maximum((k + 1) / n - cdf, cdf - k / n).max())
    return z, log_sd, ks


def judge(records, ctx, source):
    cfg = ctx["cfg"]
    unsolved = bad = 0
    z_max = sd_max = ks_max = stale = None
    for rec in records:
        labels, factors = rec["meas"]["labels"], rec["meas"]["factors"]
        mean, cov = linear_gaussian.posterior(labels, factors)
        if source != "program":
            mean_c, cov_c = linear_gaussian.posterior(labels, factors,
                                                      source)
        for k, lbl in enumerate(labels):
            b = rec["beliefs"].get(lbl)
            unsolved += not rec["replaced"].get(lbl)
            if b is None or tuple(b[0].shape) != (
                    cfg["N"], cfg["point_dim"]) or not bool(
                    torch.isfinite(b[0]).all()):
                bad += 1
                continue
            pts = b[0].detach().cpu()
            stale = worst(stale, _stale(pts, rec["init"].get(lbl)))
            x = pts[:, 0] if source == "program" else \
                linear_gaussian.marginal_samples(
                    mean_c[k], cov_c[k, k], cfg["N"],
                    rec["step"] * 1_000 + k, source)
            z, sd, ks = gaps(x, float(mean[k]), float(cov[k, k]))
            z_max, sd_max = worst(z_max, z), worst(sd_max, sd)
            ks_max = worst(ks_max, ks)
    return {"unsolved": unsolved, "bad_particles": bad,
            "marg_mean_z": z_max, "marg_log_sd": sd_max, "marg_ks": ks_max,
            "stale_share": stale}, {}

"""Every variable's posterior against the reference's Laplace posterior of
the same drawn measurements (``reference/gaussian.py``, float64).

Counts, limit 0: ``unsolved``, beliefs the timed solve did not replace;
``bad_particles``, beliefs without N finite particles of the manifold's
point size.  Shares and gaps, each the worst over the poses and the
checked steps, on the particles' tangents at the reference's point:
``pose_mean_z``, the particles' mean in posterior sigmas (Mahalanobis
under the reference covariance); ``pose_log_sd``, the largest |log| of a
standard deviation ratio, particles over reference, along the
reference's principal axes; ``stale_share``, the share of a belief's
particles that are, bit for bit, particles it held before the solve
(graphinit's)."""

from __future__ import annotations

import torch

from . import worst
from ..reference import gaussian
from ..reference.manifolds import by_name


def _stale(pts, init):
    if init is None:
        return 0.0
    seen = {bytes(r) for r in init.detach().cpu().numpy()}
    rows = pts.detach().cpu().numpy()
    return sum(bytes(r) in seen for r in rows) / max(1, len(rows))


def pose_gaps(M, pts, point, cov):
    """(mean in sigmas, worst |log sd ratio|) of particles ``pts`` against
    the Gaussian at ``point`` with tangent covariance ``cov``."""
    t = M.log(point[None], pts.double())
    m = t.mean(dim=0)
    C = torch.cov(t.T, correction=0)
    w, V = torch.linalg.eigh(cov)
    W = V / torch.sqrt(w)                     # cov^-1/2 along its axes
    z = float(torch.sqrt(m @ torch.linalg.solve(cov, m)))
    lam = torch.linalg.eigvalsh(W.T @ C @ W)
    return z, float(0.5 * torch.log(lam).abs().max())


def judge(records, ctx, source):
    cfg = ctx["cfg"]
    M = by_name(cfg["manifold"], cfg["dof"])
    d = M.dof
    unsolved = bad = 0
    z_max = sd_max = stale = None
    for rec in records:
        meas = rec["meas"]
        labels, factors = meas["labels"], meas["factors"]
        ref_pts, S = gaussian.posterior(
            M, labels, factors, gaussian.chain_start(M, labels, factors))
        for k, lbl in enumerate(labels):
            b = rec["beliefs"].get(lbl)
            unsolved += not rec["replaced"].get(lbl)
            if b is None or tuple(b[0].shape) != (
                    cfg["N"], cfg["point_dim"]) or not bool(
                    torch.isfinite(b[0]).all()):
                bad += 1
                continue
            pts = b[0].detach().cpu()
            z, sd = pose_gaps(M, pts, ref_pts[k],
                              S[k * d:(k + 1) * d, k * d:(k + 1) * d])
            z_max, sd_max = worst(z_max, z), worst(sd_max, sd)
            stale = worst(stale, _stale(pts, rec["init"].get(lbl)))
    return {"unsolved": unsolved, "bad_particles": bad,
            "pose_mean_z": z_max, "pose_log_sd": sd_max,
            "stale_share": stale}, {}

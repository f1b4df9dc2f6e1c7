"""``beliefs`` on SE(3): every variable's posterior against the
reference's Laplace posterior of the same drawn measurements
(``reference/gaussian.py`` on ``reference/se3.py``, float64), with the
same numbers and limits' meaning as ``checks/beliefs.py``: ``unsolved``,
``bad_particles``, ``pose_mean_z``, ``pose_log_sd`` and ``stale_share``.
``reference/manifolds.by_name`` knows no SE(3), so the manifold is named
here; Gauss-Newton starts from ``se3.chain_start`` (a 7-number point)."""

from __future__ import annotations

import torch

from . import worst
from .beliefs import _stale, pose_gaps
from ..reference import gaussian, se3


def judge(records, ctx, source):
    cfg = ctx["cfg"]
    M = se3.SE3()
    d = M.dof
    unsolved = bad = 0
    z_max = sd_max = stale = None
    for rec in records:
        labels, factors = rec["meas"]["labels"], rec["meas"]["factors"]
        ref_pts, S = gaussian.posterior(M, labels, factors,
                                        se3.chain_start(labels, factors))
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

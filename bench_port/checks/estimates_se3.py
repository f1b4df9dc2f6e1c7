"""``estimates`` on SE(3) (``reference/se3.py``): the estimates the timed
``set_ppe`` returned, against the reference's Karcher mean and
highest-density particle of the same particles, with the bandwidth worked
out again, all in float64; ``checks/estimates.py``'s numbers
``ppe_mean_gap`` and ``ppe_max_gap``."""

from __future__ import annotations

from . import worst
from ..reference import kde, se3


def judge(records, ctx, source):
    M = se3.SE3()
    mean_gap = max_gap = None
    for rec in records:
        for lbl in rec["meas"]["labels"]:
            b = rec["beliefs"].get(lbl)
            est = (rec.get("ppe") or {}).get(lbl)
            if b is None or est is None:
                mean_gap = max_gap = float("nan")
                continue
            pts = b[0].detach()
            bw = kde.loo_bandwidth(M, pts)
            mean_r, _, lp = kde.estimates(M, pts, bw)
            if source == "program":
                mean_o, max_o = est["mean"], est["max"]
            else:
                mean_o, max_o, _ = kde.estimates(
                    M, pts, kde.loo_bandwidth(M, pts, source), source)
            mean_o = mean_o.detach().double().reshape(-1)
            max_o = max_o.detach().double().reshape(1, -1)
            mean_gap = worst(mean_gap, float(
                (M.log(mean_r, mean_o) / bw).abs().max()))
            max_gap = worst(max_gap, float(
                lp.max() - kde.logdensity(M, pts, bw, max_o)[0]))
    return {"ppe_mean_gap": mean_gap, "ppe_max_gap": max_gap}, {}

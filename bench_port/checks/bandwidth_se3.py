"""``bandwidth`` on SE(3) (``reference/se3.py``): every posterior's
bandwidth against the reference's leave-one-out bandwidth of the same
particles, worked out again in float64, with ``checks/bandwidth.py``'s
numbers ``bw_base_gap`` and ``bw_ll_gap``."""

from __future__ import annotations

import torch

from . import worst
from ..reference import kde, se3


def judge(records, ctx, source):
    M = se3.SE3()
    base = ll = None
    for rec in records:
        for lbl in rec["meas"]["labels"]:
            b = rec["beliefs"].get(lbl)
            if b is None:
                continue
            pts = b[0].detach()
            bw = (b[1].detach() if source == "program"
                  else kde.loo_bandwidth(M, pts, source)).double()
            bw0, scales, lls = kde.bandwidth_terms(M, pts)
            r = torch.log(bw / bw0)
            j = int(torch.argmin((r.mean() - torch.log(scales)).abs()))
            base = worst(base, float((r - torch.log(scales[j])).abs().max()))
            m = kde.loo_subsample(pts).shape[0]
            ll = worst(ll, float(lls.max() - lls[j]) / (m * M.dof))
    return {"bw_base_gap": base, "bw_ll_gap": ll}, {}

"""Every posterior's bandwidth against the reference's leave-one-out
bandwidth of the same particles, worked out again in float64.

``bw_base_gap``: how far the bandwidth lies from the nearest grid point
times the reference's Silverman base, max |ln(bw / (s * bw0))| over the
dimensions.  ``bw_ll_gap``: how far that grid point's leave-one-out
log-likelihood lies below the reference's best, per particle and
dimension (a near tie between two grid points reads about 0)."""

from __future__ import annotations

import torch

from . import worst
from ..reference import kde
from ..reference.manifolds import by_name


def judge(records, ctx, source):
    cfg = ctx["cfg"]
    M = by_name(cfg["manifold"], cfg["dof"])
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

"""The pair log-sum-exp kernel's share of its roofline, in %.

The work: ``row_lse.counts["problems"]`` problems in the profiled steps,
each N x N pairs at the configuration's dof (the cell's own shapes).  Each
pair needs at least one exponential and its sum into the row.

The least time is the largest of three bounds, none of which any route can
beat:
- bytes: the inputs (the two sides' means and precisions, float32, N x dof
  each) read once and the row results written once, at the HBM rate;
- tensor: the pair terms as a product of K = dof + 2 (the expanded
  square), 2 K flops a pair, at the fastest dense tensor rate of the card
  (fp8), whatever a faithful kernel would use;
- exponentials: one a pair, evaluated on the special-function units or as
  a polynomial on the FP32 lanes at no less than one lane operation, both
  at once, with the row sums on the tensor cores: pairs over (lane rate +
  SFU rate).  This bound binds at every dof the configurations use (at dof
  3 it is 5.3 x the tensor bound and 86 x the bytes bound).

The time divided by: the device time of the kernels in ``KERNELS``.  A
route that skips pairs (a fast Gauss transform) is another algorithm and
needs a metric of its own."""

from __future__ import annotations

import json
import os

KERNELS = ("row_lse_partial", "row_lse_combine")

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "lib", "peaks.json")) as _f:
    PEAKS = json.load(_f)


def least_seconds(problems: int, n: int, dof: int, peaks=PEAKS) -> dict:
    """The three bounds of ``problems`` N x N problems at ``dof``."""
    pairs = float(problems) * n * n
    lane_rate = (peaks["sm_count"] * peaks["fp32_lanes_per_sm"]
                 * peaks["boost_clock_hz"])
    sfu_rate = (peaks["sm_count"] * peaks["mufu_per_sm_per_clock"]
                * peaks["boost_clock_hz"])
    nbytes = problems * (4.0 * n * dof * 4 + 4.0 * n)
    return {"bytes": nbytes / peaks["hbm_bytes_per_s"],
            "tensor": pairs * 2 * (dof + 2) / peaks["fp8_tensor_flops"],
            "exp": pairs / (lane_rate + sfu_rate)}


def kernel_seconds(events) -> float:
    return sum(e - s for name, s, e in events
               if any(k in name for k in KERNELS)) / 1e6


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("problems"):
        return None
    t = kernel_seconds(tr["events"])
    if t <= 0:
        return None
    b = least_seconds(tr["problems"], ctx["cfg"]["N"], ctx["cfg"]["dof"])
    return 100.0 * max(b.values()) / t

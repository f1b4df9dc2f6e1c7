"""The column draws' share of their roofline, in %.

The work: the ``draw_pairs`` counter of the profiled steps, the (row,
column) pairs the draws weighed (members × rows drawn × Nb a call).  Any
exact draw weighs each pair at least once.

The least time is the larger of two bounds:
- transcendental: one a pair (an exponential, or a logarithm of the
  Gumbel noise), evaluated on the special-function units and as a
  polynomial on the FP32 lanes at once, as ``pair_lse_roofline_pct``'s
  exponential bound: pairs over (lane rate + SFU rate), at
  ``lib/peaks.json``'s rates;
- bytes: each call's inputs read once (both sides' means and precisions
  and the row log-partitions, float32) and the drawn row and column
  indices written once (int64), at the HBM rate.

The time divided by: ``draw_device_ms``'s, the device time of the
operations the draws launched."""

from __future__ import annotations

from bench_port.lib import draw_trace
from bench_port.metrics.pair_lse_roofline_pct import PEAKS


def draw_bytes(members: int, na: int, nb: int, rows: int, dof: int) -> float:
    """Bytes a call's draws cannot avoid: inputs read once, the row and
    column indices written once."""
    return members * (4.0 * (2 * na * dof + na + 2 * nb * dof)
                      + 8.0 * 2 * rows)


def least_seconds(pairs: float, nbytes: float, peaks=PEAKS) -> dict:
    """The two bounds of ``pairs`` weighed pairs and ``nbytes`` bytes."""
    lane_rate = (peaks["sm_count"] * peaks["fp32_lanes_per_sm"]
                 * peaks["boost_clock_hz"])
    sfu_rate = (peaks["sm_count"] * peaks["mufu_per_sm_per_clock"]
                * peaks["boost_clock_hz"])
    return {"transcendental": pairs / (lane_rate + sfu_rate),
            "bytes": nbytes / peaks["hbm_bytes_per_s"]}


def read(ctx):
    d = draw_trace.get(ctx)
    if d is None or not d["pairs"] or d["busy_us"] <= 0:
        return None
    nbytes = sum(draw_bytes(**{k: s["attrs"][k] for k in (
        "members", "na", "nb", "rows", "dof")}) for s in d["spans"])
    b = least_seconds(d["pairs"], nbytes)
    return 100.0 * max(b.values()) / (d["busy_us"] / 1e6)

"""The KDE read kernel's share of its roofline, in %.

The work: the ``kde_pairs`` counter of the profiled steps, the (query,
kernel) pairs that ``beliefs.kde_logpdf`` read through its kernel
(members x Q x N a call; the eager route counts ``kde_eager_pairs``
instead).  Any exact read weighs each pair at least once.

The least time is the larger of two bounds:
- exponentials: one a pair, evaluated on the special-function units and
  as a polynomial on the FP32 lanes at once, as
  ``pair_lse_roofline_pct``'s exponential bound: pairs over (lane rate +
  SFU rate), at ``lib/peaks.json``'s rates.  The log map's own arithmetic
  (SE(2)'s trigonometry and rotation) is not added, so the share can only
  understate;
- bytes: each read's particles, query points and bandwidths read once and
  its log-densities written once (float32), at the HBM rate.  A read's
  members are its ``kde_logpdf`` span's ``kde_pairs`` over Q x N.

The time divided by: the device time of the kernel's events, found by
name (``KERNELS``).  None where the run was not traced or read no pair
through the kernel (a checkout from before it)."""

from __future__ import annotations

from bench_port.metrics.pair_lse_roofline_pct import PEAKS

KERNELS = ("kde_lse_prep", "kde_lse_partial", "kde_lse_combine")


def read_bytes(members: int, n: int, q: int, point_dim: int,
               dof: int) -> float:
    """Bytes a read cannot avoid: points and queries and bandwidths read
    once, the log-densities written once."""
    return members * 4.0 * (point_dim * (n + q) + dof + q)


def least_seconds(pairs: float, nbytes: float, peaks=PEAKS) -> dict:
    """The two bounds of ``pairs`` pairs and ``nbytes`` bytes."""
    lane_rate = (peaks["sm_count"] * peaks["fp32_lanes_per_sm"]
                 * peaks["boost_clock_hz"])
    sfu_rate = (peaks["sm_count"] * peaks["mufu_per_sm_per_clock"]
                * peaks["boost_clock_hz"])
    return {"exp": pairs / (lane_rate + sfu_rate),
            "bytes": nbytes / peaks["hbm_bytes_per_s"]}


def kernel_seconds(events) -> float:
    return sum(e - s for name, s, e in events
               if any(k in name for k in KERNELS)) / 1e6


def compute(ctx, snap):
    """The share from ``ctx``'s device trace and the recorder's ``snap``,
    or None."""
    tr = ctx.get("trace")
    pairs = snap["counters"].get("kde_pairs", 0)
    if not tr or not pairs:
        return None
    t = kernel_seconds(tr["events"])
    if t <= 0:
        return None
    cfg = ctx["cfg"]
    nbytes = 0.0
    for s in snap["spans"]:
        p = s.get("counts", {}).get("kde_pairs", 0)
        if s["name"] == "kde_logpdf" and p:
            n, q = s["attrs"]["N"], s["attrs"]["Q"]
            nbytes += read_bytes(p // (n * q), n, q, cfg["point_dim"],
                                 cfg["dof"])
    return 100.0 * max(least_seconds(pairs, nbytes).values()) / t


def read(ctx):
    try:
        from incrementalinference_torch import tracing
    except ImportError:
        return None
    return compute(ctx, tracing.snapshot())

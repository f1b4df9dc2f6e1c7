"""The SE(3) KDE read kernel's share of its roofline, in %.

The work: the ``kde_pairs`` of the ``kde_logpdf`` spans whose ``manifold``
attribute is ``SE3``, the (query, kernel) pairs read through the kernel on
SE(3) (members x Q x N a call).

The least time is the largest of three bounds, at ``lib/peaks.json``'s
rates:
- FP32 operations: ``FLOPS_PER_PAIR``, a lower bound on the arithmetic
  that any exact SE(3) log map and kernel weight need (``FLOPS`` counts
  it), at the FP32 rate (an FMA two operations);
- transcendentals: ``TRANSCENDENTALS_PER_PAIR`` a pair (the exponential,
  the angle, the square root), each evaluated on the special-function
  units and as a polynomial on the FP32 lanes at once, as
  ``kde_roofline_pct`` counts its exponential;
- bytes: ``kde_roofline_pct.read_bytes`` of each read.

The time divided by: the device time of the kernel's SE(3) instantiation
(``kde_lse_prep<SE3>``, ``kde_lse_partial<SE3>``), found by name.  The
split merge ``kde_lse_combine`` is one kernel for every manifold, so it
is not counted, and the share errs high by its few microseconds.  None
where the run was not traced, read no SE(3) pair through the kernel (a
checkout from before it, or whose spans carry no ``manifold``), or ran no
such kernel."""

from __future__ import annotations

from bench_port.metrics.kde_roofline_pct import read_bytes
from bench_port.metrics.pair_lse_roofline_pct import PEAKS

#: the SE(3) instantiation's kernels; the name of each holds all of a tuple
KERNELS = (("kde_lse_prep", "SE3"), ("kde_lse_partial", "SE3"))
POINT_DIM, DOF = 7, 6

#: FP32 operations a pair cannot do without, an add or a multiply each
FLOPS = {
    # r = conj(q_p) q_q: 16 products, 12 sums
    "quaternion product": 28,
    # q_t - p_t, and that difference turned by a 3 x 3 rotation: 9
    # products, 6 sums
    "translations' difference": 3,
    "rotation of the translation": 15,
    # |r_xyz|^2, then phi = r_xyz theta / |r_xyz|
    "rotation vector": 5 + 3,
    # V^-1 d = d - phi x d / 2 + c phi x (phi x d): two cross products
    # (6 products, 3 sums each), 6 products and 6 sums
    "V^-1 applied to the translation": 9 + 9 + 12,
    # six coordinates over their bandwidths, squared and summed
    "scaled square": 6 + 6 + 6,
}
FLOPS_PER_PAIR = sum(FLOPS.values())
#: the exponential of the weight, the angle, the square root of |r_xyz|^2
TRANSCENDENTALS_PER_PAIR = 3


def least_seconds(pairs: float, nbytes: float, peaks=PEAKS) -> dict:
    """The three bounds of ``pairs`` SE(3) pairs and ``nbytes`` bytes."""
    lane_rate = (peaks["sm_count"] * peaks["fp32_lanes_per_sm"]
                 * peaks["boost_clock_hz"])
    sfu_rate = (peaks["sm_count"] * peaks["mufu_per_sm_per_clock"]
                * peaks["boost_clock_hz"])
    return {"fp32": pairs * FLOPS_PER_PAIR / peaks["fp32_flops"],
            "transcendental": (pairs * TRANSCENDENTALS_PER_PAIR
                               / (lane_rate + sfu_rate)),
            "bytes": nbytes / peaks["hbm_bytes_per_s"]}


def kernel_seconds(events) -> float:
    return sum(e - s for name, s, e in events
               if any(all(k in name for k in ks) for ks in KERNELS)) / 1e6


def compute(ctx, snap):
    """The share from ``ctx``'s device trace and the recorder's ``snap``,
    or None."""
    tr = ctx.get("trace")
    if not tr:
        return None
    pairs, nbytes = 0, 0.0
    for s in snap["spans"]:
        p = s.get("counts", {}).get("kde_pairs", 0)
        if s["name"] == "kde_logpdf" and p and \
                s["attrs"].get("manifold") == "SE3":
            n, q = s["attrs"]["N"], s["attrs"]["Q"]
            pairs += p
            nbytes += read_bytes(p // (n * q), n, q, POINT_DIM, DOF)
    t = kernel_seconds(tr["events"])
    if not pairs or t <= 0:
        return None
    return 100.0 * max(least_seconds(pairs, nbytes).values()) / t


def read(ctx):
    try:
        from incrementalinference_torch import tracing
    except ImportError:
        return None
    return compute(ctx, tracing.snapshot())

"""Range-only multimodal localization (reference
generateGraph_EuclidDistance, src/services/CanonicalGraphExamples.jl:242-270,
and testEuclidDistance.jl), through the PyTorch port.

Two anchors at (100, 0) and (0, 100) each measure a 100 m range to an
unknown landmark.  Each range alone is a ring; their product is bimodal,
the two ring intersections at (0, 0) and (100, 100).  A third range, from
(100, 100), collapses the ambiguity onto (0, 0).

Run, from the repository root:

    PYTHONPATH=. python examples_torch/range_only.py [--device cpu] [--n N]

It runs on the CUDA device unless ``--device cpu`` is given, and exits
non-zero if the two-range solve misses the bars of
tests/test_solve.py:172-193 or the third range leaves the landmark off
(0, 0).
"""

import argparse

import torch

from incrementalinference_torch import (ContinuousEuclid, EuclidDistance,
                                        MvNormal, Normal, Prior,
                                        SolverParams, initfg, solve_tree)


def bar(cond, msg):
    if not cond:
        raise AssertionError(msg)


def mode_mass(fg, v, center, tol=25.0):
    p = fg.points(v)
    d = (p - torch.tensor(center, dtype=p.dtype, device=p.device)).norm(dim=1)
    return round(float((d < tol).float().mean()), 2)


def on_ring(fg, v, center, radius=100.0, tol=15.0):
    p = fg.points(v)
    d = (p - torch.tensor(center, dtype=p.dtype, device=p.device)).norm(dim=1)
    return float(((d - radius).abs() < tol).float().mean())


def build_two_ranges(device="cuda", n=100):
    fg = initfg(SolverParams(N=n), device=device)
    fg.add_variable("x1", ContinuousEuclid(2))
    fg.add_factor(["x1"], Prior(MvNormal([100.0, 0.0], [1.0, 1.0])))
    fg.add_variable("x2", ContinuousEuclid(2))
    fg.add_factor(["x2"], Prior(MvNormal([0.0, 100.0], [1.0, 1.0])))

    fg.add_variable("l1", ContinuousEuclid(2))
    fg.add_factor(["x1", "l1"], EuclidDistance(Normal(100.0, 1.0)))
    fg.add_factor(["x2", "l1"], EuclidDistance(Normal(100.0, 1.0)))
    return fg


def add_third_range(fg):
    fg.add_variable("x3", ContinuousEuclid(2))
    fg.add_factor(["x3"], Prior(MvNormal([100.0, 100.0], [1.0, 1.0])))
    fg.add_factor(["x3", "l1"], EuclidDistance(Normal(141.42, 1.0)))
    return fg


def build(device="cuda", n=100):
    """The whole graph, three ranges, unsolved."""
    return add_third_range(build_two_ranges(device, n))


def main(device="cuda", n=100):
    fg = build_two_ranges(device, n)
    solve_tree(fg)
    two = {"(0,0)": mode_mass(fg, "l1", (0.0, 0.0)),
           "(100,100)": mode_mass(fg, "l1", (100.0, 100.0))}
    print("two ranges → bimodal landmark:", two)
    # tests/test_solve.py:181-193, its 30 m radius and ring tolerance
    a = mode_mass(fg, "l1", (0.0, 0.0), tol=30.0)
    b = mode_mass(fg, "l1", (100.0, 100.0), tol=30.0)
    bar(a > 0.04 and b > 0.04 and a + b > 0.6,
        f"two ranges: mode shares {a} at (0,0), {b} at (100,100)")
    r1, r2 = on_ring(fg, "l1", (100.0, 0.0)), on_ring(fg, "l1", (0.0, 100.0))
    bar(r1 > 0.85 and r2 > 0.85, f"two ranges: on the rings {r1}, {r2}")

    # a third anchor disambiguates
    add_third_range(fg)
    solve_tree(fg)
    three = {"(0,0)": mode_mass(fg, "l1", (0.0, 0.0)),
             "(100,100)": mode_mass(fg, "l1", (100.0, 100.0))}
    print("three ranges → unimodal:", three)
    bar(three["(0,0)"] > 0.8 and three["(100,100)"] < 0.1,
        f"three ranges: {three}")
    return fg, {"two": two, "three": three, "rings": (r1, r2),
                "shares_30m": (a, b)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="range-only through the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100, help="particles")
    a = ap.parse_args()
    main(device=a.device, n=a.n)

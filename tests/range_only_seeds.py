"""The range-only ring bar over seeds, in both packages (not collected).

The two-range landmark graph of ``examples/range_only.py`` (two anchors
at (100, 0) and (0, 100), a 100 m range from each) is solved once for
each seed and particle count, by the JAX package and by the PyTorch port
on the CPU.  For each solve it prints the smaller of the landmark's two
ring shares (particles within 15 m of a 100 m ring) and, per package and
particle count, how many seeds miss the 0.85 bar of
``tests/test_solve.py::test_euclid_distance_multimodal``.  A bar that a
fair share of seeds miss in both packages tests the seed, not the port.

Run, from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/range_only_seeds.py \
        [--n 64 100] [--seeds 20]
"""

import argparse

import numpy as np
import torch

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it

BAR = 0.85


def ring_share(points):
    p = np.asarray(points, np.float64)
    return min(float(np.mean(np.abs(np.linalg.norm(p - np.array(c), axis=1)
                                    - 100.0) < 15.0))
               for c in ((100.0, 0.0), (0.0, 100.0)))


def solve_two_ranges(pkg, n, seed):
    """``pkg`` is ``jl`` or ``it``; the landmark's points after the solve."""
    device = {"device": "cpu"} if pkg is it else {}
    fg = pkg.initfg(pkg.SolverParams(N=n, seed=seed), **device)
    for v, at in (("x1", [100.0, 0.0]), ("x2", [0.0, 100.0])):
        fg.add_variable(v, pkg.ContinuousEuclid(2))
        fg.add_factor([v], pkg.Prior(pkg.MvNormal(at, [1.0, 1.0])))
    fg.add_variable("l1", pkg.ContinuousEuclid(2))
    for v in ("x1", "x2"):
        fg.add_factor([v, "l1"], pkg.EuclidDistance(pkg.Normal(100.0, 1.0)))
    pkg.solve_tree(fg)
    return np.asarray(fg.points("l1"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[64, 100])
    ap.add_argument("--seeds", type=int, default=20)
    a = ap.parse_args()
    torch.set_num_threads(2)
    for n in a.n:
        for name, pkg in (("jax", jl), ("port", it)):
            shares = [ring_share(solve_two_ranges(pkg, n, s))
                      for s in range(a.seeds)]
            misses = sum(x <= BAR for x in shares)
            print(f"{name} N={n} seeds 0-{a.seeds - 1}: "
                  + " ".join(f"{x:.3f}" for x in shares)
                  + f"; {misses} of {a.seeds} miss {BAR}", flush=True)


if __name__ == "__main__":
    main()

"""The two-variable 1-D line of upstream's test/testBasicGraphs.jl lines
186-210 (``bench_port/graphs/line.py`` with the ``line2-n50k``
configuration's parameters: priors at -1 and +1 with sigma 1, a
``LinearRelative`` of 0 with sigma 10 between them, measurements drawn
from the seed and the step) solved by ``solve_tree`` on the CPU at
N=1,024, against its exact posterior
(``bench_port/reference/linear_gaussian.py``).

Every product takes the large pair route, the benchmark cell's route at
N=50,000 (``LARGE_PAIR_THRESHOLD`` lowered here): the kernel's plain
version gives the row log-partitions, the blocked column draw the
columns.

The bars, each the worst over both variables:
- mean within 0.15 exact sds: the Monte Carlo error of 1,024 particles
  drawn through resampling stages (0.03 sd for independent draws, a few
  times that here); the clique's Gibbs chain, which multiplies each prior
  by the relative's message from the other belief itself, is off the
  exact posterior by a share of the relative's weak precision, 1/100 of
  the priors';
- ½ |log variance ratio| under 0.2: the kernel bandwidths at N=1,024
  widen each product by about 7 % (0.035), and the resampling noise of
  the variance;
- Kolmogorov-Smirnov distance under 0.1: 0.05 from 1,024 draws at the
  99th percentile, plus the widening;
- one particle in 500 at most kept bit for bit from graphinit's: float32
  values repeat by chance.
Sound runs read at most 0.043, 0.083 and 0.039 on seeds 21-26 and
3,000,000,017; the rows drawn by their negated log-partitions read 2.9-4
sds, 0.57-0.74 and 0.94-0.99 (seeds 21, 22)."""

from __future__ import annotations

import pytest
import torch

from bench_port.checks.marginals import gaps
from bench_port.graphs import line
from bench_port.reference import linear_gaussian
from incrementalinference_torch.ops import product

CFG = {"N": 1024, "graph_params": {"variables": 2,
                                   "priors": [[0, -1.0, 1.0], [1, 1.0, 1.0]],
                                   "relative": [0.0, 10.0]}}


@pytest.mark.parametrize("seed", [3_000_000_017, 21, 22])
def test_line2_solve_matches_the_exact_posterior(seed, monkeypatch):
    import incrementalinference_torch as it

    monkeypatch.setattr(product, "LARGE_PAIR_THRESHOLD", 1)
    fg, meas = line.build(CFG, seed, 1, "cpu", True)
    init = {lbl: fg.variables[lbl].beliefs["default"].points.clone()
            for lbl in meas["labels"]}
    it.solve_tree(fg)
    mean, cov = linear_gaussian.posterior(meas["labels"], meas["factors"])
    for k, lbl in enumerate(meas["labels"]):
        pts = fg.variables[lbl].beliefs["default"].points
        assert tuple(pts.shape) == (CFG["N"], 1)
        assert bool(torch.isfinite(pts).all())
        z, log_sd, ks = gaps(pts[:, 0], float(mean[k]), float(cov[k, k]))
        assert z < 0.15 and log_sd < 0.2 and ks < 0.1, (lbl, z, log_sd, ks)
        kept = (pts[:, None, 0] == init[lbl][None, :, 0]).any(dim=1)
        assert float(kept.double().mean()) <= 1 / 500, lbl


def test_the_measurements_are_the_seeds_and_the_steps():
    a = line.measurements(CFG, 5, 1)
    assert a == line.measurements(CFG, 5, 1)
    assert a != line.measurements(CFG, 5, 2)
    assert a != line.measurements(CFG, 6, 1)
    assert [vs for vs, _, _ in a["factors"]] == [["x0"], ["x1"],
                                                 ["x0", "x1"]]
    assert [s for _, _, s in a["factors"]] == [[1.0], [1.0], [10.0]]
    assert a["labels"] == ["x0", "x1"]

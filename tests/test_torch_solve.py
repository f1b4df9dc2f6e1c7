"""End-to-end nonparametric solves of the port on the CPU, at the bars of
the JAX package's tests, and the slice held against the JAX package from
identical starting particles."""

import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    jax_graph_to_arrays, jax_native_ordering)

import incrementalinference_torch as it
from incrementalinference_torch.ops import product as tp
from incrementalinference_torch.ops.kernels import row_lse


@pytest.mark.parametrize("fuse_clique", [True, False])
def test_line_step_bars(fuse_clique):
    """tests/test_fused_chain.py:19-26 on the port: the clique chain and the
    per-variable path run the same schedule."""
    fg = it.generate_line_step(
        12, graphinit=True, device="cpu",
        params=it.SolverParams(fuse_clique=fuse_clique))
    it.solve_tree(fg)
    for i in range(0, 13, 2):
        assert abs(float(fg.points(f"x{i}").mean()) - i) < 1.5, i


def _two_var_graph(N):
    """benchmarks/pallas_e2e_solve.py's graph at a CPU-sized N."""
    fg = it.initfg(it.SolverParams(N=N, batch_cliques=False), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)))
    fg.add_factor(["x1"], it.Prior(it.Normal(10.0, 1.0)))
    return fg


def test_two_var_solve_through_the_large_pair_path(monkeypatch):
    """With the threshold patched low, every two-proposal product of the
    solve goes through pair_product_tangent_large and the row_logsumexp
    wrapper (its plain version here: the tensors are on the CPU)."""
    monkeypatch.setattr(tp, "LARGE_PAIR_THRESHOLD", 1)
    seen = []

    def recording(muA, precA, muB, precB):
        # each member's B rows against its own first row (the product
        # calls it with a member axis, here a batch of one)
        seen.append(bool(torch.all(precB == precB[..., :1, :])))
        return row_lse.pair_row_logsumexp(muA, precA, muB, precB)

    monkeypatch.setattr(tp, "pair_row_logsumexp", recording)
    row_lse.reset_counts()
    fg = _two_var_graph(256)
    it.solve_tree(fg)
    assert row_lse.counts["calls"] > 0
    assert row_lse.counts["launches"] == 0          # no kernel on the CPU
    # the wrapper reads precB[0] only: B's rows must all be that row
    assert seen and all(seen)
    for v, mu in (("x0", 0.0), ("x1", 10.0)):
        pts = fg.points(v)[:, 0]
        # bars of benchmarks/pallas_e2e_solve.py; the exact posterior is
        # N(mu, 0.82^2) and 256 particles give a mean error sd ~0.05
        assert abs(float(pts.mean()) - mu) < 0.2, v
        assert 0.4 < float(pts.std()) < 1.5, v


def test_slice_matches_jax_from_identical_particles():
    """The JAX package initializes the graph; both packages solve from its
    particles (carried across by convert.graph_from_arrays)."""
    from incrementalinference.jl_tpu import (ContinuousScalar,
                                             LinearRelative, Normal, Prior,
                                             SolverParams, initfg,
                                             solve_tree)

    N = 256
    fj = initfg(SolverParams(N=N, batch_cliques=False))
    fj.add_variable("x0", ContinuousScalar)
    fj.add_factor(["x0"], Prior(Normal(0.0, 1.0)))
    fj.add_variable("x1", ContinuousScalar)
    fj.add_factor(["x0", "x1"], LinearRelative(Normal(10.0, 1.0)))
    fj.add_factor(["x1"], Prior(Normal(10.0, 1.0)))
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
    for v in ("x0", "x1"):
        np.testing.assert_array_equal(ft.points(v).numpy(),
                                      np.asarray(fj.points(v)))
    solve_tree(fj)
    it.solve_tree(ft)
    for v in ("x0", "x1"):
        pj = np.asarray(fj.points(v))[:, 0]
        pt = ft.points(v).numpy()[:, 0]
        # independent random streams, 256 particles each: the difference
        # of two means has sd ~0.07, of two stds ~0.05
        assert abs(pt.mean() - pj.mean()) < 0.25, v
        assert abs(pt.std() - pj.std()) < 0.2, v

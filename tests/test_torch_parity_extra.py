"""Public functions of the port held against the JAX package on identical
inputs: manifold_product (Euclidean(2) with full and partial proposals and
an old_points fill, SE(2)), propagate_belief and local_product, solve_graph,
tree.accessors.set_clique_data, kde_sample through
ManifoldKernelDensity.sample, and DFGVariableSummary/DFGFactorSummary.

The two packages draw from different random streams, so sampled results
are held at the JAX tests' bars and to each other within four standard
errors of the difference of two independent samples.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_graph_to_arrays,  # noqa: F401
                                jax_native_ordering, rng, t)

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import compat as jcompat
from incrementalinference.jl_tpu import manifolds as jman
from incrementalinference.jl_tpu.ops import product as jp
from incrementalinference.jl_tpu.tree import accessors as jacc
from incrementalinference_torch import compat as tcompat
from incrementalinference_torch import manifolds as tman
from incrementalinference_torch.ops import product as tp
from incrementalinference_torch.tree import accessors as tacc


def four_se(a, b):
    """Four standard errors of mean(a) - mean(b), per column."""
    return 4.0 * np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))


def four_se_std(a, b):
    """Four standard errors of std(a) - std(b) (normal approximation)."""
    return 4.0 * np.sqrt(a.var(0) / (2 * len(a)) + b.var(0) / (2 * len(b)))


def both_products(Mj, Mt, props, n_out, old=None, key=7):
    """manifold_product of both packages on the same proposals
    (points, bw, mask) and old points."""
    pj = [jp.Proposal(jnp.asarray(p), jnp.asarray(bw),
                      dim_mask=None if m is None else jnp.asarray(m))
          for p, bw, m in props]
    pt = [tp.Proposal(t(p), t(bw), dim_mask=None if m is None
                      else torch.as_tensor(m)) for p, bw, m in props]
    oj = None if old is None else jnp.asarray(old)
    ot = None if old is None else t(old)
    out_j = np.array(jp.manifold_product(Mj, pj, jax.random.PRNGKey(key),
                                         n_out, old_points=oj))
    out_t = tp.manifold_product(Mt, pt, key, n_out, old_points=ot).numpy()
    return out_j, out_t


def test_manifold_product_euclid_full_proposals():
    """tests/test_product.py test_gaussian_product_moments at N = 4,000:
    N(0, 4) x N(4, 4) ~ N(2, 2), KDE-widened."""
    r = rng(11)
    a = (2.0 * r.normal(size=(4000, 2))).astype(np.float32)
    b = (4.0 + 2.0 * r.normal(size=(4000, 2))).astype(np.float32)
    bw = np.float32([0.4, 0.4])
    out_j, out_t = both_products(jman.Euclidean(2), tman.Euclidean(2),
                                 [(a, bw, None), (b, bw, None)], 4000)
    for out in (out_j, out_t):
        assert np.all(np.abs(out.mean(0) - 2.0) < 0.35), out.mean(0)
        assert np.all((1.0 < out.std(0)) & (out.std(0) < 2.1)), out.std(0)
    assert np.all(np.abs(out_t.mean(0) - out_j.mean(0))
                  < four_se(out_t, out_j))
    assert np.all(np.abs(out_t.std(0) - out_j.std(0))
                  < four_se_std(out_t, out_j))


def test_manifold_product_partial_proposals_fill_from_old_points():
    """tests/test_product.py test_partial_proposal_keeps_old_dims at
    N = 4,000: dim 0 from the two partial proposals, dim 1 the old points'
    own values in both packages."""
    r = rng(12)
    n = 4000
    old = np.stack([np.zeros(n), 7.0 + 0.1 * r.normal(size=n)],
                   axis=1).astype(np.float32)
    a = np.stack([3.0 + 0.1 * r.normal(size=n), np.zeros(n)],
                 axis=1).astype(np.float32)
    bw, mask = np.float32([0.1, 1.0]), np.asarray([True, False])
    out_j, out_t = both_products(jman.Euclidean(2), tman.Euclidean(2),
                                 [(a, bw, mask), (a + 0.05, bw, mask)], n,
                                 old=old)
    for out in (out_j, out_t):
        assert abs(out[:, 0].mean() - 3.0) < 0.2
        assert abs(out[:, 1].mean() - 7.0) < 0.2
    np.testing.assert_allclose(out_t[:, 1], old[:, 1], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out_j[:, 1], old[:, 1], rtol=1e-6, atol=1e-5)
    assert abs(out_t[:, 0].mean() - out_j[:, 0].mean()) < \
        four_se(out_t[:, :1], out_j[:, :1])[0]


def test_manifold_product_single_full_proposal_passes_through():
    r = rng(13)
    pts = (5.0 + r.normal(size=(300, 2))).astype(np.float32)
    out_j, out_t = both_products(jman.Euclidean(2), tman.Euclidean(2),
                                 [(pts, np.float32([0.3, 0.3]), None)], 200)
    np.testing.assert_array_equal(out_t, pts[:200])
    np.testing.assert_array_equal(out_j, pts[:200])


def test_manifold_product_se2():
    """Two SE(2) proposals around nearby poses: the Karcher means of the
    two packages' products within 0.04 of each other, the tangent
    standard deviations within four standard errors."""
    r = rng(14)
    n = 4000
    Mj, Mt = jman.SE2(), tman.SE2()

    def cloud(x, y, th, s):
        return np.stack([x + s[0] * r.normal(size=n),
                         y + s[1] * r.normal(size=n),
                         th + s[2] * r.normal(size=n)], 1).astype(np.float32)

    a = cloud(1.0, 2.0, 0.3, (0.4, 0.4, 0.1))
    b = cloud(1.3, 1.8, 0.35, (0.4, 0.4, 0.1))
    bw = np.float32([0.15, 0.15, 0.04])
    out_j, out_t = both_products(Mj, Mt, [(a, bw, None), (b, bw, None)], n)
    mu_t = Mt.mean(torch.as_tensor(out_t))
    mu_j = Mt.mean(torch.as_tensor(out_j))
    assert float(Mt.dist(mu_t, mu_j)) < 0.04, (mu_t, mu_j)
    # the analytic product of the two clouds' Gaussians, coordinate-wise
    assert float(Mt.dist(mu_t, torch.tensor([1.15, 1.9, 0.325]))) < 0.1
    Xt = Mt.log(mu_t[None], torch.as_tensor(out_t)).numpy()
    Xj = Mt.log(mu_t[None], torch.as_tensor(out_j)).numpy()
    assert np.all(np.abs(Xt.std(0) - Xj.std(0)) < four_se_std(Xt, Xj))


# ------------------------------------------- graphs carried between them

def five_chain(pkg, N=400, **kw):
    """tests/test_basic_graphs.py test_five_variable_chain_ordered_means."""
    fg = pkg.initfg(pkg.SolverParams(N=N), **kw)
    for i in range(5):
        fg.add_variable(f"x{i}", pkg.ContinuousScalar)
    fg.add_factor(["x0"], pkg.Prior(pkg.Normal(-3.0, 1.0)))
    fg.add_factor(["x4"], pkg.Prior(pkg.Normal(+3.0, 1.0)))
    for i in range(4):
        fg.add_factor([f"x{i}", f"x{i+1}"],
                      pkg.LinearRelative(pkg.Normal(0.0, 1.0)))
    return fg


def test_local_product_and_propagate_belief_match_jax():
    """The JAX package's initialised five-chain carried to the port: the
    products at x2 over all its factors and over one of them agree in
    moments, and infoPerCoord exactly."""
    fj = five_chain(jl)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
    bj, ipc_j = jl.local_product(fj, "x2")
    bt, ipc_t = it.local_product(ft, "x2")
    np.testing.assert_array_equal(ipc_t.numpy(), np.asarray(ipc_j))
    pj, pt = np.asarray(bj.points), bt.points.numpy()
    assert pt.shape == pj.shape
    assert np.all(np.abs(pt.mean(0) - pj.mean(0)) < four_se(pt, pj))
    assert np.all(np.abs(pt.std(0) - pj.std(0)) < four_se_std(pt, pj))
    one = [f for f in fj.factors_of("x2") if "x1" in fj.factor(f).variables]
    assert one and one == [f for f in ft.factors_of("x2")
                           if "x1" in ft.factor(f).variables]
    bj, ipc_j = jl.propagate_belief(fj, "x2", one)
    bt, ipc_t = it.propagate_belief(ft, "x2", one)
    np.testing.assert_array_equal(ipc_t.numpy(), np.asarray(ipc_j))
    pj, pt = np.asarray(bj.points), bt.points.numpy()
    assert np.all(np.abs(pt.mean(0) - pj.mean(0)) < four_se(pt, pj))
    assert np.all(np.abs(pt.std(0) - pj.std(0)) < four_se_std(pt, pj))


def test_solve_graph_at_the_bars_of_test_basic_graphs():
    """solve_graph (the alias of solve_tree) on the five-chain: the tree's
    cliques frontal for frontal as the JAX package's, the posteriors at
    the bars of tests/test_basic_graphs.py:121-145."""
    fj, ft = five_chain(jl, N=100), five_chain(it, N=100, device="cpu")
    tj, tt = jl.solve_graph(fj), it.solve_graph(ft)
    assert sorted(tuple(c.frontals) for c in tt.cliques.values()) == \
        sorted(tuple(c.frontals) for c in tj.cliques.values())
    means = [float(ft.points(f"x{i}").mean()) for i in range(5)]
    assert all(a < b for a, b in zip(means, means[1:])), means
    assert abs(means[0] + means[4]) < 2.2
    assert abs(means[1] + means[3]) < 2.2
    assert abs(means[2]) < 2.2
    for i in range(5):
        var = float(ft.points(f"x{i}")[:, 0].var())
        assert 0.2 < var < 3.2, (i, var)


def test_set_clique_data_matches_jax():
    """set_clique_data moves a clique to another id in both packages'
    trees of the same graph: the ids, the frontal map and the clique."""
    fj = jl.canonical.generate_line_step(6, graphinit=False)
    ft = it.generate_line_step(6, graphinit=False, device="cpu")
    trj, trt = jl.build_tree_reset(fj), it.build_tree_reset(ft)
    assert trt.frontal_to_clique == trj.frontal_to_clique
    cj, ct = jacc.get_clique(trj, "x2"), tacc.get_clique(trt, "x2")
    new = max(trj.cliques) + 5
    assert jacc.set_clique_data(trj, new, cj) is cj
    assert tacc.set_clique_data(trt, new, ct) is ct
    assert ct.cid == cj.cid == new
    assert sorted(trt.cliques) == sorted(trj.cliques)
    assert trt.frontal_to_clique == trj.frontal_to_clique
    assert tacc.get_clique_data(trt, new) is ct
    assert list(ct.frontals) == list(cj.frontals)


@pytest.mark.parametrize("dof", [1, 2])
def test_kde_sample_through_manifold_kernel_density(dof):
    """ManifoldKernelDensity on the same points: the LOO bandwidth equal
    to float32 rounding, and 20,000 draws of each package's
    ``sample`` at the KDE's moments (mean of the points; variance of the
    points plus bw^2) and each other's."""
    r = rng(20 + dof)
    pts = (r.normal(size=(500, dof)) * np.arange(1, dof + 1)
           + 3.0).astype(np.float32)
    mj = jl.ManifoldKernelDensity(jman.Euclidean(dof), jnp.asarray(pts))
    mt = it.ManifoldKernelDensity(tman.Euclidean(dof), t(pts))
    np.testing.assert_allclose(mt.bw.numpy(), np.asarray(mj.belief.bw), rtol=1e-5)
    n = 20_000
    sj = np.asarray(mj.sample(jax.random.PRNGKey(3), n))
    st = mt.sample(it.keys.generator(3, "cpu"), n).numpy()
    assert st.shape == sj.shape == (n, dof)
    var = pts.var(0) + mt.bw.numpy() ** 2
    for s in (sj, st):
        assert np.all(np.abs(s.mean(0) - pts.mean(0))
                      < 4.0 * np.sqrt(var / n))
        assert np.all(np.abs(s.var(0) - var) < 4.0 * var * np.sqrt(2.0 / n)
                      + 0.05 * var)
    assert np.all(np.abs(st.mean(0) - sj.mean(0)) < four_se(st, sj))


def test_dfg_summaries_match_jax():
    """DFGVariableSummary and DFGFactorSummary: the same fields, and equal
    summaries of the same graph in both packages."""
    for cj, ct in ((jcompat.DFGVariableSummary, tcompat.DFGVariableSummary),
                   (jcompat.DFGFactorSummary, tcompat.DFGFactorSummary)):
        assert [f.name for f in dataclasses.fields(ct)] == \
            [f.name for f in dataclasses.fields(cj)]
        assert ct.__dataclass_params__.frozen and cj.__dataclass_params__.frozen
    assert it.DFGVariableSummary is tcompat.DFGVariableSummary
    assert it.DFGFactorSummary is tcompat.DFGFactorSummary

    def graph(pkg, **kw):
        fg = pkg.initfg(pkg.SolverParams(N=50), **kw)
        fg.add_variable("x0", pkg.ContinuousScalar, tags=("POSE",))
        fg.add_variable("l1", pkg.ContinuousEuclid(2), tags=("LANDMARK",))
        fg.add_variable("x1", pkg.ContinuousScalar, solvable=0)
        fg.add_factor(["x0"], pkg.Prior(pkg.Normal(0.0, 1.0)),
                      tags=("PRIOR",))
        fg.add_factor(["x0", "x1"], pkg.LinearRelative(pkg.Normal(1.0, 1.0)))
        return fg

    fj, ft = graph(jl), graph(it, device="cpu")

    def fields(summary):
        d = dataclasses.asdict(summary)
        assert isinstance(d.pop("timestamp"), float)   # creation time
        return d

    for v in fj.ls():
        assert fields(tcompat.variable_summary(ft.var(v))) == \
            fields(jcompat.variable_summary(fj.var(v)))
    for f in fj.lsf():
        assert fields(tcompat.factor_summary(ft.factor(f))) == \
            fields(jcompat.factor_summary(fj.factor(f)))

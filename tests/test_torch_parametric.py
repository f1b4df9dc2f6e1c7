"""The parametric stack of the port against the JAX package, on the CPU.

Every case of tests/test_parametric.py runs on the port at its own bar.
Each graph is built once, in the JAX package, from numpy values and a seed,
and carried into the port through convert.py; both packages then solve it.
Points agree to atol 1e-4 and covariances to rtol 1e-3, entries near zero
to 1e-3 of the block's largest: both run float32 Levenberg-Marquardt to the
same stopping rule, and the port's sums run in another order (no padding).  The pieces under the solve (GaussianJoint's
residual, the whitening, the stacked residual and Jacobian, JᵀJ and Jᵀr by
variable, the covariance) are held at the same tangent coordinates and
linearization points.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_graph_to_arrays, rng, t

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import manifolds as jm
from incrementalinference.jl_tpu.canonical import generate_line_step as \
    j_line_step
from incrementalinference.jl_tpu.models.factors import GaussianJoint as \
    JGaussianJoint
from incrementalinference.jl_tpu.parametric import solver as js
from incrementalinference_torch.manifolds import SE2, SE3
from incrementalinference_torch.parametric import solver as ts
from incrementalinference_torch.tree.bayestree import CliqStatus

CPU = "cpu"


def port(fj):
    """The JAX graph's twin in the port (beliefs and parametric state
    included)."""
    return it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)


def pt(fg, v) -> np.ndarray:
    return np.asarray(fg.var(v).parametric_point, np.float32)


def cov(fg, v) -> np.ndarray:
    return np.asarray(fg.var(v).parametric_cov, np.float32)


def assert_same_solution(fj, ft, labels=None, atol=1e-4, rtol=1e-3,
                         with_cov=True):
    for v in labels or fj.ls():
        np.testing.assert_allclose(pt(ft, v), pt(fj, v), atol=atol,
                                   err_msg=v)
        if with_cov:
            want = cov(fj, v)
            np.testing.assert_allclose(cov(ft, v), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(),
                                       err_msg=v)


def truth_of(v: str) -> float:
    return float(v[1:] if v[0] == "x" else v[2:])


# -- the cases of tests/test_parametric.py --------------------------------

def test_line_step_exact():
    fj = j_line_step(10, graphinit=False)
    ft = port(fj)
    res = it.solve_graph_parametric(ft)
    for v in ft.ls():
        assert abs(pt(ft, v)[0] - truth_of(v)) < 1e-3, v
        c = cov(ft, v)[0, 0]
        assert np.isfinite(c) and c > 0.0
    assert float(res["_cost"]) < 1e-6
    assert res["_cost"].dtype == torch.float32
    js.solve_graph_parametric(fj)
    assert_same_solution(fj, ft)


def _odometry_chain(n=5, sigma_rel=0.5):
    fg = jl.initfg()
    fg.add_variable("x0", jl.ContinuousScalar)
    fg.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 0.1)), graphinit=False)
    for i in range(1, n):
        fg.add_variable(f"x{i}", jl.ContinuousScalar)
        fg.add_factor([f"x{i-1}", f"x{i}"],
                      jl.LinearRelative(jl.Normal(1.0, sigma_rel)),
                      graphinit=False)
    return fg


def test_covariance_grows_along_chain():
    fj = _odometry_chain()
    ft = port(fj)
    it.solve_graph_parametric(ft)
    covs = [cov(ft, f"x{i}")[0, 0] for i in range(5)]
    assert all(covs[i] < covs[i + 1] for i in range(4)), covs
    js.solve_graph_parametric(fj)
    assert_same_solution(fj, ft)


def test_conditionals_pin_separators():
    fj = jl.initfg()
    fj.add_variable("a", jl.ContinuousScalar)
    fj.add_variable("b", jl.ContinuousScalar)
    fj.add_factor(["a"], jl.Prior(jl.Normal(0.0, 1.0)), graphinit=False)
    fj.add_factor(["a", "b"], jl.LinearRelative(jl.Normal(10.0, 1.0)),
                  graphinit=False)
    fj.var("a").parametric_point = jnp.asarray([100.0])   # pinned away
    ft = port(fj)
    it.solve_conditionals_parametric(ft, ["b"], ["a"])
    assert abs(pt(ft, "b")[0] - 110.0) < 1e-2
    assert pt(ft, "a")[0] == 100.0                        # did not move
    js.solve_conditionals_parametric(fj, ["b"], ["a"])
    assert_same_solution(fj, ft, labels=["b"])


def test_max_mixture_picks_nearest_mode():
    fj = jl.initfg()
    fj.add_variable("x", jl.ContinuousScalar)
    fj.add_factor(["x"], jl.Mixture(jl.Prior, [jl.Normal(-50.0, 2.0),
                                               jl.Normal(50.0, 2.0)],
                                    [0.5, 0.5]), graphinit=False)
    fj.add_factor(["x"], jl.Prior(jl.Normal(40.0, 10.0)), graphinit=False)
    fj.var("x").parametric_point = jnp.asarray([40.0])
    ft = port(fj)
    it.solve_graph_parametric(ft)
    assert abs(pt(ft, "x")[0] - 50.0) < 5.0
    js.solve_graph_parametric(fj)
    assert_same_solution(fj, ft)


def test_autoinit_parametric_chain():
    fj = j_line_step(6, graphinit=False)
    ft = port(fj)
    it.autoinit_parametric(ft)
    for v in ft.ls():
        assert ft.var(v).parametric_point is not None
        assert abs(pt(ft, v)[0] - truth_of(v)) < 0.5, v
    js.autoinit_parametric(fj)
    assert_same_solution(fj, ft)


def test_parametric_tree_solve_matches_batch():
    fj = j_line_step(10, graphinit=False)
    ft = port(fj)
    tree = it.solve_tree(ft, algorithm="parametric")
    assert all(c.status == CliqStatus.DOWNSOLVED
               for c in tree.cliques.values())
    for v in ft.ls():
        assert abs(pt(ft, v)[0] - truth_of(v)) < 0.05, v
        c = cov(ft, v)[0, 0]
        assert np.isfinite(c) and c > 0
        assert ft.var(v).get_solved_count("parametric") == 1
    jl.solve_tree(fj, algorithm="parametric")
    assert_same_solution(fj, ft)


def test_covariance_consistent_with_particle_spread():
    """The two stacks of the port agree on a linear-Gaussian chain (the
    JAX test's bars).  The parametric solve starts from the beliefs'
    means, which differ between the packages' random streams, but lands on
    the same optimum: a linear problem."""
    ft = it.initfg(device=CPU)
    ft.add_variable("x0", it.ContinuousScalar)
    ft.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    for i in range(1, 4):
        ft.add_variable(f"x{i}", it.ContinuousScalar)
        ft.add_factor([f"x{i-1}", f"x{i}"],
                      it.LinearRelative(it.Normal(2.0, 1.0)))
    it.solve_tree(ft)
    it.solve_graph_parametric(ft)
    for i in range(4):
        pts = ft.points(f"x{i}")[:, 0].numpy()
        q_std = float(np.sqrt(cov(ft, f"x{i}")[0, 0]))
        assert 0.4 * q_std < pts.std() < 2.5 * q_std, (i, pts.std(), q_std)
        assert abs(pts.mean() - pt(ft, f"x{i}")[0]) < 3.0 * max(q_std, 0.5)
        np.testing.assert_allclose(pt(ft, f"x{i}")[0], 2.0 * i, atol=1e-4)
        # the closed form: variance 1 + i of a chain of unit variances
        np.testing.assert_allclose(cov(ft, f"x{i}")[0, 0], 1.0 + i,
                                   rtol=1e-3)


def _forest(nb=8):
    fg = jl.initfg()
    for b in range(nb):
        fg.add_variable(f"b{b}x0", jl.ContinuousScalar)
        fg.add_factor([f"b{b}x0"], jl.Prior(jl.Normal(float(b), 0.5)),
                      graphinit=False)
        fg.add_variable(f"b{b}x1", jl.ContinuousScalar)
        fg.add_factor([f"b{b}x0", f"b{b}x1"],
                      jl.LinearRelative(jl.Normal(1.0, 0.5)),
                      graphinit=False)
    return fg


def test_batched_wide_forest_tree_solve():
    fj = _forest()
    ft = port(fj)
    tree = it.solve_tree(ft, algorithm="parametric")
    for b in range(8):
        e0, e1 = pt(ft, f"b{b}x0")[0], pt(ft, f"b{b}x1")[0]
        assert abs(e0 - b) < 1e-3 and abs(e1 - (b + 1)) < 1e-3, (b, e0, e1)
        c = cov(ft, f"b{b}x1")[0, 0]
        assert np.isfinite(c) and c > 0
    # the eight same-structure cliques of a level went as one batch
    assert max(tree.param_batches) == 8, tree.param_batches
    jl.solve_tree(fj, algorithm="parametric")
    assert_same_solution(fj, ft)


def test_solve_problems_batched_matches_sequential():
    """A batch gives each member its sequential result: the members stop
    at different iterations (priors at different distances), and finished
    ones stay put while the rest go on."""
    fgs = []
    for b in range(5):
        fj = jl.initfg()
        fj.add_variable("x0", jl.ContinuousScalar)
        fj.add_factor(["x0"], jl.Prior(jl.Normal(float(b) ** 3, 0.3)),
                      graphinit=False)
        fj.add_variable("x1", jl.ContinuousScalar)
        fj.add_factor(["x0", "x1"], jl.LinearRelative(jl.Normal(2.0, 0.4)),
                      graphinit=False)
        fgs.append(port(fj))
    sizes = []
    batched = ts.solve_problems_batched(
        [ts.ParametricProblem(fg) for fg in fgs], batch_sizes=sizes)
    assert sizes == [5]
    seq = [ts.ParametricProblem(fg).solve() for fg in fgs]
    for (bp, bc, bcost), (sp, sc, scost) in zip(batched, seq):
        for pb, ps in zip(bp, sp):
            np.testing.assert_allclose(pb.numpy(), ps.numpy(), atol=1e-5)
        np.testing.assert_allclose(bc.numpy(), sc.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(bcost), float(scost), atol=1e-6)


def _multihypo_graph():
    fg = jl.initfg()
    fg.add_variable("x0", jl.ContinuousScalar)
    fg.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 0.5)), graphinit=False)
    for lbl, mu in (("l1", 10.0), ("l2", 50.0)):
        fg.add_variable(lbl, jl.ContinuousScalar)
        fg.add_factor([lbl], jl.Prior(jl.Normal(mu, 1.0)), graphinit=False)
    fg.add_factor(["x0", "l1", "l2"], jl.LinearRelative(jl.Normal(10.0, 1.0)),
                  multihypo=[1.0, 0.5, 0.5], graphinit=False)
    return fg


def test_parametric_max_multihypo_association():
    fj = _multihypo_graph()
    ft = port(fj)
    it.solve_graph_parametric(ft)
    x0, l1, l2 = (pt(ft, v)[0] for v in ("x0", "l1", "l2"))
    assert abs(x0) < 0.6 and abs(l1 - 10) < 1.0 and abs(l2 - 50) < 1.0
    js.solve_graph_parametric(fj)
    assert_same_solution(fj, ft)


def _nullhypo_graph(nullhypo):
    fg = jl.initfg()
    fg.add_variable("x0", jl.ContinuousScalar)
    fg.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 0.5)), graphinit=False)
    for i in (1, 2):
        fg.add_variable(f"x{i}", jl.ContinuousScalar)
        fg.add_factor([f"x{i-1}", f"x{i}"],
                      jl.LinearRelative(jl.Normal(10.0, 0.5)),
                      graphinit=False)
    kw = {"nullhypo": nullhypo} if nullhypo else {}
    fg.add_factor(["x0", "x2"], jl.LinearRelative(jl.Normal(70.0, 0.5)),
                  graphinit=False, **kw)
    return fg


@pytest.mark.parametrize("nullhypo", [0.2, 0.0])
def test_parametric_max_nullhypo_outlier_gate(nullhypo):
    fj = _nullhypo_graph(nullhypo)
    ft = port(fj)
    it.solve_graph_parametric(ft)
    x2 = pt(ft, "x2")[0]
    if nullhypo:
        assert abs(x2 - 20.0) < 1.0, x2          # outlier gated out
    else:
        assert x2 > 25.0, x2                     # ungated outlier drags
    js.solve_graph_parametric(fj)
    assert_same_solution(fj, ft)


def _chain(n, pkg=jl, **kw):
    fg = pkg.initfg(pkg.SolverParams(incremental=True, graphinit=False), **kw)
    fg.add_variable("x0", pkg.ContinuousScalar)
    fg.add_factor(["x0"], pkg.Prior(pkg.Normal(0.0, 0.5)), graphinit=False)
    for i in range(n):
        fg.add_variable(f"x{i+1}", pkg.ContinuousScalar)
        fg.add_factor([f"x{i}", f"x{i+1}"],
                      pkg.LinearRelative(pkg.Normal(1.0, 0.1)),
                      graphinit=False)
    return fg


def test_parametric_tree_recycling_incremental():
    """Growing the chain and re-solving with the old tree re-sends the
    untouched subtrees' Gaussian up messages and matches a solve from
    scratch, and the JAX package's incremental solve of the same graphs."""
    fj = _chain(8)
    ft = port(fj)
    tree = it.solve_tree(ft, algorithm="parametric")
    jtree = jl.solve_tree(fj, algorithm="parametric")
    assert tree.param_up_msgs
    for pkg, fg in ((it, ft), (jl, fj)):
        fg.add_variable("x9", fg.var("x8").vartype)
        fg.add_factor(["x8", "x9"], pkg.LinearRelative(pkg.Normal(1.0, 0.1)),
                      graphinit=False)
    tree2 = it.solve_tree(ft, algorithm="parametric", old_tree=tree)
    jl.solve_tree(fj, algorithm="parametric", old_tree=jtree)
    recycled = [cl for cl in tree2.cliques.values() if cl.is_recycled]
    assert len(recycled) >= 3, len(recycled)
    assert all(cl.status == CliqStatus.DOWNSOLVED
               for cl in tree2.cliques.values())
    fresh = _chain(9, it, device=CPU)
    it.solve_tree(fresh, algorithm="parametric")
    for v in ft.ls():
        np.testing.assert_allclose(pt(ft, v), pt(fresh, v), atol=1e-3)
    assert_same_solution(fj, ft)


def test_init_parametric_from_beliefs():
    """initParametricFrom! on identical particles (the JAX graph's beliefs
    carried across): the same means and covariances; then the tree solve
    from those seeds."""
    fj = jl.initfg()
    fj.add_variable("x0", jl.ContinuousScalar)
    fj.add_factor(["x0"], jl.Prior(jl.Normal(5.0, 0.5)))
    fj.add_variable("x1", jl.ContinuousScalar)
    fj.add_factor(["x0", "x1"], jl.LinearRelative(jl.Normal(10.0, 0.5)))
    ft = port(fj)
    assert it.init_parametric_from(ft) == 2
    assert js.init_parametric_from(fj) == 2
    for v, truth in (("x0", 5.0), ("x1", 15.0)):
        mu = pt(ft, v)[0]
        assert abs(mu - ft.points(v)[:, 0].numpy().mean()) < 1e-5
        assert abs(mu - truth) < 2.0
        c = cov(ft, v)
        assert np.all(np.isfinite(c)) and c[0, 0] > 0
    assert_same_solution(fj, ft, atol=1e-5, rtol=1e-5)
    ft.var("x0").parametric_point = torch.tensor([99.0])
    assert it.init_parametric_from(ft, only_missing=True) == 0
    ft.var("x0").parametric_point = None
    it.solve_tree(ft, algorithm="parametric")
    assert abs(pt(ft, "x1")[0] - 15.0) < 0.2


def test_batched_grouping_keys_on_real_layout():
    """Problems batch only where their layouts agree.  The port has no
    padding, so the 5-variable and 6-variable chains of the JAX test (equal
    padded shapes there) differ already in their type counts; both solve,
    each from its own layout."""
    def chain(n, extra_rel=False):
        fg = it.initfg(device=CPU)
        for i in range(n):
            fg.add_variable(f"x{i}", it.ContinuousScalar)
            fg.add_factor([f"x{i}"], it.Prior(it.Normal(float(10 * i), 1.0)),
                          graphinit=False)
            if i:
                fg.add_factor([f"x{i-1}", f"x{i}"],
                              it.LinearRelative(it.Normal(10.0, 1.0)),
                              graphinit=False)
        if extra_rel:
            fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)),
                          graphinit=False)
        return fg

    pa = ts.ParametricProblem(chain(5, extra_rel=True))
    pb = ts.ParametricProblem(chain(6))
    pc = ts.ParametricProblem(chain(6))
    assert pa.signature() != pb.signature() == pc.signature()
    sizes = []
    res = ts.solve_problems_batched([pa, pb, pc], batch_sizes=sizes)
    assert sorted(sizes) == [1, 2]
    assert len(res[0][0]) == 5 and len(res[1][0]) == 6
    for i in range(5):
        assert abs(float(res[0][0][i][0]) - 10.0 * i) < 0.5
    for i in range(6):
        assert abs(float(res[1][0][i][0]) - 10.0 * i) < 0.5
        np.testing.assert_allclose(res[1][0][i].numpy(),
                                   res[2][0][i].numpy(), atol=1e-6)
    assert len(pa.p0) == 5 and len(pb.p0) == 6


def test_cg_solver_matches_dense_and_jax():
    """The matrix-free LM reproduces the dense solve (the JAX test's bar,
    1e-2) and the JAX package's CG solve.  CG runs 200 float32 iterations
    an LM step on both sides, ending within about 1e-5 of the optimum;
    held at 1e-3."""
    fd = port(j_line_step(60, graphinit=False))
    it.solve_graph_parametric(fd)
    fj = j_line_step(60, graphinit=False)
    fc = port(fj)
    res = it.solve_graph_parametric(fc, solver="cg", compute_cov=False)
    assert res["x0"]["cov"] is None and fc.var("x0").parametric_cov is None
    for v in fd.ls():
        assert np.allclose(pt(fd, v), pt(fc, v), atol=1e-2), v
        assert abs(pt(fc, v)[0] - truth_of(v)) < 1e-2, v
    js.solve_graph_parametric(fj, solver="cg", compute_cov=False)
    assert_same_solution(fj, fc, atol=1e-3, with_cov=False)


def test_cg_matches_a_direct_solve():
    """_cg on a small SPD system, one member per row, against
    torch.linalg.solve; a member with b = 0 stays at zero."""
    r = rng(3)
    A = r.standard_normal((2, 6, 6)).astype(np.float32)
    A = t(A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32))
    b = t(r.standard_normal((2, 6)))
    b[1] = 0.0
    x = ts._cg(lambda v: (A @ v[..., None])[..., 0], b, 200, 1e-12)
    want = torch.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-5)
    assert float(x[1].abs().max()) == 0.0


# -- the pieces at the same inputs -------------------------------------------

def _pieces_graph(seed):
    """One group of each kind: Euclidean, SE(2) and SE(3) priors and
    relatives, a Mixture, a multihypo and a nullhypo factor, the hexagon's
    landmark factor and a GaussianJoint over an SE(2) and an SE(3) pose,
    with linearization points drawn from ``seed``."""
    r = rng(seed)
    se2, se3 = jm.SE2(), jm.SE3()
    fg = jl.initfg(jl.SolverParams(graphinit=False))
    for v in ("x0", "x1", "l1", "l2"):
        fg.add_variable(v, jl.ContinuousScalar)
    fg.add_variable("l3", jl.ContinuousEuclid(2))
    for v in ("p0", "p1"):
        fg.add_variable(v, jl.VariableType("Pose2", se2))
    for v in ("q0", "q1"):
        fg.add_variable(v, jl.VariableType("Pose3", se3))
    fg.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 0.5)))
    fg.add_factor(["x0", "x1"], jl.LinearRelative(jl.Normal(10.0, 0.5)))
    fg.add_factor(["x0", "x1"], jl.LinearRelative(jl.Normal(40.0, 0.5)),
                  nullhypo=0.2)
    fg.add_factor(["x1"], jl.Mixture(jl.Prior, [jl.Normal(8.0, 2.0),
                                                jl.Normal(12.0, 1.0)],
                                     [0.4, 0.6]))
    fg.add_factor(["l1"], jl.Prior(jl.Normal(10.0, 1.0)))
    fg.add_factor(["l2"], jl.Prior(jl.Normal(50.0, 1.0)))
    fg.add_factor(["x0", "l1", "l2"], jl.LinearRelative(jl.Normal(10.0, 1.0)),
                  multihypo=[1.0, 0.5, 0.5])
    p_prior = np.array([1.0, -2.0, 0.4], np.float32)
    fg.add_factor(["p0"], jl.ManifoldPrior(
        se2, p_prior, jl.MvNormal([0.0] * 3, [0.1, 0.2, 0.05])))
    fg.add_factor(["p0", "p1"], jl.ManifoldFactor(
        se2, jl.MvNormal([10.0, 0.0, math.pi / 3], [0.5, 0.5, 0.05])))
    fg.add_factor(["p1", "l3"], jl.canonical._Pose2Point2Bearingless())
    q_prior = np.asarray(se3.exp(se3.identity(), jnp.asarray(
        r.standard_normal(6).astype(np.float32) * 0.3)))
    fg.add_factor(["q0"], jl.ManifoldPrior(
        se3, q_prior, jl.MvNormal(np.zeros(6), [0.01] * 6)))
    fg.add_factor(["q0", "q1"], jl.ManifoldFactor(
        se3, jl.MvNormal([1.0, 0.0, 0.05, 0.0, 0.0, 0.02], [0.01] * 6)))
    msg_pts = [np.asarray(se2.exp(se2.identity(), jnp.asarray(
                   r.standard_normal(3).astype(np.float32)))),
               np.asarray(se3.exp(se3.identity(), jnp.asarray(
                   r.standard_normal(6).astype(np.float32))))]
    L = r.standard_normal((9, 9)).astype(np.float32)
    fg.add_factor(["p1", "q1"], JGaussianJoint(
        [se2, se3], msg_pts, L @ L.T / 9 + 0.1 * np.eye(9, dtype=np.float32)))
    # linearization points
    for v in fg.ls():
        m = fg.var(v).manifold
        X = r.standard_normal(m.dof).astype(np.float32)
        if m.dof == 1:
            X = X * 5 + truth_of(v) * 10 if v.startswith("x") else X + 10
        fg.var(v).parametric_point = np.asarray(
            m.exp(m.identity(), jnp.asarray(X)), np.float32)
    return fg


def _layouts(pj, pt_):
    """Per label: (JAX offset, port offset, dof)."""
    return [(int(pj.offsets[pj.slot[v]]), int(pt_.offsets[pt_.slot[v]]),
             pj.dofs[pj.slot[v]]) for v in pj.var_labels]


def _to_port_cols(A, lay, D):
    """JAX-layout columns of A moved to the port's layout (padding
    dropped)."""
    out = np.zeros(A.shape[:-1] + (D,), np.float32)
    for oj, ot, d in lay:
        out[..., ot:ot + d] = A[..., oj:oj + d]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_residuals_and_jacobians_against_jax(seed):
    fj = _pieces_graph(seed)
    ft = port(fj)
    pj, pT = js.ParametricProblem(fj), ts.ParametricProblem(ft)
    assert pT.var_labels == pj.var_labels          # grouped by manifold
    lay, D = _layouts(pj, pT), pT.total_dof
    r = rng(100 + seed)
    xj = np.zeros(pj.total_dof, np.float32)
    for oj, _, d in lay:
        xj[oj:oj + d] = 0.3 * r.standard_normal(d)
    xt = torch.as_tensor(_to_port_cols(xj, lay, D))

    rj, Jj = (np.asarray(a) for a in jax.jit(
        lambda p, x, p0s: p.res_jac(x, p0s))(pj, jnp.asarray(xj),
                                             pj._p0_stacked()))
    rT, JT = pT.res_jac(xt)
    assert JT.dtype == torch.float32 and rT.dtype == torch.float32
    # group by group, the real rows of JAX's padded ones
    assert len(pT.groups) == len(pj.groups)
    o, gate_rows = 0, None
    for gT, gj in zip(pT.groups, pj.groups):
        n = gT.meas.shape[0] * gT.meas.shape[1]
        if gT.null_p is not None:
            gate_rows = slice(o, o + n)
        sl_j = slice(gj.row_base, gj.row_base + n)
        np.testing.assert_allclose(rT[o:o + n].numpy(), rj[sl_j],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(JT[o:o + n].numpy(),
                                   _to_port_cols(Jj[sl_j], lay, D),
                                   rtol=1e-4, atol=1e-4)
        o += n
    assert o == rT.shape[0] == pT.n_residuals
    np.testing.assert_allclose(pT.residuals(xt).numpy(), rT.numpy(),
                               atol=1e-6)
    for a, b in zip(pT.points_of(xt), pj.points_of(jnp.asarray(xj))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # normal equations by variable (JAX's padding drops out)
    g_j = _to_port_cols(Jj.T @ rj, lay, D)
    H_j = _to_port_cols(_to_port_cols(Jj.T @ Jj, lay, D).T, lay, D)
    scale = np.abs(H_j).max()
    np.testing.assert_allclose((JT.T @ rT).numpy(), g_j, rtol=1e-4,
                               atol=1e-5 * np.abs(g_j).max())
    np.testing.assert_allclose((JT.T @ JT).numpy(), H_j, rtol=1e-4,
                               atol=1e-5 * scale)
    # at these points the nullhypo factor's residual (about 60 sigma)
    # loses to the null alternative: its rows are zero, the other's not
    rows = rT[gate_rows].reshape(-1, 1)
    assert float(rows[1].abs()) == 0.0 < float(rows[0].abs())


@pytest.mark.parametrize("seed", [0, 1])
def test_covariance_against_jax(seed):
    fj = _pieces_graph(seed)
    ft = port(fj)
    pj = js.ParametricProblem(fj, frozen=("l2",))
    pT = ts.ParametricProblem(ft, frozen=("l2",))
    lay, D = _layouts(pj, pT), pT.total_dof
    cj = np.asarray(js._cov_step(pj, pj._p0_stacked()))
    bt = ts._Batch([pT])
    cT = bt.cov(bt.p0s)[0].numpy()
    want = _to_port_cols(_to_port_cols(cj, lay, D).T, lay, D)
    np.testing.assert_allclose(cT, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())
    o = int(pT.offsets[pT.slot["l2"]])
    assert not cT[o].any() and not cT[:, o].any()     # frozen: zero


def test_gaussian_joint_residual_and_whitening():
    r = rng(7)
    se2, se3 = jm.SE2(), jm.SE3()
    p0s = [np.asarray(se2.exp(se2.identity(), jnp.asarray(
               r.standard_normal(3).astype(np.float32)))),
           np.asarray(se3.exp(se3.identity(), jnp.asarray(
               r.standard_normal(6).astype(np.float32))))]
    xs = [np.asarray(m.exp(jnp.asarray(p), jnp.asarray(
              0.4 * r.standard_normal(m.dof).astype(np.float32))))
          for m, p in zip((se2, se3), p0s)]
    L = r.standard_normal((9, 9)).astype(np.float32)
    C = L @ L.T / 9 + 0.1 * np.eye(9, dtype=np.float32)
    z = r.standard_normal(9).astype(np.float32)
    gj = JGaussianJoint([se2, se3], p0s, C)
    gt = it.GaussianJoint([SE2(), SE3()], p0s, C)
    want = np.asarray(gj.residual(jnp.asarray(z), *map(jnp.asarray, xs)))
    got = gt.residual(t(z), *map(t, xs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert gt.zdim == 9
    mu, c = gt.mean_cov()
    assert not mu.any() and torch.equal(c, t(C))
    np.testing.assert_allclose(ts._sqrt_inv(t(C)).numpy(),
                               np.asarray(js._sqrt_inv(jnp.asarray(C))),
                               rtol=1e-4, atol=1e-5)
    W = ts._sqrt_inv(t(C))
    np.testing.assert_allclose((W.T @ W).numpy(), np.linalg.inv(C),
                               rtol=1e-3, atol=1e-3)
    s = gt.sample(torch.Generator().manual_seed(0), 4000)
    np.testing.assert_allclose(np.cov(s.numpy().T), C, atol=0.15)


def test_stacker_refuses_what_it_does_not_know():
    class Offset(it.FactorModel):
        def __init__(self, Z, shift):
            self.Z, self.shift = Z, torch.tensor(shift)

        zdim = 1

        def residual(self, meas, x):
            return meas - x + self.shift

        def mean_cov(self):
            return self.Z.mean_cov()

    it.register_factor_model(Offset, ("Z", "shift"))
    fg = it.initfg(device=CPU)
    fg.add_variable("x", it.ContinuousScalar)
    fg.add_factor(["x"], Offset(it.Normal(0.0, 1.0), [1.0]), graphinit=False)
    with pytest.raises(NotImplementedError, match="cannot stack Offset"):
        it.solve_graph_parametric(fg)
    fg = it.initfg(device=CPU)
    for v in ("a", "b", "c"):
        fg.add_variable(v, it.ContinuousScalar)
    fg.add_factor(["a", "b", "c"], it.Mixture(
        it.LinearRelative, [it.Normal(1.0, 1.0), it.Normal(2.0, 1.0)]),
        multihypo=[1.0, 0.5, 0.5], graphinit=False)
    with pytest.raises(NotImplementedError, match="Mixture\\+multihypo"):
        it.solve_graph_parametric(fg)


# -- the SE(3) chain, the hexagon, MetaPrior ------------------------------

def _se3_chain(n_poses):
    """benchmarks/parametric_scale.py's SE(3) chain, cut to n poses."""
    se3 = jm.SE3()
    Pose3 = jl.VariableType("Pose3", se3)
    step = np.array([1.0, 0.0, 0.05, 0.0, 0.0, 0.02], np.float32)
    fg = jl.initfg(jl.SolverParams(N=8, graphinit=False))
    fg.add_variable("x0", Pose3)
    fg.add_factor(["x0"], jl.ManifoldPrior(
        se3, np.asarray(se3.identity()), jl.MvNormal(np.zeros(6), [0.01] * 6)),
        graphinit=False)
    for i in range(1, n_poses):
        fg.add_variable(f"x{i}", Pose3)
        fg.add_factor([f"x{i-1}", f"x{i}"], jl.ManifoldFactor(
            se3, jl.MvNormal(step, [0.01] * 6)), graphinit=False)
    return fg, step


def test_se3_chain_autoinit_and_solve():
    """Autoinit, then the solve, against the JAX package.  Float32 LM
    settles a pose eleven units down the chain within about 5e-5 of the
    other package's (the residual's rounding at that distance), and the
    covariance's rotation-translation couplings follow the settled relative
    pose: points at atol 2e-4, covariances at 1e-2 of the block's
    largest entry."""
    fj, step = _se3_chain(12)
    ft = port(fj)
    it.autoinit_parametric(ft)
    js.autoinit_parametric(fj)
    assert_same_solution(fj, ft, atol=2e-4, rtol=1e-2)
    it.solve_graph_parametric(ft)
    js.solve_graph_parametric(fj)
    assert_same_solution(fj, ft, atol=2e-4, rtol=1e-2)
    M, cur = SE3(), SE3().identity()
    for i in range(12):
        est = torch.as_tensor(pt(ft, f"x{i}"))
        assert float(torch.linalg.norm(est[:3] - cur[:3])) < 1e-3, i
        C = torch.as_tensor(cov(ft, f"x{i}"))
        assert torch.allclose(C, C.T, atol=1e-6 * float(C.abs().max()))
        assert bool((torch.linalg.eigvalsh(C) > 0).all()), i
        cur = M.exp(cur, torch.as_tensor(step))


def test_parametric_tree_se2_hexagonal():
    """tests/test_solve.py:254-261 on the port: the hexagon closes; and the
    parametric tree solve agrees with the JAX package's from the same
    beliefs (initParametricFrom! seeds both)."""
    fj = jl.canonical.generate_hexagonal(graphinit=True)
    ft = port(fj)
    it.solve_tree(ft, algorithm="parametric")
    x6 = pt(ft, "x6")
    assert np.linalg.norm(x6[:2]) < 1.5, x6
    jl.solve_tree(fj, algorithm="parametric")
    assert_same_solution(fj, ft, atol=1e-3, rtol=1e-2)


def test_metaprior_passthrough_both_algorithms():
    """tests/test_basic_graphs.py:165-172 on the port."""
    fg = it.generate_kaess(graphinit=True, device=CPU)
    fg.add_factor(["x1"], it.MetaPrior({"note": "calibration blob"}))
    it.solve_tree(fg)
    it.solve_graph_parametric(fg)
    assert fg.var("x1").is_solved()
    assert fg.var("x1").ppe["parametric"]["mean"] is not None


def test_covariance_of_a_long_se3_chain_by_qr():
    """The 200-pose SE(3) chain of benchmarks/parametric_scale.py at its
    optimum (the composed steps: the measurements are noiseless).  Its
    JᵀJ has a condition number above 1e8, beyond float32; the covariance
    from the QR factor of J keeps every 6 x 6 marginal block positive
    definite and within 2 % of the float64 inverse of the same J (the
    remaining error is float32's on a condition number of about 1e4)."""
    M, n = SE3(), 200
    step = torch.tensor([1.0, 0.0, 0.05, 0.0, 0.0, 0.02])
    fg = it.initfg(it.SolverParams(graphinit=False), device=CPU)
    vt = it.VariableType("Pose3", M)
    fg.add_variable("x0", vt)
    fg.add_factor(["x0"], it.ManifoldPrior(M, M.identity(), it.MvNormal(
        np.zeros(6), [0.01] * 6)))
    cur = M.identity()
    fg.var("x0").parametric_point = cur
    for i in range(1, n):
        fg.add_variable(f"x{i}", vt)
        fg.add_factor([f"x{i-1}", f"x{i}"],
                      it.ManifoldFactor(M, it.MvNormal(step.numpy(),
                                                       [0.01] * 6)))
        cur = M.exp(cur, step)
        fg.var(f"x{i}").parametric_point = cur
    bt = ts._Batch([ts.ParametricProblem(fg)])
    _, J = bt.res_jac(torch.zeros(1, bt.D), bt.p0s)
    J64 = J[0].double()
    H64 = J64.T @ J64
    assert float(torch.linalg.cond(H64)) > 1e8
    truth = torch.linalg.inv(H64)
    C = bt.cov(bt.p0s)[0].double()
    for i in range(n):
        s = slice(6 * i, 6 * i + 6)
        block, want = C[s, s], truth[s, s]
        assert bool((torch.linalg.eigvalsh(block) > 0).all()), i
        err = float((block - want).abs().max() / want.abs().max())
        assert err < 0.02, (i, err)

"""Deconvolution, factor gradients, path queries and joint up-messages of
the port, on the CPU.

Deterministic functions (``mmd``, ``factor_jacobian``, the solved half of
``approx_deconv``, the path queries, ``generate_msg_joint``'s structure) are
held against the JAX package on the same inputs at atol 1e-4 unless said
otherwise.  The cases of tests/test_deconv_gradients.py and
tests/test_joint_messages.py run on the port at their own bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    jax_graph_to_arrays, jax_native_ordering, rng, t)

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import manifolds as jm
from incrementalinference.jl_tpu.ops import deconv as jdeconv
from incrementalinference.jl_tpu.ops import gradients as jgrad
from incrementalinference.jl_tpu.parallel import messages as jmsg
from incrementalinference.jl_tpu.parallel.scheduler import \
    build_clique_subgraph as j_build_clique_subgraph
from incrementalinference_torch.manifolds import SE2
from incrementalinference_torch.ops import deconv as tdeconv
from incrementalinference_torch.ops.gradients import (
    FactorGradientsCached, calc_perturbation_from_variable, factor_jacobian)
from incrementalinference_torch.ops.graphops import (
    approx_conv_path, eval_factor_temporary, find_shortest_path_dijkstra,
    is_path_factors_homogeneous)
from incrementalinference_torch.parallel.messages import (
    JointMsg, add_msg_factors, generate_msg_joint, prep_msg_up)
from incrementalinference_torch.parallel.scheduler import \
    build_clique_subgraph
from incrementalinference_torch.tree.bayestree import CliqStatus
from incrementalinference_torch.utils import select_factor_type

CPU = "cpu"


def _chain():
    fg = it.initfg(device=CPU)
    fg.add_variable("a", it.ContinuousScalar)
    fg.add_variable("b", it.ContinuousScalar)
    fg.add_factor(["a"], it.Prior(it.Normal(0.0, 1.0)))
    it.init_variable(fg, "b", it.Normal(10.0, 1.0))
    f = fg.add_factor(["a", "b"], it.LinearRelative(it.Normal(10.0, 1.0)),
                      graphinit=False)
    return fg, f


def _se2_pair_jax(n=40):
    """Two SE(2) poses with beliefs and a ManifoldFactor between them, in
    the JAX package."""
    se2 = jm.SE2()
    pose2 = jl.VariableType("Pose2", se2)
    fj = jl.initfg(jl.SolverParams(N=n))
    r = rng(3)
    for lbl, center in (("x0", [0.0, 0.0, 0.0]), ("x1", [10.0, 1.0, 1.0])):
        fj.add_variable(lbl, pose2)
        X = (0.2 * r.standard_normal((n, 3))).astype(np.float32)
        fj.set_belief(lbl, se2.exp(jnp.broadcast_to(
            jnp.asarray(center, jnp.float32), (n, 3)), jnp.asarray(X)))
    f = fj.add_factor(["x0", "x1"], jl.ManifoldFactor(
        se2, jl.MvNormal([10.0, 0.0, 1.0], [0.5, 0.5, 0.1])),
        graphinit=False)
    return fj, f.label


# -- against the JAX package -------------------------------------------------

def test_solve_measurement_matches_jax():
    """The deconvolution's solve from the same starts and points: the
    ManifoldFactor's measurement is log(x0, x1), whatever the start; 1e-4."""
    fj, fl = _se2_pair_jax()
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    meas0 = (0.5 * rng(4).standard_normal((40, 3))).astype(np.float32)
    pts_j = tuple(fj.points(v) for v in ("x0", "x1"))
    pts_t = tuple(ft.points(v) for v in ("x0", "x1"))
    want = np.asarray(jdeconv._solve_measurement(
        fj.factor(fl).model, jnp.asarray(meas0), pts_j, iters=25))
    got = tdeconv._solve_measurement(ft.factor(fl).model, t(meas0), pts_t,
                                     iters=25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), SE2().log(pts_t[0], pts_t[1]).numpy(), atol=1e-4)


def test_approx_deconv_matches_jax():
    """The solved half does not depend on the draws (1e-4 against JAX); the
    sampled half is the factor's own model (mean within 0.3 of its mean:
    40 draws of sd 0.5)."""
    fj, fl = _se2_pair_jax()
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    sj, _ = jl.approx_deconv(fj, fl)
    st, sampled = it.approx_deconv(ft, fl)
    assert tuple(st.shape) == tuple(sampled.shape) == (40, 3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    np.testing.assert_allclose(sampled.numpy().mean(0), [10.0, 0.0, 1.0],
                               atol=0.3)
    b = it.approx_deconv_belief(ft, fl, n=20)
    assert tuple(b.points.shape) == (20, 3) and tuple(b.bw.shape) == (3,)
    np.testing.assert_allclose(
        b.points.numpy(),
        np.asarray(jl.approx_deconv_belief(fj, fl, n=20).points), atol=1e-4)


@pytest.mark.parametrize("bw", [None, 0.7])
def test_mmd_matches_jax(bw):
    r = rng(5)
    a = r.standard_normal((50, 2)).astype(np.float32)
    b = (r.standard_normal((61, 2)) + 0.4).astype(np.float32)
    want = jdeconv.mmd(jnp.asarray(a), jnp.asarray(b), bw)
    assert abs(tdeconv.mmd(t(a), t(b), bw) - want) < 1e-4


def test_factor_jacobian_matches_jax_on_se2():
    """Block Jacobians through exp/log of SE(2), at the Karcher means and
    at given points and measurement; 1e-4."""
    fj, fl = _se2_pair_jax()
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    Jt = factor_jacobian(ft, fl)
    assert tuple(Jt.shape) == (3, 6)
    np.testing.assert_allclose(Jt.numpy(),
                               np.asarray(jgrad.factor_jacobian(fj, fl)),
                               atol=1e-4)
    at = [np.array([1.0, 2.0, 0.5], np.float32),
          np.array([9.0, 4.0, 1.2], np.float32)]
    meas = np.array([8.0, 1.0, 0.6], np.float32)
    want = jgrad.factor_jacobian(fj, fl, meas=jnp.asarray(meas),
                                 at_points=[jnp.asarray(p) for p in at])
    np.testing.assert_allclose(
        factor_jacobian(ft, fl, meas=meas, at_points=at).numpy(),
        np.asarray(want), atol=1e-4)

    cj = jgrad.FactorGradientsCached(fj, fl)
    ct = FactorGradientsCached(ft, fl)
    assert ct.offsets == cj.offsets and ct.variables == cj.variables
    np.testing.assert_allclose(ct.block("x1").numpy(),
                               np.asarray(cj.block("x1")), atol=1e-4)
    delta = np.array([0.1, -0.2, 0.05], np.float32)
    out_j = jgrad.calc_perturbation_from_variable(cj, "x0",
                                                  jnp.asarray(delta))
    out_t = calc_perturbation_from_variable(ct, "x0", delta)
    assert set(out_t) == set(out_j) == {"x1"}
    np.testing.assert_allclose(out_t["x1"].numpy(), np.asarray(out_j["x1"]),
                               atol=1e-3)


def test_select_factor_type_matches_jax():
    from incrementalinference.jl_tpu.utils import \
        select_factor_type as j_select

    pairs = [(it.ContinuousScalar, jl.ContinuousScalar),
             (it.ContinuousEuclid(2), jl.ContinuousEuclid(2)),
             (it.Circular, jl.Circular),
             (it.VariableType("Pose2", SE2()),
              jl.VariableType("Pose2", jm.SE2()))]
    for vt, vj in pairs:
        got, want = select_factor_type(vt, vt), j_select(vj, vj)
        assert type(got).__name__ == type(want).__name__
        assert got.zdim == want.zdim
    with pytest.raises(ValueError):
        select_factor_type(it.ContinuousScalar, it.Circular)


# -- tests/test_deconv_gradients.py on the port --------------------------------

def test_deconv_recovers_measurement():
    fg, f = _chain()
    solved, sampled = it.approx_deconv(fg, f.label)
    s = solved[:, 0].numpy()
    assert abs(s.mean() - 10.0) < 1.0, s.mean()
    assert s.std() < 3.0
    assert abs(float(sampled.mean()) - 10.0) < 1.0


def test_mmd_separates_clouds():
    a = torch.linspace(0, 1, 50)[:, None]
    assert it.mmd(a, a + 0.01) < 0.01
    assert it.mmd(a, a + 5.0) > 0.1


def test_factor_jacobian_linear_relative():
    fg, f = _chain()
    np.testing.assert_allclose(it.factor_jacobian(fg, f.label).numpy(),
                               [[1.0, -1.0]], atol=1e-4)


def test_perturbation_propagation():
    fg, f = _chain()
    cache = it.FactorGradientsCached(fg, f.label)
    out = calc_perturbation_from_variable(cache, "a", torch.tensor([2.0]))
    np.testing.assert_allclose(out["b"].numpy(), [2.0], atol=1e-3)


def test_factor_jacobian_reference_blocks():
    fg = it.initfg(device=CPU)
    fg.add_variable("x1", it.ContinuousEuclid(2))
    fg.add_variable("x2", it.ContinuousEuclid(2))
    it.init_variable(fg, "x1", np.zeros((50, 2)))
    it.init_variable(fg, "x2", np.tile([10.0, 0.0], (50, 1)))
    f = fg.add_factor(["x1", "x2"],
                      it.LinearRelative(it.MvNormal([10.0, 0.0], [1.0, 1.0])),
                      graphinit=False)
    np.testing.assert_allclose(it.factor_jacobian(fg, f.label).numpy(),
                               [[1, 0, -1, 0], [0, 1, 0, -1]], atol=1e-5)
    cache = it.FactorGradientsCached(fg, f.label)
    ret = calc_perturbation_from_variable(cache, "x1", np.array([1.0, 1.0]))
    np.testing.assert_allclose(ret["x2"].numpy(), [1.0, 1.0], atol=1e-5)


def test_partial_relative_perturbation():
    class _Dim2Only(it.FactorModel):
        partial = (1,)

        def __init__(self, Z):
            self.Z = Z

        zdim = 1

        def sample(self, gen, n):
            return self.Z.sample(gen, n)

        def residual(self, z, x1, x2):
            return z - (x2[1:2] - x1[1:2])

        def mean_cov(self):
            return self.Z.mean_cov()

    fg = it.initfg(device=CPU)
    fg.add_variable("x1", it.ContinuousEuclid(2))
    fg.add_variable("x2", it.ContinuousEuclid(2))
    it.init_variable(fg, "x1", np.zeros((50, 2)))
    it.init_variable(fg, "x2", np.tile([0.0, 10.0], (50, 1)))
    f = fg.add_factor(["x1", "x2"], _Dim2Only(it.Normal(10.0, 1.0)),
                      graphinit=False)
    cache = it.FactorGradientsCached(fg, f.label)
    ret = calc_perturbation_from_variable(cache, "x1", np.array([1.0, 1.0]))
    np.testing.assert_allclose(ret["x2"].numpy(), [0.0, 1.0], atol=1e-5)


def test_eval_factor_temporary():
    pts = eval_factor_temporary(
        it.LinearRelative(it.Normal(10.0, 0.01)),
        [it.ContinuousScalar, it.ContinuousScalar],
        [np.zeros(1), np.zeros(1)], n=50, device=CPU)
    assert tuple(pts.shape) == (50, 1)
    assert abs(float(pts.mean()) - 10.0) < 0.1


def test_approx_conv_path_walks_the_chain():
    """x0 → x4 along four LinearRelative(+2) factors: the belief lands at
    +8 (bar 0.5; the JAX package's test_graphops bar), the graph is left
    as it was, and a missing path raises."""
    fg = it.generate_line_step(8, pose_every=2, landmark_every=0,
                               graphinit=False, device=CPU)
    it.doautoinit(fg, "x0")
    before = {v: fg.var(v).is_initialized() for v in fg.ls()}
    b = approx_conv_path(fg, "x0", "x8")
    assert abs(float(b.points.mean()) - 8.0) < 0.5
    assert {v: fg.var(v).is_initialized() for v in fg.ls()} == before
    fg.add_variable("alone", it.ContinuousScalar)
    with pytest.raises(ValueError):
        approx_conv_path(fg, "x0", "alone")


# -- tests/test_joint_messages.py on the port, beside the JAX package ----------

def _square(pkg, closures, **kw):
    """The x0-x1-x2 LinearRelative chain closed through x3 (reference
    testJointEnforcement.jl), in either package: with ``"range"`` closures
    (EuclidDistance, not the pair's default factor type) or ``"linear"``
    ones."""
    fg = pkg.initfg(pkg.SolverParams(N=100), **kw)
    for v in ("x0", "x1", "x2"):
        fg.add_variable(v, pkg.ContinuousEuclid(2))
    pkg.init_variable(fg, "x0", pkg.MvNormal([0.0, 0.0], [1.0, 1.0]))
    pkg.init_variable(fg, "x1", pkg.MvNormal([10.0, 10.0], [1.0, 1.0]))
    pkg.init_variable(fg, "x2", pkg.MvNormal([20.0, 20.0], [1.0, 1.0]))
    z = pkg.MvNormal([10.0, 10.0], [1.0, 1.0])
    fg.add_factor(["x0", "x1"], pkg.LinearRelative(z))
    fg.add_factor(["x1", "x2"], pkg.LinearRelative(z))
    fg.add_variable("x3", pkg.ContinuousEuclid(2))
    if closures == "range":
        fg.add_factor(["x2", "x3"],
                      pkg.EuclidDistance(pkg.Normal(10.0, 1.0)))
        fg.add_factor(["x0", "x3"],
                      pkg.EuclidDistance(pkg.Normal(30.0, 1.0)),
                      graphinit=False)
    else:
        fg.add_factor(["x2", "x3"], pkg.LinearRelative(z))
        fg.add_factor(["x0", "x3"], pkg.LinearRelative(z))
    return fg


def _mixed_square(pkg, **kw):
    return _square(pkg, "range", **kw)


def _linear_square(pkg, **kw):
    return _square(pkg, "linear", **kw)


def test_shortest_path_dijkstra_type_filters():
    fg = _mixed_square(it, device=CPU)
    fj = _mixed_square(jl)
    it.init_all(fg)
    jl.init_all(fj)
    # the unrestricted query has two shortest routes: both packages hand
    # networkx the same graph in the same order and get the same one
    assert find_shortest_path_dijkstra(fg, "x0", "x2") == \
        jl.find_shortest_path_dijkstra(fj, "x0", "x2")
    assert len(find_shortest_path_dijkstra(fg, "x0", "x2")) == 5
    lin = find_shortest_path_dijkstra(fg, "x0", "x2",
                                      type_factors=(it.LinearRelative,))
    assert lin[::2] == ["x0", "x1", "x2"]
    euc = find_shortest_path_dijkstra(fg, "x0", "x2",
                                      type_factors=(it.EuclidDistance,))
    assert euc[::2] == ["x0", "x3", "x2"]
    assert is_path_factors_homogeneous(fg, "x0", "x2") == \
        jl.is_path_factors_homogeneous(fj, "x0", "x2") == \
        (True, ["LinearRelative"])
    assert is_path_factors_homogeneous(fg, "x1", "x3") == \
        jl.is_path_factors_homogeneous(fj, "x1", "x3")
    assert find_shortest_path_dijkstra(fg, "x0", "nowhere") == []
    fg.var("x1").initialized["default"] = False
    assert find_shortest_path_dijkstra(
        fg, "x0", "x2", type_factors=(it.LinearRelative,),
        initialized=True) == []


def _joint_of_both(build, order, frontal):
    """generate_msg_joint of the clique of ``frontal`` in both packages, on
    one graph: the JAX package builds and initializes it, the port gets its
    particles as arrays."""
    fj = build(jl)
    fj.params = fj.params.replace(use_msg_likelihoods=True)
    jl.init_all(fj)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    tj = jl.build_tree_reset(fj, order=order)
    tt = it.build_tree_reset(ft, order=order)
    cj, ct = tj.clique_of(frontal), tt.clique_of(frontal)
    assert set(ct.separator) == set(cj.separator)
    sub_j = j_build_clique_subgraph(fj, cj)
    sub_t = build_clique_subgraph(ft, ct)
    return (jmsg.generate_msg_joint(sub_j, cj),
            generate_msg_joint(sub_t, ct), ft, tt, sub_t, ct)


def test_joint_msg_disjoint_separators_two_priors():
    """Clique [x3 | x0, x2] whose factors are EuclidDistance, not the
    default LinearRelative: 2 priors, 0 relatives, as in the JAX package
    on the same solved clique."""
    jj, jt, ft, _, sub, cl = _joint_of_both(
        _mixed_square, ["x3", "x1", "x2", "x0"], "x3")
    assert set(cl.separator) == {"x0", "x2"}
    assert set(jt.priors) == set(jj.priors) == {"x0", "x2"}
    assert len(jt.relatives) == len(jj.relatives) == 0
    for v in jt.priors:
        np.testing.assert_array_equal(jt.priors[v].points.numpy(),
                                      np.asarray(jj.priors[v].points))
    msg = prep_msg_up(sub, cl, CliqStatus.UPSOLVED)
    assert set(msg.jointmsg.priors) == {"x0", "x2"}
    assert len(msg.jointmsg.relatives) == 0
    # only solved up messages carry the payload
    assert prep_msg_up(sub, cl, CliqStatus.NO_INIT).jointmsg is None
    it.solve_tree(ft)


def test_joint_msg_homogeneous_separators_one_relative():
    """All-LinearRelative square: one relative between (x0, x2) whose
    belief is the per-particle difference (1e-5 against JAX), no prior; a
    parent subgraph takes the payload as factors."""
    jj, jt, ft, tree, sub, cl = _joint_of_both(
        _linear_square, ["x3", "x1", "x2", "x0"], "x3")
    assert [(a, b) for a, b, _ in jt.relatives] == \
        [(a, b) for a, b, _ in jj.relatives]
    assert len(jt.relatives) == 1
    assert {jt.relatives[0][0], jt.relatives[0][1]} == {"x0", "x2"}
    assert len(jt.priors) == len(jj.priors) == 0
    np.testing.assert_allclose(jt.relatives[0][2].points.numpy(),
                               np.asarray(jj.relatives[0][2].points),
                               atol=1e-5)
    np.testing.assert_allclose(jt.relatives[0][2].bw.numpy(),
                               np.asarray(jj.relatives[0][2].bw), rtol=1e-3)

    msg = prep_msg_up(sub, cl, CliqStatus.UPSOLVED)
    psub = build_clique_subgraph(ft, tree.clique_of("x2"))
    before = len(psub.lsf())
    added = add_msg_factors(psub, msg)
    assert len(psub.lsf()) == before + len(added)
    assert any("J" in lbl for lbl in added)
    rel = psub.factor(next(lbl for lbl in added if "J" in lbl))
    assert type(rel.model).__name__ == "MsgRelativeLikelihood"
    assert "__UPWARD_DIFFERENTIAL__" in rel.tags
    # without the switch the same message enters as plain MsgPriors
    psub2 = build_clique_subgraph(ft, tree.clique_of("x2"))
    psub2.params = psub2.params.replace(use_msg_likelihoods=False)
    plain = add_msg_factors(psub2, msg)
    assert all(type(psub2.factor(lbl).model).__name__ == "MsgPrior"
               for lbl in plain) and len(plain) == len(msg.beliefs)


def test_joint_msg_on_se2_separators():
    """The same on a curved manifold: four SE(2) poses in a ring of
    ManifoldFactors, eliminated so that one clique has two poses as its
    separator.  The relative's belief is log(x_a, x_b) per particle."""
    def build(pkg):
        mani = jm if pkg is jl else it.manifolds
        se2 = mani.SE2()
        pose2 = pkg.VariableType("Pose2", se2)
        fg = pkg.initfg(pkg.SolverParams(N=60))
        z = pkg.MvNormal([5.0, 0.0, 2.0], [0.3, 0.3, 0.05])
        fg.add_variable("x0", pose2)
        p0 = jnp.zeros(3) if pkg is jl else np.zeros(3, np.float32)
        fg.add_factor(["x0"], pkg.ManifoldPrior(
            se2, p0, pkg.MvNormal([0.0] * 3, [0.1, 0.1, 0.05])))
        for a, b in (("x0", "x1"), ("x1", "x2"), ("x2", "x3"),
                     ("x0", "x3")):
            if b not in fg.ls():
                fg.add_variable(b, pose2)
            fg.add_factor([a, b], pkg.ManifoldFactor(se2, z))
        return fg

    jj, jt, _, _, _, cl = _joint_of_both(build, ["x3", "x1", "x2", "x0"],
                                         "x3")
    assert set(cl.separator) == {"x0", "x2"}
    assert [(a, b) for a, b, _ in jt.relatives] == \
        [(a, b) for a, b, _ in jj.relatives] and len(jt.relatives) == 1
    assert set(jt.priors) == set(jj.priors)
    np.testing.assert_allclose(jt.relatives[0][2].points.numpy(),
                               np.asarray(jj.relatives[0][2].points),
                               atol=1e-4)


def test_use_msg_likelihoods_caesar_ring():
    fg = it.generate_caesar_ring1d(device=CPU)
    fg.params = fg.params.replace(use_msg_likelihoods=True)
    it.init_all(fg)
    order = ["x3", "x5", "l1", "x1", "x6", "x4", "x2", "x0"]
    tree = it.build_tree_reset(fg, order=order)
    saw_joint = False
    for cl in tree.cliques.values():
        if not cl.separator:
            continue
        sub = build_clique_subgraph(fg, cl)
        msg = prep_msg_up(sub, cl, CliqStatus.UPSOLVED)
        assert isinstance(msg.jointmsg, JointMsg)
        saw_joint = saw_joint or bool(msg.jointmsg.relatives)
    assert saw_joint, "expected at least one differential relative"
    it.solve_tree(fg, up=True, down=False)
    for i in range(7):
        assert fg.var(f"x{i}").is_initialized()


def test_treeinit_msg_likelihood_cycle_754():
    fg = it.generate_line_step(
        5, pose_every=1, landmark_every=5, pose_priors_at=(0, 2),
        sight_distance=4, device=CPU,
        params=it.SolverParams(N=100, graphinit=False,
                               use_msg_likelihoods=True))
    it.solve_tree(fg)
    for lbl in sorted(fg.ls()):
        truth = float(lbl.lstrip("xlm"))
        sppe = float(fg.var(lbl).ppe["default"]["suggested"][0])
        assert abs(sppe - truth) < 0.35, (lbl, sppe)


def test_line_step_with_joint_messages_holds_its_bar():
    """chip_smoke.py's joint phase at a CPU-sized length: LineStep's bar,
    and the solve's up messages carry joint payloads."""
    fg = it.generate_line_step(
        8, graphinit=True, device=CPU,
        params=it.SolverParams(use_msg_likelihoods=True))
    tree = it.solve_tree(fg)
    assert any(m.jointmsg is not None for m in tree.up_msgs.values())
    for i in range(0, 9, 2):
        assert abs(float(fg.points(f"x{i}").mean()) - i) < 1.5, i


def test_solve_factor_parametric_and_tether():
    """tests/test_deconv_gradients.py:64-83 on the port, and the same chain
    through the JAX package's tether from the same particles."""
    from incrementalinference.jl_tpu import tether as jtether

    fj = jl.initfg()
    prev = None
    for i in range(4):
        fj.add_variable(f"x{i}", jl.ContinuousScalar)
        if i == 0:
            fj.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 0.1)))
        else:
            fj.add_factor([prev, f"x{i}"],
                          jl.LinearRelative(jl.Normal(5.0, 0.5)),
                          graphinit=False)
        prev = f"x{i}"
    fg = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
    chain = [fl for fl in fg.lsf() if len(fg.factor(fl).variables) == 2]
    end = it.accumulate_factor_means(fg, chain)
    assert abs(float(end[0]) - 15.0) < 0.5, end
    np.testing.assert_allclose(
        end.numpy(), np.asarray(jtether.accumulate_factor_means(fj, chain)),
        atol=1e-4)
    single = it.solve_factor_parametric(fg, chain[0], "x1",
                                        values={"x0": t([100.0])})
    assert abs(float(single[0]) - 105.0) < 0.2
    prior = it.solve_factor_parametric(fg, fg.lsf()[0], "x0")
    np.testing.assert_allclose(prior.numpy(), [0.0])
    # re-anchor the last relative on x0
    it.rebase_factor_variable(fg, chain[-1], "x2", "x0")
    assert fg.factor(chain[-1]).variables == ("x0", "x3")
    assert chain[-1] in fg.factors_of("x0")
    assert chain[-1] not in fg.factors_of("x2")

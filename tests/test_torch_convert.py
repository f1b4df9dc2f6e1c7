"""convert.graph_from_arrays / graph_to_arrays round trips."""

import numpy as np
import torch

from torch_port_helpers import jax_graph_to_arrays

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it


def test_round_trip_through_arrays():
    fg = it.generate_line_step(8, graphinit=True, device="cpu")
    spec = it.graph_to_arrays(fg)
    back = it.graph_from_arrays(spec, device="cpu")
    assert back.ls() == fg.ls() and back.lsf() == fg.lsf()
    for f in fg.lsf():
        assert back.factor(f).variables == fg.factor(f).variables
        assert type(back.factor(f).model) is type(fg.factor(f).model)
        assert float(back.factor(f).model.Z.mu) == float(
            fg.factor(f).model.Z.mu)
    for v in fg.ls():
        b0, b1 = fg.get_belief(v), back.get_belief(v)
        np.testing.assert_array_equal(b1.points.numpy(), b0.points.numpy())
        np.testing.assert_array_equal(b1.bw.numpy(), b0.bw.numpy())
        np.testing.assert_array_equal(b1.ipc.numpy(), b0.ipc.numpy())
    again = it.graph_to_arrays(back)
    assert again["params"] == spec["params"]
    # auto-named factors continue the numbering instead of colliding
    back.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)), graphinit=False)


def test_jax_graph_carries_across():
    from incrementalinference.jl_tpu import canonical as jcan

    fj = jcan.generate_line_step(4, graphinit=True)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
    assert ft.ls() == fj.ls() and ft.lsf() == fj.lsf()
    for v in fj.ls():
        np.testing.assert_array_equal(ft.points(v).numpy(),
                                      np.asarray(fj.points(v)))
        np.testing.assert_array_equal(ft.get_belief(v).bw.numpy(),
                                      np.asarray(fj.get_belief(v).bw))


def _curved_graph(pkg, mani, **kw):
    """SE(2), SE(3) and circular variables, a partial prior, the hexagon's
    landmark factor and a mixture over a ManifoldPrior, in either package."""
    se2, se3 = mani.SE2(), mani.SE3()
    fg = pkg.initfg(pkg.SolverParams(N=20, graphinit=False), **kw)
    fg.add_variable("p", pkg.VariableType("Pose2", se2))
    fg.add_variable("q", pkg.VariableType("Pose3", se3))
    fg.add_variable("c", pkg.Circular)
    fg.add_variable("d", pkg.Circular)
    fg.add_variable("l", pkg.ContinuousEuclid(2))
    fg.add_variable("w", pkg.VariableType(
        "PoseAndPoint", mani.Product(se2, mani.Euclidean(2))))
    p0 = np.array([1.0, 2.0, 0.5], np.float32)
    q0 = np.array([1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0], np.float32)
    fg.add_factor(["p"], pkg.ManifoldPrior(
        se2, p0, pkg.MvNormal([0.0] * 3, [0.1, 0.2, 0.05])))
    fg.add_factor(["q"], pkg.ManifoldPrior(
        se3, q0, pkg.MvNormal([0.0] * 6, [0.1] * 6)))
    fg.add_factor(["c"], pkg.PriorCircular(pkg.Normal(0.3, 0.1)))
    fg.add_factor(["c", "d"], pkg.CircularCircular(pkg.Normal(1.0, 0.2)))
    fg.add_factor(["l"], pkg.PartialPrior(pkg.Normal(4.0, 0.5), (1,)))
    fg.add_factor(["p", "l"], pkg.canonical._Pose2Point2Bearingless())
    fg.add_factor(["p"], pkg.Mixture(
        pkg.ManifoldPrior(se2, p0, pkg.MvNormal([0.0] * 3, [0.1] * 3)),
        [pkg.MvNormal([0.0] * 3, [0.1] * 3),
         pkg.MvNormal([3.0, 0.0, 0.0], [0.1] * 3)], [0.7, 0.3]))
    return fg


def _assert_same_parameters(a: dict, b: dict):
    """Every parameter of two graph dicts, exactly."""
    def same(x, y, where):
        if isinstance(x, dict):
            assert set(x) == set(y), where
            for k in x:
                same(x[k], y[k], f"{where}.{k}")
        elif isinstance(x, (list, tuple)) and x and \
                isinstance(x[0], (dict, list, tuple, np.ndarray)):
            assert len(x) == len(y), where
            for i, (u, v) in enumerate(zip(x, y)):
                same(u, v, f"{where}[{i}]")
        elif x is None or isinstance(x, (str, bool)):
            assert x == y, where
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=where)

    same(a["variables"], b["variables"], "variables")
    same(a["factors"], b["factors"], "factors")


def test_round_trip_of_curved_manifolds_and_partials():
    from incrementalinference_torch import manifolds
    fg = _curved_graph(it, manifolds, device="cpu")
    it.init_variable(fg, "p", np.tile([1.0, 2.0, 0.5], (20, 1)))
    spec = it.graph_to_arrays(fg)
    back = it.graph_from_arrays(spec, device="cpu")
    _assert_same_parameters(spec, it.graph_to_arrays(back))
    for v in fg.ls():
        assert back.var(v).vartype == fg.var(v).vartype, v
        assert back.var(v).manifold == fg.var(v).manifold, v
    assert back.factor("lf5").model.partial == (1,)
    assert type(back.factor("pf7").model.mechanics).__name__ == \
        "ManifoldPrior"
    np.testing.assert_array_equal(back.factor("qf2").model.p0,
                                  fg.factor("qf2").model.p0)
    # what came back works: all but the factor-less "w" initialize
    assert not it.init_all(back)
    assert [v for v in back.ls() if not back.var(v).is_initialized()] == ["w"]


def test_jax_curved_graph_carries_across():
    """JAX → arrays → port: every parameter equal to what the port's own
    build of the same graph holds."""
    import incrementalinference.jl_tpu as jl
    from incrementalinference.jl_tpu import manifolds as jm
    from incrementalinference_torch import manifolds

    fj = _curved_graph(jl, jm)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
    own = _curved_graph(it, manifolds, device="cpu")
    _assert_same_parameters(it.graph_to_arrays(ft), it.graph_to_arrays(own))
    assert ft.ls() == fj.ls() and ft.lsf() == fj.lsf()
    for v in fj.ls():
        assert repr(ft.var(v).manifold) == repr(fj.var(v).manifold)
        assert ft.var(v).vartype.name == fj.var(v).vartype.name


def test_round_trip_of_parametric_state_and_gaussian_joint():
    """parametric_point, parametric_cov and a GaussianJoint (SE(2) and
    SE(3) points, a 9 x 9 covariance) through the arrays and back, and from
    the JAX package's own GaussianJoint."""
    from incrementalinference.jl_tpu import manifolds as jm
    from incrementalinference.jl_tpu.models.factors import GaussianJoint
    from incrementalinference_torch import manifolds

    r = np.random.default_rng(5)
    L = r.standard_normal((9, 9)).astype(np.float32)
    C = L @ L.T + np.eye(9, dtype=np.float32)
    p2 = np.array([1.0, 2.0, 0.3], np.float32)
    p3 = np.array([1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0], np.float32)

    def build(pkg, mani, joint, **kw):
        fg = pkg.initfg(pkg.SolverParams(graphinit=False), **kw)
        fg.add_variable("p", pkg.VariableType("Pose2", mani.SE2()))
        fg.add_variable("q", pkg.VariableType("Pose3", mani.SE3()))
        fg.add_factor(["p", "q"], joint([mani.SE2(), mani.SE3()], [p2, p3],
                                        C), label="msg")
        fg.var("p").parametric_point = p2 + 1.0
        fg.var("p").parametric_cov = np.eye(3, dtype=np.float32)
        return fg

    fg = build(it, manifolds, it.GaussianJoint, device="cpu")
    fg.var("p").parametric_point = torch.as_tensor(p2 + 1.0)
    spec = it.graph_to_arrays(fg)
    back = it.graph_from_arrays(spec, device="cpu")
    _assert_same_parameters(spec, it.graph_to_arrays(back))
    m = back.factor("msg").model
    assert isinstance(m, it.GaussianJoint) and m.zdim == 9
    assert m.manifolds == (manifolds.SE2(), manifolds.SE3())
    np.testing.assert_array_equal(m.cov.numpy(), C)
    np.testing.assert_array_equal(m.p0s[1].numpy(), p3)
    np.testing.assert_array_equal(back.var("p").parametric_point.numpy(),
                                  p2 + 1.0)
    np.testing.assert_array_equal(back.var("p").parametric_cov.numpy(),
                                  np.eye(3))
    assert back.var("q").parametric_point is None
    fj = build(jl, jm, GaussianJoint)
    _assert_same_parameters(
        it.graph_to_arrays(it.graph_from_arrays(jax_graph_to_arrays(fj),
                                                device="cpu")), spec)

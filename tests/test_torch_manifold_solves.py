"""Solves on curved manifolds and with partial factors, on the CPU.

The statistical bars are those of the JAX package's
tests/test_manifold_solves.py and tests/test_partial_custom.py, run on the
port.  Deterministic pieces (residuals, the default points, the graph the
hexagon generator builds) are held against the JAX package on the same
numpy inputs at atol 1e-5; draws come from independent random streams, so
sampled quantities are compared in mean and spread, with the tolerance
given where it is used.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_graph_to_arrays, rng, t

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import manifolds as jm
from incrementalinference.jl_tpu.canonical import \
    _Pose2Point2Bearingless as JBearingless
from incrementalinference_torch import keys
from incrementalinference_torch.beliefs import is_partial
from incrementalinference_torch.canonical import _Pose2Point2Bearingless
from incrementalinference_torch.manifolds import (SE2, SE3, SO3, Euclidean,
                                                  Sphere2, wrap_angle)
from incrementalinference_torch.ops import product as tp
from incrementalinference_torch.ops.convolve import eval_factor
from incrementalinference_torch.ops.kernels import row_lse

CPU = "cpu"


def gen(seed=0):
    return keys.generator(keys.make_key(seed), CPU)


# -- the models against the JAX package, same inputs ------------------------

def _model_pairs():
    return {
        "PriorCircular": (jl.PriorCircular(jl.Normal(0.3, 0.1)),
                          it.PriorCircular(it.Normal(0.3, 0.1)), 1, (1,)),
        "CircularCircular": (jl.CircularCircular(jl.Normal(0.3, 0.1)),
                             it.CircularCircular(it.Normal(0.3, 0.1)), 1,
                             (1, 1)),
        "PartialPrior": (jl.PartialPrior(jl.Normal(2.0, 1.0), (1,)),
                         it.PartialPrior(it.Normal(2.0, 1.0), (1,)), 1,
                         (3,)),
        "ManifoldFactor-SE2": (
            jl.ManifoldFactor(jm.SE2(), jl.MvNormal([0.0] * 3, [1.0] * 3)),
            it.ManifoldFactor(SE2(), it.MvNormal([0.0] * 3, [1.0] * 3)), 3,
            ("SE2", "SE2")),
        "ManifoldFactor-SE3": (
            jl.ManifoldFactor(jm.SE3(), jl.MvNormal([0.0] * 6, [1.0] * 6)),
            it.ManifoldFactor(SE3(), it.MvNormal([0.0] * 6, [1.0] * 6)), 6,
            ("SE3", "SE3")),
        "ManifoldPrior-SE2": (
            jl.ManifoldPrior(jm.SE2(), jnp.asarray([1.0, -2.0, 0.7]),
                             jl.MvNormal([0.0] * 3, [1.0] * 3)),
            it.ManifoldPrior(SE2(), [1.0, -2.0, 0.7],
                             it.MvNormal([0.0] * 3, [1.0] * 3)), 3,
            ("SE2",)),
        "Pose2Point2Bearingless": (JBearingless(), _Pose2Point2Bearingless(),
                                   2, ("SE2", 2)),
    }


def _points_of(kind, r, n):
    """n points of a manifold (by name: made with the JAX package) or of
    R^k (an int)."""
    if isinstance(kind, int):
        return (3.0 * r.standard_normal((n, kind))).astype(np.float32)
    M = getattr(jm, kind)()
    X = (0.8 * r.standard_normal((n, M.dof))).astype(np.float32)
    ident = jnp.broadcast_to(M.identity(), (n, M.point_dim))
    return np.asarray(M.exp(ident, jnp.asarray(X)))


@pytest.mark.parametrize("name", list(_model_pairs()))
def test_residual_matches_jax(name):
    """Residuals on the same measurement and points, atol 1e-5; the
    sample's shape is (n, zdim) in both."""
    jmodel, tmodel, zdim, kinds = _model_pairs()[name]
    r = rng(1)
    n = 12
    meas = (0.5 * r.standard_normal((n, zdim))).astype(np.float32)
    pts = [_points_of(k, r, n) for k in kinds]
    want = np.asarray(jmodel.residual(jnp.asarray(meas),
                                      *(jnp.asarray(p) for p in pts)))
    got = tmodel.residual(t(meas), *(t(p) for p in pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert tmodel.zdim == jmodel.zdim == zdim
    assert tuple(tmodel.sample(gen(), 7).shape) == (7, zdim)
    assert type(tmodel).__name__ in it.models.MODEL_REGISTRY
    assert getattr(tmodel, "partial", None) == getattr(jmodel, "partial",
                                                       None)
    for flag in ("linear_residual", "quasi_linear_residual", "is_prior"):
        assert getattr(tmodel, flag, False) == getattr(jmodel, flag, False)


def test_msg_relative_likelihood_matches_jax():
    """The joint message's relative factor: residual at 1e-5, mean and
    covariance of its belief at 1e-4, samples in mean (sd of the mean of
    400 draws ~ 0.03) and spread."""
    from incrementalinference.jl_tpu.beliefs import make_belief as jmb
    from incrementalinference.jl_tpu.models.factors import \
        MsgRelativeLikelihood as JRel
    from incrementalinference_torch.models import MsgRelativeLikelihood

    r = rng(2)
    diffs = (np.array([1.0, -0.5, 0.2])
             + 0.3 * r.standard_normal((80, 3))).astype(np.float32)
    jb = jmb(jm.Euclidean(3), jnp.asarray(diffs))
    jrel = JRel(jb, jm.SE2())
    trel = MsgRelativeLikelihood(
        it.make_belief(Euclidean(3), t(diffs), bw=t(np.asarray(jb.bw))),
        SE2())
    p1, p2 = _points_of("SE2", r, 9), _points_of("SE2", r, 9)
    meas = diffs[:9]
    np.testing.assert_allclose(
        trel.residual(t(meas), t(p1), t(p2)).numpy(),
        np.asarray(jrel.residual(jnp.asarray(meas), jnp.asarray(p1),
                                 jnp.asarray(p2))), atol=1e-5)
    for got, want in zip(trel.mean_cov(), jrel.mean_cov()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    s = trel.sample(gen(3), 400).numpy()
    assert s.shape == (400, 3) and trel.zdim == jrel.zdim == 3
    np.testing.assert_allclose(s.mean(0), diffs.mean(0), atol=0.15)
    np.testing.assert_allclose(s.std(0), diffs.std(0), atol=0.1)


def test_manifold_prior_points_and_mixture_branch():
    """ManifoldPrior turns tangent draws into points around p0; a Mixture
    over it must do the same (the ``meas_to_points`` branch) instead of
    handing tangent rows back as points."""
    se2 = SE2()
    p0 = np.array([5.0, -3.0, 2.0], np.float32)
    prior = it.ManifoldPrior(se2, p0, it.MvNormal([0.0] * 3, [0.1] * 3))
    jprior = jl.ManifoldPrior(jm.SE2(), jnp.asarray(p0),
                              jl.MvNormal([0.0] * 3, [0.1] * 3))
    meas = (0.1 * rng(4).standard_normal((6, 3))).astype(np.float32)
    np.testing.assert_allclose(
        prior.meas_to_points(t(meas), se2).numpy(),
        np.asarray(jprior.meas_to_points(jnp.asarray(meas), jm.SE2())),
        atol=1e-5)
    pts = prior.sample_points(gen(5), 200, se2)
    assert float(se2.dist(se2.mean(pts), t(p0))) < 0.05
    mix = it.Mixture(prior, [it.MvNormal([0.0] * 3, [0.1] * 3),
                             it.MvNormal([1.0, 0.0, 0.0], [0.1] * 3)],
                     [0.5, 0.5])
    pts = mix.sample_points(gen(6), 400, se2)
    # both modes sit around p0 (within 1.5 of it), not around the origin
    d = se2.dist(pts, t(p0).expand(400, 3))
    assert float(d.max()) < 1.5
    assert 0.3 < float((d > 0.5).float().mean()) < 0.7
    assert mix.is_prior


def test_variable_types():
    assert it.Circular.name == jl.Circular.name == "Circular"
    assert repr(it.Circular.manifold) == repr(jl.Circular.manifold)
    assert it.Position(3).name == jl.Position(3).name
    assert it.Position(3).manifold == Euclidean(3)
    pose2 = it.VariableType("Pose2", SE2())
    assert pose2 == it.VariableType("Pose2", SE2())
    fg = it.initfg(device=CPU)
    fg.add_variable("x", it.VariableType("Pose3", SE3()), N=5)
    # identity points until a belief exists, as in the JAX package
    np.testing.assert_array_equal(fg.points("x").numpy(),
                                  np.tile(np.asarray(jm.SE3().identity()),
                                          (5, 1)))


def test_generate_hexagonal_builds_the_jax_graph():
    fj = jl.canonical.generate_hexagonal(graphinit=False)
    ft = it.generate_hexagonal(graphinit=False, device=CPU)
    assert ft.ls() == fj.ls() and ft.lsf() == fj.lsf()
    spec_j, spec_t = jax_graph_to_arrays(fj), it.graph_to_arrays(ft)
    for a, b in zip(spec_j["factors"], spec_t["factors"]):
        assert a["type"] == b["type"] and a["variables"] == b["variables"]
        np.testing.assert_allclose(a["Z"]["mu"], b["Z"]["mu"], atol=1e-6)
        np.testing.assert_allclose(a["Z"]["cov"], b["Z"]["cov"], atol=1e-6)
        if "p0" in a:
            np.testing.assert_array_equal(a["p0"], b["p0"])
    for a, b in zip(spec_j["variables"], spec_t["variables"]):
        assert (a["type"], a["manifold"]) == (b["type"], b["manifold"])
    no_lmk = it.generate_hexagonal(graphinit=False, landmark=False,
                                   device=CPU)
    assert "l1" not in no_lmk.ls() and len(no_lmk.lsf()) == 7


def test_sample_factor_and_approx_conv_belief_against_jax():
    """One graph in both packages (carried across as arrays):
    ``sample_factor`` rows agree in mean and spread (400 draws of sd 0.5:
    the two means differ with sd 0.035), ``approx_conv_belief`` to x1 in
    Karcher mean (tolerance 0.3 in SE(2) dist: 100 particles of spread ~0.7
    on each side) and exactly in infoPerCoord."""
    se2j = jm.SE2()
    fj = jl.initfg(jl.SolverParams(N=100))
    pose2 = jl.VariableType("Pose2", se2j)
    fj.add_variable("x0", pose2)
    fj.add_factor(["x0"], jl.ManifoldPrior(
        se2j, jnp.zeros(3), jl.MvNormal([0.0] * 3, [0.1, 0.1, 0.05])))
    fj.add_variable("x1", pose2)
    f = fj.add_factor(["x0", "x1"], jl.ManifoldFactor(
        se2j, jl.MvNormal([10.0, 0.0, math.pi / 3], [0.5, 0.5, 0.05])),
        graphinit=False)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    np.testing.assert_array_equal(ft.points("x0").numpy(),
                                  np.asarray(fj.points("x0")))

    sj = np.asarray(jl.sample_factor(fj, f.label, n=400))
    st = it.sample_factor(ft, f.label, n=400).numpy()
    assert st.shape == sj.shape == (400, 3)
    np.testing.assert_allclose(st.mean(0), sj.mean(0), atol=0.15)
    np.testing.assert_allclose(st.std(0), sj.std(0), atol=0.08)
    assert tuple(it.sample_factor(ft, ft.factor(f.label)).shape) == (100, 3)

    bj = jl.approx_conv_belief(fj, f.label, "x1")
    bt = it.approx_conv_belief(ft, f.label, "x1")
    assert tuple(bt.points.shape) == tuple(bj.points.shape) == (100, 3)
    mu_t = SE2().mean(bt.points)
    mu_j = se2j.mean(bj.points)
    assert float(se2j.dist(jnp.asarray(mu_t.numpy()), mu_j)) < 0.3
    np.testing.assert_array_equal(bt.ipc.numpy(), np.asarray(bj.ipc))
    np.testing.assert_allclose(bt.bw.numpy(), np.asarray(bj.bw), rtol=0.6)
    assert not is_partial(bt)

    from incrementalinference_torch.ops.convolve import proposal_from_factor
    prop = proposal_from_factor(ft, f.label, "x1")
    assert tuple(prop.points.shape) == (100, 3) and bool(prop.dim_mask.all())
    np.testing.assert_allclose(prop.bw.numpy(), bt.bw.numpy(), rtol=0.6)


# -- tests/test_manifold_solves.py on the port -------------------------------

def _circular_chain():
    fg = it.initfg(device=CPU)
    fg.add_variable("c0", it.Circular)
    fg.add_factor(["c0"], it.PriorCircular(it.Normal(0.0, 0.05)))
    step = 2.0 * np.pi / 5.0
    for i in range(1, 6):
        fg.add_variable(f"c{i}", it.Circular)
        fg.add_factor([f"c{i - 1}", f"c{i}"],
                      it.CircularCircular(it.Normal(step, 0.05)))
    return fg, step


def test_circular_chain_wraps():
    fg, step = _circular_chain()
    it.solve_tree(fg)
    for i in range(6):
        p = fg.points(f"c{i}")[:, 0].numpy()
        want = float(wrap_angle(torch.tensor(i * step)))
        d = np.abs(np.angle(np.exp(1j * (p - want))))
        assert np.mean(d < 0.5) > 0.85, (i, want, p.mean())
    p5 = fg.points("c5")[:, 0].numpy()
    assert np.mean(np.abs(np.angle(np.exp(1j * p5))) < 0.5) > 0.85


def test_se2_pose_chain():
    se2 = SE2()
    pose2 = it.VariableType("Pose2", se2)
    fg = it.initfg(device=CPU)
    fg.add_variable("x0", pose2)
    fg.add_factor(["x0"], it.ManifoldPrior(
        se2, np.zeros(3), it.MvNormal([0.0] * 3, [0.05, 0.05, 0.02])))
    z = it.MvNormal([1.0, 0.0, 0.3], [0.05, 0.05, 0.02])
    for i in range(1, 4):
        fg.add_variable(f"x{i}", pose2)
        fg.add_factor([f"x{i - 1}", f"x{i}"], it.ManifoldFactor(se2, z))
    it.solve_tree(fg)
    truth = torch.zeros(3)
    for i in range(1, 4):
        truth = se2.compose(truth, se2.Exp(torch.tensor([1.0, 0.0, 0.3])))
        p = fg.points(f"x{i}")
        err = se2.dist(p, truth.expand(p.shape)).numpy()
        assert np.mean(err < 0.6) > 0.8, (i, truth, p.mean(0))


def test_so3_prior_concentration():
    so3 = SO3()
    fg = it.initfg(device=CPU)
    fg.add_variable("r", it.VariableType("Rotation3", so3))
    q0 = so3.exp(so3.identity(), torch.tensor([0.2, -0.1, 0.4]))
    fg.add_factor(["r"], it.ManifoldPrior(
        so3, q0, it.MvNormal([0.0] * 3, [0.05] * 3)))
    p = fg.points("r")
    assert np.mean(so3.dist(p, q0.expand(p.shape)).numpy() < 0.2) > 0.9


def test_sphere_manifold_ops_and_prior():
    S = Sphere2()
    r = rng(7)
    p = S.exp(S.identity(), t(0.4 * r.standard_normal(2)))
    X = t(0.5 * r.standard_normal(2))
    q = S.exp(p, X)
    np.testing.assert_allclose(float(torch.linalg.norm(q)), 1.0, atol=1e-5)
    np.testing.assert_allclose(S.log(p, q).numpy(), X.numpy(), atol=1e-4)

    fg = it.initfg(device=CPU)
    fg.add_variable("s", it.VariableType("Sphere2", S))
    p0 = S.exp(S.identity(), torch.tensor([0.3, -0.2]))
    fg.add_factor(["s"], it.ManifoldPrior(S, p0, it.MvNormal([0.0, 0.0],
                                                              [0.05, 0.05])))
    pts = fg.points("s")
    np.testing.assert_allclose(torch.linalg.norm(pts, dim=1).numpy(), 1.0,
                               atol=1e-4)
    assert np.mean(S.dist(pts, p0.expand(pts.shape)).numpy() < 0.2) > 0.9


def test_se2_multihypo_landmark_association():
    pose2 = it.VariableType("Pose2", SE2())
    fg = it.initfg(device=CPU)
    fg.add_variable("la", it.ContinuousEuclid(2))
    fg.add_factor(["la"], it.Prior(it.MvNormal([10.0, 0.0], [0.1, 0.1])))
    fg.add_variable("lb", it.ContinuousEuclid(2))
    fg.add_factor(["lb"], it.Prior(it.MvNormal([0.0, 10.0], [0.1, 0.1])))
    fg.add_variable("x0", pose2)
    fg.add_factor(["x0", "la", "lb"],
                  _Pose2Point2Bearingless(it.MvNormal([2.0, 0.0],
                                                      [0.1, 0.1])),
                  multihypo=[1.0, 0.5, 0.5])
    it.solve_tree(fg)
    p = fg.points("x0").numpy()
    d_a = np.linalg.norm(p[:, :2] - np.array([8.0, 0.0]), axis=1)
    d_b = np.linalg.norm(p[:, :2] - np.array([0.0, 8.0]), axis=1)
    assert np.mean(d_a < 4.0) > 0.1 and np.mean(d_b < 4.0) > 0.1, (
        np.mean(d_a < 4.0), np.mean(d_b < 4.0))
    assert np.mean((d_a < 4.0) | (d_b < 4.0)) > 0.5
    la = fg.points("la").numpy()
    assert np.linalg.norm(la.mean(0) - [10.0, 0.0]) < 1.0


def test_hexagonal_nonparam_vs_parametric():
    """The port's nonparametric posterior means against the port's own
    parametric optimum of the same graph (the JAX test's bar, 1.5 in SE(2)
    dist), and against the ideal hexagon."""
    fg = it.generate_hexagonal(graphinit=True, device=CPU)
    it.solve_tree(fg)
    fp = it.generate_hexagonal(graphinit=False, device=CPU)
    it.solve_graph_parametric(fp)

    se2 = SE2()
    ideal = torch.zeros(3)
    for i in range(1, 7):
        ideal = se2.exp(ideal, torch.tensor([10.0, 0.0, math.pi / 3]))
        v = f"x{i}"
        if v not in ("x1", "x3", "x6"):
            continue
        mu_np = se2.mean(fg.points(v))
        mu_p = fp.var(v).parametric_point
        d = float(se2.dist(mu_np, mu_p))
        assert d < 1.5, (v, d, mu_np, mu_p)
        assert float(se2.dist(mu_np, ideal)) < 1.5, (v, mu_np, ideal)
        # the optimum sits on the ideal hexagon
        assert float(se2.dist(ideal, mu_p)) < 0.5, (v, mu_p, ideal)


def test_translation_group_manifold_prior_factor():
    t2 = Euclidean(2)
    tg2 = it.VariableType("TranslationGroup2", t2)
    fg = it.initfg(device=CPU)
    fg.add_variable("x0", tg2)
    fg.add_factor(["x0"], it.ManifoldPrior(
        t2, [10.0, 20.0], it.MvNormal([0.0, 0.0], [1.0, 1.0])))
    fg.add_variable("x1", tg2)
    fg.add_factor(["x0", "x1"], it.ManifoldFactor(
        t2, it.MvNormal([1.0, 2.0], [0.1, 0.1])))
    it.solve_tree(fg)
    np.testing.assert_allclose(fg.points("x0").numpy().mean(0),
                               [10.0, 20.0], atol=1.0)
    np.testing.assert_allclose(fg.points("x1").numpy().mean(0),
                               [11.0, 22.0], atol=1.0)


# -- the large-pair path at dof 3 ---------------------------------------------

def test_se2_two_pose_solve_through_the_large_pair_path(monkeypatch):
    """chip_smoke.py's SE(2) two-pose graph at a CPU-sized N with the
    threshold patched low: every two-proposal product goes through
    pair_product_tangent_large and the row_logsumexp wrapper at dof 3 (its
    plain version: the tensors are on the CPU).  Bars: Karcher means within
    0.2 of truth (256 particles of spread ~0.7: sd of the mean ~0.05),
    per-dof tangent std within (0.2, 1.5) x the prior's."""
    monkeypatch.setattr(tp, "LARGE_PAIR_THRESHOLD", 1)
    seen = []

    def recording(muA, precA, muB, precB):
        seen.append((tuple(muA.shape), bool(torch.all(precB == precB[0]))))
        return row_lse.pair_row_logsumexp(muA, precA, muB, precB)

    monkeypatch.setattr(tp, "pair_row_logsumexp", recording)
    row_lse.reset_counts()
    se2, N = SE2(), 256
    step, sigma = [10.0, 0.0, math.pi / 3], [0.5, 0.5, 0.05]
    x1 = se2.exp(se2.identity(), torch.tensor(step))
    fg = it.initfg(it.SolverParams(N=N, batch_cliques=False), device=CPU)
    pose2 = it.VariableType("Pose2", se2)
    noise = it.MvNormal([0.0] * 3, sigma)
    fg.add_variable("x0", pose2)
    fg.add_factor(["x0"], it.ManifoldPrior(se2, se2.identity(), noise))
    fg.add_variable("x1", pose2)
    fg.add_factor(["x0", "x1"],
                  it.ManifoldFactor(se2, it.MvNormal(step, sigma)))
    fg.add_factor(["x1"], it.ManifoldPrior(se2, x1, noise))
    it.solve_tree(fg)
    assert row_lse.counts["calls"] == 12
    assert row_lse.counts["launches"] == 0          # no kernel on the CPU
    assert seen and all(s == ((N, 3), True) for s in seen)
    for v, truth in (("x0", se2.identity()), ("x1", x1)):
        pts = fg.points(v)
        mu = se2.mean(pts)
        assert float(se2.dist(mu, truth)) < 0.2, v
        ratio = se2.log(mu[None, :], pts).std(0) / torch.tensor(sigma)
        assert 0.2 < float(ratio.min()) and float(ratio.max()) < 1.5, ratio


# -- tests/test_partial_custom.py on the port ---------------------------------

class _DevelopPartial(it.PriorModel):
    """Prior on a subset of dims (reference DevelopPartial)."""

    def __init__(self, Z, partial):
        self.Z = Z
        self.partial = tuple(partial)

    @property
    def zdim(self):
        return len(self.partial)

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def sample_points(self, gen, n, manifold):
        full = torch.zeros((n, manifold.point_dim), device=gen.device)
        full[:, list(self.partial)] = self.Z.sample(gen, n)
        return full

    def residual(self, z, x):
        return z - x[list(self.partial)]

    def mean_cov(self):
        return self.Z.mean_cov()


class _DevelopPartialPairwise(it.FactorModel):
    """Relative constraining only dim 2 of a 2-D pair (reference
    DevelopPartialPairwise)."""

    partial = (1,)

    def __init__(self, Z):
        self.Z = Z

    @property
    def zdim(self):
        return 1

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, z, x1, x2):
        return z - (x2[1:2] - x1[1:2])

    def mean_cov(self):
        return self.Z.mean_cov()


it.register_factor_model(_DevelopPartial, ("Z", "partial"))
it.register_factor_model(_DevelopPartialPairwise, ("Z",))


def test_is_partial_factor_flags():
    fg = it.initfg(device=CPU)
    fg.add_variable("x0", it.ContinuousScalar)
    assert not fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0))).is_partial
    fg.add_variable("x1", it.ContinuousEuclid(2))
    assert fg.add_factor(["x1"], _DevelopPartial(it.Normal(0.0, 1.0), (0,)),
                         graphinit=False).is_partial
    assert fg.add_factor(["x1"], it.PartialPrior(it.Normal(0.0, 1.0), (1,)),
                         graphinit=False).is_partial


@pytest.mark.parametrize("make", [
    lambda: _DevelopPartial(it.Normal(2.0, 1.0), (0,)),
    lambda: it.PartialPrior(it.Normal(2.0, 1.0), (0,))],
    ids=["custom", "PartialPrior"])
def test_partial_prior_eval_and_solve(make):
    """tests/test_partial_custom.py:88-125, for the user-defined partial
    prior of that test and for the package's own PartialPrior."""
    N = 100
    fg = it.initfg(it.SolverParams(N=N), device=CPU)
    fg.add_variable("x1", it.ContinuousEuclid(2))
    f1 = fg.add_factor(["x1"], it.Prior(it.MvNormal([0.0, 0.0],
                                                    [0.01, 0.01])))
    f2 = fg.add_factor(["x1"], make(), graphinit=False)
    it.doautoinit(fg, "x1")

    pts, mask = eval_factor(fg, f1.label, "x1")
    assert tuple(pts.shape) == (N, 2)
    assert abs(float(pts[:, 0].mean())) < 0.3
    assert mask.tolist() == [True, True]

    before = fg.points("x1").numpy().copy()
    pts2, mask2 = eval_factor(fg, f2.label, "x1")
    p2 = pts2.numpy()
    assert abs(p2[:, 0].mean() - 2.0) < 0.75
    assert np.linalg.norm(before[:, 0] - p2[:, 0]) > 2.0
    assert np.linalg.norm(before[:, 1] - p2[:, 1]) < 1e-8
    assert mask2.tolist() == [True, False]
    np.testing.assert_array_equal(fg.points("x1").numpy(), before)

    assert is_partial(it.approx_conv_belief(fg, f2.label, "x1"))
    assert not is_partial(it.approx_conv_belief(fg, f1.label, "x1"))

    it.solve_tree(fg)
    p = fg.points("x1").numpy()
    assert abs(p[:, 0].mean()) < 0.4
    assert abs(p[:, 1].mean()) < 0.4


def test_custom_partial_relative_solve():
    N = 100
    fg = it.initfg(it.SolverParams(N=N), device=CPU)
    fg.add_variable("x1", it.ContinuousEuclid(2))
    fg.add_factor(["x1"], it.Prior(it.MvNormal([0.0, 0.0], [0.01, 0.01])))
    fg.add_variable("x2", it.ContinuousEuclid(2))
    f3 = fg.add_factor(["x1", "x2"],
                       _DevelopPartialPairwise(it.Normal(10.0, 1.0)))
    fg.add_factor(["x2"], _DevelopPartial(it.Normal(-20.0, 1.0), (0,)),
                  graphinit=False)
    it.doautoinit(fg, "x2")
    assert is_partial(it.approx_conv_belief(fg, f3.label, "x2"))
    it.solve_tree(fg)
    p2 = fg.points("x2").numpy()
    assert abs(p2[:, 0].mean() + 20.0) < 2.0, p2[:, 0].mean()
    assert abs(p2[:, 1].mean() - 10.0) < 2.0, p2[:, 1].mean()


def test_partial_prior_eval_matches_jax_on_the_same_graph():
    """PartialPrior through eval_factor in both packages from the same
    particles: the untouched dim is bit-equal to the input in both, the
    sampled dim agrees in mean (100 draws of sd 1: tolerance 0.45) and the
    dim masks are equal."""
    from incrementalinference.jl_tpu.ops.convolve import eval_factor as jef

    fj = jl.initfg(jl.SolverParams(N=100))
    fj.add_variable("x1", jl.ContinuousEuclid(2))
    fj.add_factor(["x1"], jl.Prior(jl.MvNormal([0.0, 0.0], [0.01, 0.01])))
    f2 = fj.add_factor(["x1"], jl.PartialPrior(jl.Normal(2.0, 1.0), (0,)),
                       graphinit=False)
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device=CPU)
    assert ft.factor(f2.label).model.partial == (0,)
    pj, mj = jef(fj, f2.label, "x1")
    pt, mt = eval_factor(ft, f2.label, "x1")
    np.testing.assert_array_equal(pt[:, 1].numpy(), np.asarray(pj)[:, 1])
    assert abs(float(pt[:, 0].mean()) - float(np.asarray(pj)[:, 0].mean())) \
        < 0.45
    assert mt.tolist() == list(np.asarray(mj))

"""The port's curved manifolds against the JAX package on identical inputs.

Every input is made with numpy from a seed and handed to both packages.
Tolerances (absolute, float32 on both sides): 1e-5 for the chart and group
operations on moderate rotations, 1e-4 for rows whose rotation angle is
above 3.0 (near pi the half-angle forms lose digits) and for the Karcher
mean (8 iterations of log/exp accumulate), 1e-4 for Jacobians, 1e-3 in
``dist`` for points solved by the batched Gauss-Newton.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from torch_port_helpers import rng, t

from incrementalinference.jl_tpu import manifolds as jm
from incrementalinference.jl_tpu.manifolds import lie as jlie
from incrementalinference_torch import manifolds as tm
from incrementalinference_torch.manifolds import lie as tlie

MODERATE, NEAR_PI, MEAN_TOL, JAC_TOL = 1e-5, 1e-4, 1e-4, 1e-4

MANIFOLDS = {
    "SO2": (jm.SO2(), tm.SO2()),
    "SE2": (jm.SE2(), tm.SE2()),
    "SO3": (jm.SO3(), tm.SO3()),
    "SE3": (jm.SE3(), tm.SE3()),
    "Sphere2": (jm.Sphere2(), tm.Sphere2()),
    "Product": (jm.Product(jm.SE2(), jm.Euclidean(2)),
                tm.Product(tm.SE2(), tm.Euclidean(2))),
}
GROUPS = [k for k in MANIFOLDS if k != "Sphere2"]

#: tangent index ranges that hold a rotation, per manifold
_ROT = {"SO2": slice(0, 1), "SE2": slice(2, 3), "SO3": slice(0, 3),
        "SE3": slice(3, 6), "Sphere2": slice(0, 2), "Product": slice(2, 3)}


def tangents(name, seed):
    """(X, tol): a batch of tangent rows with, in this order, the zero
    tangent, a rotation below the 1e-8 small-angle switch, six moderate
    rows, and two rows whose rotation angle is 3.1; ``tol`` is the row's
    tolerance."""
    M = MANIFOLDS[name][0]
    r = rng(seed)
    X = (0.7 * r.standard_normal((10, M.dof))).astype(np.float32)
    X[0] = 0.0
    X[1] = 0.0
    X[1, _ROT[name]] = 1e-9
    for row in (8, 9):
        d = r.standard_normal(X[row, _ROT[name]].shape)
        X[row, _ROT[name]] = 3.1 * d / np.linalg.norm(d)
    tol = np.full((10, 1), MODERATE, np.float32)
    tol[8:] = NEAR_PI
    return X, tol


def points(name, seed):
    """Points p = exp(identity, X) made by the JAX package (the reference),
    as numpy, with the rows' tolerances."""
    J = MANIFOLDS[name][0]
    X, tol = tangents(name, seed)
    ident = jnp.broadcast_to(J.identity(), (X.shape[0], J.point_dim))
    return np.asarray(J.exp(ident, jnp.asarray(X))), tol


def close(got: torch.Tensor, want, tol):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want)
    if err.ndim == 1:
        tol = np.reshape(tol, (-1,))
    assert np.all(err <= tol), (err.max(axis=-1) if err.ndim > 1 else err)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_exp(name):
    J, T = MANIFOLDS[name]
    p, tol_p = points(name, 1)
    X, tol_x = tangents(name, 2)
    close(T.exp(t(p), t(X)), J.exp(jnp.asarray(p), jnp.asarray(X)),
          np.maximum(tol_p, tol_x))


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_exp_from_identity_and_identity(name):
    J, T = MANIFOLDS[name]
    X, tol = tangents(name, 3)
    np.testing.assert_array_equal(T.identity().numpy(),
                                  np.asarray(J.identity()))
    assert T.point_dim == J.point_dim and T.dof == J.dof
    ident = T.identity().expand(X.shape[0], T.point_dim)
    close(T.exp(ident, t(X)), points(name, 3)[0], tol)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_log_and_dist(name):
    """q = exp(p, Y) with moderate Y, and q = p on the first row."""
    J, T = MANIFOLDS[name]
    p, tol = points(name, 4)
    Y = (0.6 * rng(5).standard_normal((10, J.dof))).astype(np.float32)
    Y[0] = 0.0
    q = np.asarray(J.exp(jnp.asarray(p), jnp.asarray(Y)))
    close(T.log(t(p), t(q)), J.log(jnp.asarray(p), jnp.asarray(q)), tol)
    close(T.dist(t(p), t(q)), J.dist(jnp.asarray(p), jnp.asarray(q)), tol)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_log_of_far_points(name):
    """Both points anywhere on the manifold: relative rotations up to pi."""
    J, T = MANIFOLDS[name]
    p, _ = points(name, 6)
    q, _ = points(name, 7)
    got = T.log(t(p), t(q))
    want = np.asarray(J.log(jnp.asarray(p), jnp.asarray(q)))
    angle = np.linalg.norm(want[:, _ROT[name]], axis=-1, keepdims=True)
    close(got, want, np.where(angle > 3.0, NEAR_PI, MODERATE))


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_project(name):
    J, T = MANIFOLDS[name]
    p, tol = points(name, 8)
    # off the manifold: scaled, and angles pushed past pi
    off = (1.3 * p + 0.05).astype(np.float32)
    close(T.project(t(off)), J.project(jnp.asarray(off)), tol)


@pytest.mark.parametrize("name", GROUPS)
def test_compose_and_inverse(name):
    J, T = MANIFOLDS[name]
    p, tol_p = points(name, 9)
    q, tol_q = points(name, 10)
    close(T.compose(t(p), t(q)), J.compose(jnp.asarray(p), jnp.asarray(q)),
          np.maximum(tol_p, tol_q))
    close(T.inverse(t(p)), J.inverse(jnp.asarray(p)), tol_p)


@pytest.mark.parametrize("spread", [0.05, 0.4])
@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_mean(name, spread):
    """The Karcher mean starts at the first point and runs 8 iterations, so
    both packages get the same points in the same order; also weighted."""
    J, T = MANIFOLDS[name]
    r = rng(11)
    center, _ = points(name, 12)
    center = center[3]
    X = (spread * r.standard_normal((64, J.dof))).astype(np.float32)
    pts = np.asarray(J.exp(jnp.broadcast_to(jnp.asarray(center),
                                            (64, J.point_dim)),
                           jnp.asarray(X)))
    close(T.mean(t(pts)), J.mean(jnp.asarray(pts)), MEAN_TOL)
    w = r.uniform(0.1, 1.0, 64).astype(np.float32)
    close(T.mean(t(pts), t(w)), J.mean(jnp.asarray(pts), jnp.asarray(w)),
          MEAN_TOL)
    # a batch of clouds, as loo_bandwidth hands them over
    both = np.stack([pts, pts[::-1]])
    close(T.mean(t(both)), J.mean(jnp.asarray(both)), MEAN_TOL)


@pytest.mark.parametrize("name", ["SE2", "SE3"])
def test_group_Exp_Log(name):
    J, T = MANIFOLDS[name]
    X, tol = tangents(name, 13)
    p = np.asarray(J.Exp(jnp.asarray(X)))
    close(T.Exp(t(X)), p, tol)
    close(T.Log(t(p)), J.Log(jnp.asarray(p)), tol)


def _quats(seed, n=10):
    q = rng(seed).standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvecs(seed):
    return tangents("SO3", seed)


@pytest.mark.parametrize("fn", ["quat_mul", "quat_conj", "quat_normalize",
                                "quat_rotate", "quat_from_rotvec",
                                "rotvec_from_quat", "_hat3", "_se3_V",
                                "_se3_Vinv"])
def test_quaternion_helpers(fn):
    a, b = _quats(14), _quats(15)
    v = rng(16).standard_normal((10, 3)).astype(np.float32)
    phi, tol = _rotvecs(17)
    args = {"quat_mul": (a, b), "quat_conj": (a,),
            "quat_normalize": (-2.5 * a,), "quat_rotate": (a, v),
            "quat_from_rotvec": (phi,),
            "rotvec_from_quat": (np.asarray(jlie.quat_from_rotvec(
                jnp.asarray(phi))),),
            "_hat3": (phi,), "_se3_V": (phi,), "_se3_Vinv": (phi,)}[fn]
    got = getattr(tlie, fn)(*(t(x) for x in args))
    want = np.asarray(getattr(jlie, fn)(*(jnp.asarray(x) for x in args)))
    if want.ndim == 3:
        tol = tol[:, :, None]
    close(got, want, tol if fn in ("quat_from_rotvec", "rotvec_from_quat",
                                   "_se3_V", "_se3_Vinv", "_hat3")
          else MODERATE)


def test_quat_rotate_broadcasts_one_quaternion_over_vectors():
    q = _quats(18, 1)[0]
    v = rng(19).standard_normal((7, 3)).astype(np.float32)
    close(tlie.quat_rotate(t(q), t(v)),
          jlie.quat_rotate(jnp.asarray(q), jnp.asarray(v)), MODERATE)


@pytest.mark.parametrize("side", ["below", "above"])
def test_sphere_basis_on_both_sides_of_its_switch(side):
    """Sphere2's tangent basis changes helper axis at |p_z| = 0.9: a
    discontinuity of the coordinates, so each side is held on its own."""
    J, T = MANIFOLDS["Sphere2"]
    r = rng(20)
    z = r.uniform(0.1, 0.85, 8) if side == "below" \
        else r.uniform(0.92, 0.999, 8)
    z = z * np.where(r.uniform(size=8) < 0.5, -1.0, 1.0)
    az = r.uniform(0, 2 * np.pi, 8)
    s = np.sqrt(1 - z * z)
    p = np.stack([s * np.cos(az), s * np.sin(az), z], -1).astype(np.float32)
    X = (0.3 * r.standard_normal((8, 2))).astype(np.float32)
    for got, want in zip(tlie.Sphere2._basis(t(p)),
                         jlie.Sphere2._basis(jnp.asarray(p))):
        close(got, want, MODERATE)
    q = J.exp(jnp.asarray(p), jnp.asarray(X))
    close(T.exp(t(p), t(X)), q, MODERATE)
    close(T.log(t(p), t(np.asarray(q))), J.log(jnp.asarray(p), q), MODERATE)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_jacobian_of_exp_at_the_zero_tangent(name):
    """What the batched Gauss-Newton linearises every iteration."""
    J, T = MANIFOLDS[name]
    p = points(name, 21)[0][4]
    z = np.zeros((J.dof,), np.float32)
    want = np.asarray(jax.jacfwd(lambda X: J.exp(jnp.asarray(p), X))(
        jnp.asarray(z)))
    got = jacfwd(lambda X: T.exp(t(p), X))(t(z))
    assert got.dtype == torch.float32
    close(got, want, JAC_TOL)


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_jacobian_of_log_at_q_equal_p(name):
    J, T = MANIFOLDS[name]
    p = points(name, 22)[0][5]
    want = np.asarray(jax.jacfwd(lambda q: J.log(jnp.asarray(p), q))(
        jnp.asarray(p)))
    got = jacfwd(lambda q: T.log(t(p), q))(t(p))
    assert got.dtype == torch.float32
    close(got, want, JAC_TOL)


def test_wrap_angle():
    """To (-pi, pi]; one float32 rounding of 2 pi round(t / 2 pi) at
    |t| <= 30 is 2e-6."""
    a = np.concatenate([rng(25).uniform(-30, 30, 50),
                        [0.0, np.pi, -np.pi, 3 * np.pi]]).astype(np.float32)
    got = tm.wrap_angle(t(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.wrap_angle(jnp.asarray(a))),
                               atol=4e-6)
    assert np.all(np.abs(got) <= np.pi + 1e-5)


def test_manifolds_hash_and_compare_like_the_jax_ones():
    assert tm.SE2() == tm.SE2() and tm.SE2() != tm.SE3()
    assert hash(tm.Product(tm.SE2(), tm.Euclidean(2))) == hash(
        tm.Product(tm.SE2(), tm.Euclidean(2)))
    assert tm.Product(tm.SE2(), tm.Euclidean(2)) != tm.Product(
        tm.SE2(), tm.Euclidean(3))
    assert sorted(tm.__all__ + []) == sorted(jm.__all__ + ["quat_conj"])
    for name, (J, T) in MANIFOLDS.items():
        assert repr(T) == repr(J), name


def _gn_models():
    from incrementalinference.jl_tpu import MvNormal as JMv
    from incrementalinference.jl_tpu.canonical import \
        _Pose2Point2Bearingless as JBear
    from incrementalinference.jl_tpu.models import ManifoldFactor as JMF
    from incrementalinference_torch import MvNormal as TMv
    from incrementalinference_torch.canonical import \
        _Pose2Point2Bearingless as TBear
    from incrementalinference_torch.models import ManifoldFactor as TMF

    se2 = ([0.0] * 3, [1.0] * 3)
    se3 = ([0.0] * 6, [1.0] * 6)
    return {
        "ManifoldFactor-SE2": ("SE2", "SE2", JMF(jm.SE2(), JMv(*se2)),
                               TMF(tm.SE2(), TMv(*se2)), 1),
        "ManifoldFactor-SE3": ("SE3", "SE3", JMF(jm.SE3(), JMv(*se3)),
                               TMF(tm.SE3(), TMv(*se3)), 1),
        "ManifoldFactor-SE2-first-slot": (
            "SE2", "SE2", JMF(jm.SE2(), JMv(*se2)),
            TMF(tm.SE2(), TMv(*se2)), 0),
        "Pose2Point2Bearingless": ("SE2", None, JBear(), TBear(), 1),
    }


@pytest.mark.parametrize("case", ["ManifoldFactor-SE2", "ManifoldFactor-SE3",
                                  "ManifoldFactor-SE2-first-slot",
                                  "Pose2Point2Bearingless"])
def test_batched_gauss_newton_matches_jax(case):
    """The same measurements, fixed points and starts through both
    packages' batched Gauss-Newton (8 LM iterations, as the solve gives a
    quasi-linear factor): solved points agree at 1e-3 in ``dist``."""
    from incrementalinference.jl_tpu.ops.convolve import \
        batched_gauss_newton as jgn
    from incrementalinference_torch.ops.convolve import \
        batched_gauss_newton as tgn

    other_name, solve_name, jmodel, tmodel, slot = _gn_models()[case]
    n = 16
    other = points(other_name, 23)[0][2:8]
    other = np.concatenate([other, other, other])[:n]
    r = rng(24)
    if solve_name is None:                      # an R^2 landmark
        Js, Ts = jm.Euclidean(2), tm.Euclidean(2)
        meas = (np.array([10.0, 0.0]) + 0.3 * r.standard_normal((n, 2))
                ).astype(np.float32)
        x0 = (5.0 * r.standard_normal((n, 2))).astype(np.float32)
    else:
        Js, Ts = MANIFOLDS[solve_name]
        meas = (0.5 * r.standard_normal((n, Js.dof))).astype(np.float32)
        start = (0.3 * r.standard_normal((n, Js.dof))).astype(np.float32)
        x0 = np.asarray(Js.exp(jnp.asarray(other), jnp.asarray(start)))
    want = jgn(Js, jmodel, jnp.asarray(meas), (jnp.asarray(other),),
               jnp.asarray(x0), slot, iters=8, damping=1e-6)
    got = tgn(Ts, tmodel, t(meas), (t(other),), t(x0), slot, iters=8,
              damping=1e-6)
    d = np.asarray(Js.dist(jnp.asarray(got.numpy()), want))
    assert np.all(np.isfinite(got.numpy())) and d.max() < 1e-3, d
    # and the solve did its work: the residual is gone
    pts = [t(other)]
    pts.insert(slot, got)
    res = tmodel.residual(t(meas), *pts)
    assert float(res.abs().max()) < 1e-3


REVERSE = dict(MANIFOLDS, Circle=(jm.Circle(), tm.Circle()))
#: reverse mode (torch.func.jacrev, what the port's solves take) against
#: JAX's forward mode: float32 on both sides, the rows' own error is within
#: REV_TOL·(1 + |J|)
REV_TOL = 1e-5


@pytest.mark.parametrize("at", ["zero", "random"])
@pytest.mark.parametrize("name", list(REVERSE))
def test_reverse_jacobians_of_exp_and_log_match_jax_jacfwd(name, at):
    """d exp(p, X)/dX and d log(p, exp(p, X))/dX by ``vmap(jacrev)`` at
    the zero tangent (what every Gauss-Newton iteration linearises at) and
    at random tangents, against the JAX package's ``vmap(jacfwd)``: no NaN
    (reverse mode sends a zero cotangent into each guard's untaken side),
    and equal within REV_TOL."""
    from torch.func import jacrev, vmap

    J, T = REVERSE[name]
    r = rng(25)
    ident = jnp.broadcast_to(J.identity(), (8, J.point_dim))
    p = np.asarray(J.exp(ident, jnp.asarray(
        (0.7 * r.standard_normal((8, J.dof))).astype(np.float32))))
    X = (0.7 * r.standard_normal((8, J.dof))).astype(np.float32)
    if at == "zero":
        X[:] = 0.0

    def jexp(p, X):
        return J.exp(p, X)

    def jlog(p, X):
        return J.log(p, J.exp(p, X))

    def texp(p, X):
        return T.exp(p, X)

    def tlog(p, X):
        return T.log(p, T.exp(p, X))

    for jf, tf in ((jexp, texp), (jlog, tlog)):
        want = np.asarray(jax.vmap(jax.jacfwd(jf, argnums=1))(
            jnp.asarray(p), jnp.asarray(X)))
        got = vmap(jacrev(tf, argnums=1))(t(p), t(X)).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert not np.isnan(got).any()
        err = np.abs(got - want)
        assert np.all(err <= REV_TOL * (1.0 + np.abs(want))), err.max()

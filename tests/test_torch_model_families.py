"""The model families of the port (grid densities, network ensembles, ODE
factors) on the CPU: the deterministic parts against the JAX package on the
same numpy inputs, every solve of tests/test_extensions.py at its own bars,
and the models carried between the packages by convert.py.  Also the
ManifoldKernelDensity belief, an attribute as in the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (interp_uniform, jax_graph_to_arrays, rng,
                                scaled, t)

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import models as jm
from incrementalinference_torch import keys as tkeys
from incrementalinference_torch import models as tm
from incrementalinference_torch.convert import (ensemble_params_from,
                                                ensemble_params_to,
                                                graph_from_arrays,
                                                graph_to_arrays)
from incrementalinference_torch.ops.convolve import eval_factor

KEY = jax.random.PRNGKey(0)

#: the layer zoo of tests/test_extensions.py:349-352
ZOO = (("conv2d", 2, 3, 3), ("tanh",), ("avgpool2d", 2),
       ("conv2d", 3, 2, 3), ("sigmoid",), ("maxpool2d", 2),
       ("flatten",), ("dense", 2 * 2 * 2, 4), ("relu",),
       ("dense", 4, 3), ("softmax",))
#: the conv ensemble of tests/test_extensions.py:306-307
CONV = (("conv2d", 1, 4, 3), ("relu",), ("maxpool2d", 2), ("flatten",),
        ("dense", 4 * 4 * 4, 1))


def _gen(seed=0):
    return tkeys.generator(seed, "cpu")


# -- ManifoldKernelDensity.belief (ROADMAP queue 3, item 1) -------------------

def test_manikde_belief_is_an_attribute_as_in_jax():
    """``mkd.belief.points``, ``mkd.belief.bw`` and ``mkd.points`` on the
    same 50 points: points exact, bandwidth rtol 1e-5 (JAX 0.51285)."""
    pts = np.random.default_rng(0).normal(size=(50,)).astype(np.float32)
    mj = jl.manikde(jl.ContinuousScalar, pts)
    mt = it.manikde(it.ContinuousScalar, pts)
    np.testing.assert_array_equal(mt.belief.points.numpy(),
                                  np.asarray(mj.belief.points))
    np.testing.assert_array_equal(mt.points.numpy(), np.asarray(mj.points))
    assert mt.belief.points.shape == (50, 1)
    np.testing.assert_allclose(mt.belief.bw.numpy(), np.asarray(mj.belief.bw),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt.bw[0]), 0.51285, atol=5e-5)
    # the bandwidth is selected once: a device copy reuses it
    assert mt.belief_on("cpu") is mt.belief
    mu, cov = mt.mean_cov()
    mj_mu, mj_cov = mj.mean_cov()
    np.testing.assert_allclose(mu, np.asarray(mj_mu), atol=1e-5)
    np.testing.assert_allclose(cov, np.asarray(mj_cov), rtol=1e-5)


# -- grid densities -----------------------------------------------------------

def _grid(seed=0, H=40, W=50):
    xs = np.linspace(0.0, 100.0, W, dtype=np.float32)
    ys = np.linspace(0.0, 100.0, H, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys)
    bump = np.exp(-((X - 70.0) ** 2 + (Y - 30.0) ** 2) / 50.0)
    return xs, ys, bump.astype(np.float32)


def test_heatmap_weights_and_logpdf_against_jax():
    """Cell weights agree to float32 rounding (rtol 1e-6: XLA and numpy sum
    the grid in different orders; atol 1e-30 for the subnormal weights far
    from the bump, below ``logpdf``'s floor); ``logpdf`` picks the same
    cell for every query, inside, on and outside the grid (a grid of
    distinct weights, 1e-6 absolute on the log weight)."""
    xs, ys, bump = _grid()
    hj = jm.HeatmapGridDensity(bump, (xs, ys))
    ht = tm.HeatmapGridDensity(bump, (xs, ys))
    np.testing.assert_allclose(ht.weights, np.asarray(hj.weights), rtol=1e-6,
                               atol=1e-30)
    distinct = (np.arange(bump.size, dtype=np.float32) + 1.0).reshape(
        bump.shape)
    hj = jm.HeatmapGridDensity(distinct, (xs, ys))
    ht = tm.HeatmapGridDensity(distinct, (xs, ys))
    q = rng(1).uniform(-10.0, 110.0, size=(2000, 2)).astype(np.float32)
    q[:50, 0] = xs[rng(2).integers(0, 50, 50)]          # on grid lines
    q[50:100, 1] = ys[rng(3).integers(0, 40, 50)]
    np.testing.assert_allclose(ht.logpdf(t(q)).numpy(),
                               np.asarray(hj.logpdf(jnp.asarray(q))),
                               atol=1e-6, rtol=0)
    # batched queries keep their leading shape
    assert ht.logpdf(t(q).reshape(40, 50, 2)).shape == (40, 50)


def test_levelset_weights_against_jax():
    """N(level; data, sigma) cell weights, rtol 1e-6, and the raw grid."""
    xs, ys, _ = _grid()
    X, Y = np.meshgrid(xs, ys)
    elevation = np.sqrt(X ** 2 + Y ** 2).astype(np.float32)
    lj = jm.LevelSetGridNormal(elevation, (xs, ys), level=60.0, sigma=4.0)
    lt = tm.LevelSetGridNormal(elevation, (xs, ys), level=60.0, sigma=4.0)
    np.testing.assert_array_equal(lt.data, np.asarray(lj.data))
    np.testing.assert_allclose(lt.heatmap.weights,
                               np.asarray(lj.heatmap.weights), rtol=1e-6,
                               atol=1e-12)
    q = rng(4).uniform(0.0, 100.0, size=(500, 2)).astype(np.float32)
    np.testing.assert_allclose(lt.logpdf(t(q)).numpy(),
                               np.asarray(lj.logpdf(jnp.asarray(q))),
                               atol=2e-5)


def test_heatmap_mean_cov_statistically_like_jax():
    """1024 draws each (PRNGKey(0) cannot be reproduced): means within 1.0
    (their standard error is ~0.16 a package), covariance diagonals within
    25 %."""
    xs, ys, bump = _grid()
    mj, cj = jm.HeatmapGridDensity(bump, (xs, ys)).mean_cov()
    mt, ct = tm.HeatmapGridDensity(bump, (xs, ys)).mean_cov()
    assert np.all(np.abs(mt - np.asarray(mj)) < 1.0), (mt, mj)
    ratio = np.diag(ct) / np.diag(np.asarray(cj))
    assert np.all((0.75 < ratio) & (ratio < 1.25)), ratio


def _bump(cx, cy, xs, ys, s=5.0):
    X, Y = np.meshgrid(xs, ys)
    return np.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2 * s * s))


def test_heatmap_sampling_concentrates():
    """tests/test_extensions.py:28-36 on the port."""
    xs = np.linspace(0.0, 100.0, 50)
    ys = np.linspace(0.0, 100.0, 40)
    h = it.HeatmapGridDensity(_bump(70.0, 30.0, xs, ys), (xs, ys))
    pts = h.sample(_gen(), 2000).numpy()
    assert abs(pts[:, 0].mean() - 70.0) < 3.0
    assert abs(pts[:, 1].mean() - 30.0) < 3.0
    _, cov = h.mean_cov()
    assert np.all(np.isfinite(cov))


def test_levelset_contour():
    """tests/test_extensions.py:39-48 on the port."""
    xs = np.linspace(-50.0, 50.0, 60)
    ys = np.linspace(-50.0, 50.0, 60)
    X, Y = np.meshgrid(xs, ys)
    ls = it.LevelSetGridNormal(np.sqrt(X ** 2 + Y ** 2), (xs, ys),
                               level=30.0, sigma=2.0)
    r = np.linalg.norm(ls.sample(_gen(), 2000).numpy(), axis=1)
    assert abs(r.mean() - 30.0) < 2.0
    assert r.std() < 4.0


def test_heatmap_as_prior_in_graph():
    """tests/test_extensions.py:51-59 on the port."""
    xs = np.linspace(0.0, 100.0, 50)
    ys = np.linspace(0.0, 100.0, 40)
    h = it.HeatmapGridDensity(_bump(70.0, 30.0, xs, ys), (xs, ys))
    fg = it.initfg(device="cpu")
    fg.add_variable("l", it.ContinuousEuclid(2))
    fg.add_factor(["l"], it.Prior(h))
    assert abs(float(fg.points("l")[:, 0].mean()) - 70.0) < 5.0


def test_partial_prior_passthrough_through_eval_factor():
    """tests/test_extensions.py:62-75 on the port, and the dimension mask
    equal to the JAX package's."""
    def run(pkg, dev):
        kw = {"device": dev} if dev else {}
        fg = pkg.initfg(**kw)
        fg.add_variable("x", pkg.ContinuousEuclid(3))
        pkg.init_variable(fg, "x", pkg.MvNormal([1.0, 2.0, 3.0],
                                                [0.1, 0.1, 0.1]))
        f = fg.add_factor(["x"], pkg.PartialPriorPassThrough(
            pkg.Normal(50.0, 1.0), (2,)), graphinit=False)
        mod = (__import__("incrementalinference.jl_tpu.ops.convolve",
                          fromlist=["eval_factor"]) if pkg is jl else None)
        return (mod.eval_factor if mod else eval_factor)(fg, f.label, "x")

    pj, mj = run(jl, None)
    pt, mt = run(it, "cpu")
    assert list(mt.numpy()) == list(np.asarray(mj)) == [False, False, True]
    p = pt.numpy()
    assert abs(p[:, 2].mean() - 50.0) < 2.0
    assert abs(p[:, 0].mean() - 1.0) < 0.5


def test_partial_prior_passthrough_residual_against_jax():
    """The residual on the same inputs, exact."""
    r = rng(5)
    meas = r.normal(size=(20, 1)).astype(np.float32)
    x = r.normal(size=(20, 3)).astype(np.float32)
    mj = jm.PartialPriorPassThrough(jl.Normal(0.0, 1.0), (2,))
    mt = tm.PartialPriorPassThrough(it.Normal(0.0, 1.0), (2,))
    np.testing.assert_array_equal(mt.residual(t(meas), t(x)).numpy(),
                                  np.asarray(mj.residual(meas, x)))


# -- network ensembles --------------------------------------------------------

def _ensembles(spec, key, n_models, x):
    """The same JAX-made ensemble in both packages."""
    pj = jm.nn_init(key, spec, n_models=n_models)
    dj = jm.FluxModelsDistribution(jm.SequentialNet(spec), pj, x,
                                   out_dim=spec[-1][-1] if spec[-1][0] ==
                                   "dense" else spec[-2][-1])
    dt = tm.FluxModelsDistribution(tm.SequentialNet(spec),
                                   ensemble_params_from(pj), x,
                                   out_dim=dj.out_dim)
    return dj, dt


def test_mlp_apply_and_ensemble_against_jax():
    """JAX's ``mlp_init`` weights carried by ``ensemble_params_from``: the
    ensemble outputs, ``logpdf`` and ``mean_cov`` within 1e-5."""
    pj = jm.mlp_init(jax.random.PRNGKey(3), [4, 16, 2], n_models=8)
    x = rng(6).normal(size=(4,)).astype(np.float32)
    dj = jm.FluxModelsDistribution(jm.mlp_apply, pj, x, out_dim=2)
    dt = tm.FluxModelsDistribution(tm.mlp_apply, ensemble_params_from(pj), x,
                                   out_dim=2)
    outs = dt.all_outputs("cpu").numpy()
    np.testing.assert_allclose(outs, np.asarray(dj._all_outputs()),
                               atol=1e-5)
    one = [(W[0], b[0]) for W, b in ensemble_params_from(pj)]
    np.testing.assert_allclose(tm.mlp_apply(one, t(x)).numpy(), outs[0],
                               atol=1e-6)
    q = rng(7).normal(size=(30, 2)).astype(np.float32)
    np.testing.assert_allclose(dt.logpdf(t(q)).numpy(),
                               np.asarray(dj.logpdf(jnp.asarray(q))),
                               atol=1e-5, rtol=1e-5)
    for got, want in zip(dt.mean_cov(), dj.mean_cov()):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name,spec,shape", [
    ("zoo", ZOO, (8, 8, 2)), ("conv", CONV, (8, 8, 1)),
    ("even-k conv", (("conv2d", 2, 3, 4), ("relu",), ("avgpool2d", 2),
                     ("flatten",), ("dense", 4 * 4 * 3, 2)), (8, 8, 2))])
def test_sequentialnet_against_jax(name, spec, shape):
    """Every layer kind of the zoo, the conv ensemble of the solve, and an
    even kernel (XLA's SAME pads its odd pixel at the high end): ensemble
    outputs, ``logpdf`` and ``mean_cov`` within 1e-5."""
    x = rng(8).normal(size=shape).astype(np.float32)
    dj, dt = _ensembles(spec, jax.random.PRNGKey(1), 3, x)
    np.testing.assert_allclose(dt.all_outputs("cpu").numpy(),
                               np.asarray(dj._all_outputs()), atol=1e-5)
    q = rng(9).normal(size=(10, dt.dim)).astype(np.float32)
    np.testing.assert_allclose(dt.logpdf(t(q)).numpy(),
                               np.asarray(dj.logpdf(jnp.asarray(q))),
                               atol=1e-5, rtol=1e-5)
    for got, want in zip(dt.mean_cov(), dj.mean_cov()):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_sequentialnet_layer_zoo():
    """tests/test_extensions.py:342-367 on the port (but its save/load,
    which waits for the persistence slice): softmax sums to 1, draws are
    finite, an unknown layer kind raises."""
    net = it.SequentialNet(ZOO)
    params = it.nn_init(_gen(1), ZOO, n_models=3)
    x = torch.ones((8, 8, 2)) * 0.3
    y = net([(W[0], b[0]) for W, b in params], x)
    assert y.shape == (3,)
    assert abs(float(y.sum()) - 1.0) < 1e-5
    d = it.FluxModelsDistribution(net, params, x, out_dim=3)
    s = d.sample(_gen(2), 12)
    assert s.shape == (12, 3) and bool(torch.isfinite(s).all())
    with pytest.raises(ValueError):
        it.SequentialNet((("nosuch", 1),))(params, x)
    assert net == it.SequentialNet(ZOO) and hash(net) == hash(
        it.SequentialNet(ZOO))


def test_flux_ensemble_distribution():
    """tests/test_extensions.py:78-85 on the port; ``shuffle=False`` cycles
    the members as in the JAX package."""
    params = tm.mlp_init(_gen(), [4, 16, 2], n_models=8)
    d = it.FluxModelsDistribution(tm.mlp_apply, params, torch.ones((4,)),
                                  out_dim=2)
    s = d.sample(_gen(1), 64)
    assert s.shape == (64, 2) and bool(torch.isfinite(s).all())
    _, cov = d.mean_cov()
    assert np.all(np.linalg.eigvalsh(cov) > 0)
    d2 = it.FluxModelsDistribution(tm.mlp_apply, params, torch.ones((4,)),
                                   out_dim=2, shuffle=False)
    np.testing.assert_array_equal(d2.sample(_gen(), 16)[8:].numpy(),
                                  d2.all_outputs("cpu").numpy())


def test_ensemble_params_round_trip():
    """JAX layout -> port -> JAX layout is the identity, and conv weights
    land in torch's (E, out, in, k, k)."""
    pj = jm.nn_init(jax.random.PRNGKey(4), ZOO, n_models=2)
    pt = ensemble_params_from(pj)
    assert tuple(pt[0][0].shape) == (2, 3, 2, 3, 3)
    for (Wj, bj), (W, b) in zip(pj, ensemble_params_to(pt)):
        np.testing.assert_array_equal(W, np.asarray(Wj))
        np.testing.assert_array_equal(b, np.asarray(bj))


def test_flux_mixture_relative_solve():
    """tests/test_extensions.py:130-162 on the port (its save/load half
    waits for the persistence slice): near 0 > 20 %, near 10 > 5 %."""
    params = tm.mlp_init(_gen(3), [4, 8, 1], n_models=16)
    nn = it.FluxModelsDistribution(tm.mlp_apply, params, torch.ones((4,)),
                                   out_dim=1)
    fg = it.initfg(it.SolverParams(N=150), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.1)))
    fg.add_factor(["x0", "x1"], it.Mixture(it.LinearRelative,
                                           [nn, it.Normal(10.0, 1.0)],
                                           [0.5, 0.5]))
    it.solve_tree(fg)
    pts = fg.points("x1")[:, 0].numpy()
    assert np.sum((-3.0 < pts) & (pts < 3.0)) > 0.2 * len(pts)
    assert np.sum((5.0 < pts) & (pts < 15.0)) > 0.05 * len(pts)


def test_sequentialnet_conv_mixture_solve():
    """tests/test_extensions.py:290-325 on the port (its save/load half
    waits for the persistence slice)."""
    net = it.SequentialNet(CONV)
    nn = it.FluxModelsDistribution(net, it.nn_init(_gen(7), CONV, n_models=8),
                                   torch.ones((8, 8, 1)) * 0.1, out_dim=1)
    pred = nn.sample(_gen(), 8)
    assert pred.shape == (8, 1) and bool(torch.isfinite(pred).all())
    fg = it.initfg(it.SolverParams(N=100), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.1)))
    fg.add_factor(["x0", "x1"], it.MixtureFluxModels(
        it.LinearRelative, nn, [it.Normal(10.0, 1.0)], [0.5, 0.5]))
    it.solve_tree(fg)
    pts = fg.points("x1")[:, 0].numpy()
    assert np.all(np.isfinite(pts))
    assert np.sum((5.0 < pts) & (pts < 15.0)) > 0.05 * len(pts)


# -- ODE factors --------------------------------------------------------------

def test_rk4_against_jax():
    """``rk4_integrate`` within 1e-5 of the JAX package's: the exponential
    of tests/test_extensions.py:88-90 (and e^-1 to 1e-5), a 2-D rotation
    with a parameter, forward and backward."""
    xj = jm.rk4_integrate(lambda tt, x: -x, jnp.asarray([1.0]), 0.0, 1.0, 32)
    xt = tm.rk4_integrate(lambda tt, x: -x, torch.tensor([1.0]), 0.0, 1.0, 32)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(float(xt[0]), np.exp(-1.0), atol=1e-5)
    x0 = rng(10).normal(size=(2,)).astype(np.float32)
    w = np.float32(1.3)

    def fj(tt, x, om):
        return jnp.stack([-om * x[1], om * x[0]]) * (1.0 + 0.1 * tt)

    def ft(tt, x, om):
        return torch.stack([-om * x[1], om * x[0]]) * (1.0 + 0.1 * tt)

    for a, b in ((0.0, 2.0), (2.0, 0.5)):
        np.testing.assert_allclose(
            tm.rk4_integrate(ft, t(x0), a, b, 16, torch.tensor(w)).numpy(),
            np.asarray(jm.rk4_integrate(fj, jnp.asarray(x0), a, b, 16,
                                        jnp.asarray(w))), atol=1e-5)


def _forced_pair():
    """The forced ODE of tests/test_extensions.py:178-226: ẋ = −x/2 + u(t),
    u the ramp 2t on a 9-point grid passed as ``data``."""
    tgrid = np.linspace(0.0, 2.0, 9).astype(np.float32)
    data = np.stack([tgrid, 2.0 * tgrid])

    def fj(tt, x, u):
        return -0.5 * x + jnp.interp(tt, u[0], u[1])

    def ft(tt, x, u):
        return torch.add(interp_uniform(tt, u, 0.0, 0.25), x, alpha=-0.5)

    kw = dict(t0=0.0, t1=2.0, dim=1, steps=32, data=data)
    return (jm.DERelative(fj, Z=jl.MvNormal([0.0], [0.01]), **kw),
            tm.DERelative(ft, Z=it.MvNormal([0.0], [0.01]), **kw))


def _decay_pair():
    """The n-ary decay of tests/test_extensions.py:229-254: ẋ = −k x."""
    kw = dict(t0=0.0, t1=2.0, dim=1, steps=32)
    return (jm.DERelative(lambda tt, x, k: -k[0] * x,
                          Z=jl.MvNormal([0.0], [1e-4]), **kw),
            tm.DERelative(lambda tt, x, k: -k[..., :1] * x,
                          Z=it.MvNormal([0.0], [1e-4]), **kw))


def test_derelative_flow_and_residual_against_jax():
    """``DERelative.flow`` forward and backward with forcing data and with
    an extra variable, and the residual on the same points: 1e-5 of JAX."""
    dj, dt = _forced_pair()
    x0 = np.asarray([1.0], np.float32)
    np.testing.assert_allclose(dt.flow(t(x0)).numpy(),
                               np.asarray(dj.flow(jnp.asarray(x0))),
                               atol=1e-5)
    x1 = np.asarray(dj.flow(jnp.asarray(x0)))
    assert abs(float(x1[0]) - (8.0 - 8.0 + 9.0 * np.exp(-1.0))) < 1e-3
    np.testing.assert_allclose(
        dt.flow(t(x1), backward=True).numpy(),
        np.asarray(dj.flow(jnp.asarray(x1), backward=True)), atol=1e-5)
    r = rng(11)
    meas = r.normal(0.0, 0.01, size=(1,)).astype(np.float32)
    a, b = r.normal(size=(2, 1)).astype(np.float32)
    np.testing.assert_allclose(dt.residual(t(meas), t(a), t(b)).numpy(),
                               np.asarray(dj.residual(meas, a, b)),
                               atol=1e-5)
    kj, kt = _decay_pair()
    k = np.asarray([0.7], np.float32)
    for back in (False, True):
        np.testing.assert_allclose(
            kt.flow(t([2.0]), t(k), backward=back).numpy(),
            np.asarray(kj.flow(jnp.asarray([2.0]), jnp.asarray(k),
                               backward=back)), atol=1e-5)
    np.testing.assert_allclose(
        kt.residual(t(meas), t(a), t(b), t(k)).numpy(),
        np.asarray(kj.residual(meas, a, b, k)), atol=1e-5)


def test_derelative_in_graph():
    """tests/test_extensions.py:93-105 on the port: x1 = 5 + 2·3."""
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(5.0, 0.1)))
    fg.add_factor(["x0", "x1"], it.DERelative(
        lambda tt, x: torch.full_like(x, 2.0), t0=0.0, t1=3.0, dim=1))
    it.solve_tree(fg)
    m = float(fg.points("x1")[:, 0].mean())
    assert abs(m - 11.0) < 1.0, m


def test_derelative_decay_chain():
    """tests/test_extensions.py:108-127 on the port: x_i = e^{-i}."""
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(1.0, 0.01)))
    for i in range(1, 4):
        fg.add_variable(f"x{i}", it.ContinuousScalar)
        fg.add_factor([f"x{i - 1}", f"x{i}"], it.DERelative(
            lambda tt, x: scaled(x, -0.2), t0=5.0 * (i - 1), t1=5.0 * i,
            Z=it.MvNormal([0.0], [0.01]), dim=1, steps=32))
    it.solve_tree(fg)
    for i in range(4):
        m = float(fg.points(f"x{i}")[:, 0].mean())
        assert abs(m - float(np.exp(-i))) < 0.1, (i, m)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_derelative_forcing_data_both_directions(direction):
    """tests/test_extensions.py:178-226 on the port: the prior on x0 puts
    x1 on the flow's endpoint; a prior on x1 alone recovers x0 through the
    flow map (bars 0.25)."""
    _, de = _forced_pair()
    x1_truth = float(de.flow(torch.tensor([1.0]))[0])
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    if direction == "forward":
        fg.add_factor(["x0"], it.Prior(it.Normal(1.0, 0.05)))
    else:
        fg.add_factor(["x1"], it.Prior(it.Normal(x1_truth, 0.05)))
    fg.add_factor(["x0", "x1"], de)
    it.solve_tree(fg)
    if direction == "forward":
        m = float(fg.points("x1")[:, 0].mean())
        assert abs(m - x1_truth) < 0.25, (m, x1_truth)
    else:
        m = float(fg.points("x0")[:, 0].mean())
        assert abs(m - 1.0) < 0.25, m
    back = float(de.flow(torch.tensor([x1_truth]), backward=True)[0])
    assert abs(back - 1.0) < 1e-3, back


def test_derelative_nary_parameter_variable():
    """tests/test_extensions.py:229-254 on the port: the decay rate k from
    two observed states (|mean(k) − 0.7| < 0.15)."""
    _, de = _decay_pair()
    x1_truth = 2.0 * float(np.exp(-1.4))
    fg = it.initfg(device="cpu")
    for v in ("x0", "x1", "k"):
        fg.add_variable(v, it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(2.0, 0.02)))
    fg.add_factor(["x1"], it.Prior(it.Normal(x1_truth, 0.02)))
    fg.add_factor(["k"], it.Prior(it.Normal(0.5, 0.5)))
    fg.add_factor(["x0", "x1", "k"], de)
    it.solve_tree(fg)
    mk = float(fg.points("k")[:, 0].mean())
    assert abs(mk - 0.7) < 0.15, mk


# -- carried between the packages ---------------------------------------------

def _family_graph(pkg, dev=None):
    """One graph with every new model in it, built in either package."""
    kw = {"device": dev} if dev else {}
    fg = pkg.initfg(pkg.SolverParams(N=30), **kw)
    xs = np.linspace(0.0, 100.0, 20, dtype=np.float32)
    ys = np.linspace(0.0, 50.0, 10, dtype=np.float32)
    _, _, bump = _grid(H=10, W=20)
    models = jm if pkg is jl else tm
    for v in ("l", "m", "p"):
        fg.add_variable(v, pkg.ContinuousEuclid(2))
    for v in ("a", "b"):
        fg.add_variable(v, pkg.ContinuousScalar)
    fg.add_factor(["l"], pkg.Prior(pkg.HeatmapGridDensity(bump, (xs, ys))),
                  graphinit=False, label="lheat")
    fg.add_factor(["m"], pkg.Prior(pkg.LevelSetGridNormal(
        bump * 10.0, (xs, ys), level=5.0, sigma=1.5)), graphinit=False,
        label="mlevel")
    fg.add_factor(["p"], pkg.PartialPriorPassThrough(
        pkg.Normal(3.0, 1.0), (1,)), graphinit=False, label="ppass")
    x = rng(12).normal(size=(8, 8, 1)).astype(np.float32)
    pj = jm.nn_init(jax.random.PRNGKey(5), CONV, n_models=4)
    params = pj if pkg is jl else ensemble_params_from(pj)
    nn = pkg.FluxModelsDistribution(models.SequentialNet(CONV), params, x,
                                    out_dim=1)
    mp = jm.mlp_init(jax.random.PRNGKey(6), [3, 5, 1], n_models=3)
    mlp = pkg.FluxModelsDistribution(
        models.mlp_apply, mp if pkg is jl else ensemble_params_from(mp),
        np.ones(3, np.float32), out_dim=1, shuffle=False)
    fg.add_factor(["a", "b"], pkg.MixtureFluxModels(
        pkg.LinearRelative, nn, [pkg.Normal(10.0, 1.0), mlp], [0.4, 0.3, 0.3]),
        graphinit=False, label="abflux")
    dj, dt = _forced_pair()
    fg.add_factor(["a", "b"], dj if pkg is jl else dt, graphinit=False,
                  label="abode")
    return fg


def test_new_models_carried_from_jax_and_back():
    """JAX graph -> arrays -> port graph -> arrays: the arrays equal; the
    carried models compute what the JAX ones do (grid log densities 1e-6,
    ensemble outputs and the ODE flow 1e-5); a DERelative without its
    function raises, naming the factor."""
    gj = _family_graph(jl)
    spec = jax_graph_to_arrays(gj)
    with pytest.raises(ValueError, match="abode"):
        graph_from_arrays(spec, device="cpu")
    _, dt = _forced_pair()
    gt = graph_from_arrays(spec, device="cpu", functions={"abode": dt.f})
    back = graph_to_arrays(gt)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b), (set(a), set(b))
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            # rtol 1e-6: the port normalizes the mixture weights again
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=0)
        elif isinstance(a, float):
            assert a == pytest.approx(b)
        else:
            assert a == b, (a, b)

    same(spec["factors"], back["factors"])
    q = rng(13).uniform(0.0, 100.0, size=(200, 2)).astype(np.float32)
    for fl in ("lheat", "mlevel"):
        np.testing.assert_allclose(
            gt.factor(fl).model.Z.logpdf(t(q)).numpy(),
            np.asarray(gj.factor(fl).model.Z.logpdf(jnp.asarray(q))),
            atol=2e-5)
    mixj, mixt = gj.factor("abflux").model, gt.factor("abflux").model
    for cj, ct in ((mixj.components[0], mixt.components[0]),
                   (mixj.components[2], mixt.components[2])):
        np.testing.assert_allclose(ct.all_outputs("cpu").numpy(),
                                   np.asarray(cj._all_outputs()), atol=1e-5)
    assert not mixt.components[2].shuffle
    odej, odet = gj.factor("abode").model, gt.factor("abode").model
    np.testing.assert_allclose(odet.flow(torch.tensor([1.0])).numpy(),
                               np.asarray(odej.flow(jnp.asarray([1.0]))),
                               atol=1e-5)
    assert gt.factor("ppass").model.partial == (1,)


def test_new_models_round_trip_in_the_port():
    """Port graph -> arrays -> port graph -> arrays is the identity on the
    factors, and the carried ensemble gives the same draws."""
    g = _family_graph(it, "cpu")
    _, dt = _forced_pair()
    a = graph_to_arrays(g)
    g2 = graph_from_arrays(a, device="cpu", functions={"abode": dt.f})
    b = graph_to_arrays(g2)
    for fa, fb in zip(a["factors"], b["factors"]):
        assert fa.keys() == fb.keys()
        assert fa["type"] == fb["type"]
    c1 = g.factor("abflux").model.components[0]
    c2 = g2.factor("abflux").model.components[0]
    np.testing.assert_array_equal(c1.sample(_gen(4), 16).numpy(),
                                  c2.sample(_gen(4), 16).numpy())

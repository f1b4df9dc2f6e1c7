"""Mixture, range and multihypothesis factors of the port on the CPU: the
deterministic parts against the JAX package on the same numpy inputs, the
stochastic solves at the bars of the JAX package's own tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import rng, t

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu.ops import hypo as jhypo
from incrementalinference_torch import keys as tkeys
from incrementalinference_torch.ops import hypo as thypo
from incrementalinference_torch.ops.convolve import eval_factor


class _Fixed:
    """A component whose draw is the array it was given (either package)."""

    def __init__(self, rows):
        self.rows = rows
        self.dim = rows.shape[-1]

    def sample(self, _key_or_gen, n):
        return self.rows[:n]


def test_mixture_sample_matches_jax_with_labels_passed_in(monkeypatch):
    """Both packages' ``Mixture.sample`` on the same component draws and the
    same labels: 1e-6 absolute, float32; ``labels`` keeps the draw."""
    r = rng(3)
    n, C, z = 500, 4, 2
    draws = r.normal(size=(C, n, z)).astype(np.float32)
    labels = r.integers(0, C, size=n)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, shape: jnp.asarray(labels))
    monkeypatch.setattr(torch, "multinomial",
                        lambda w, k, replacement, generator:
                        torch.as_tensor(labels))
    mj = jl.Mixture(jl.Prior, [_Fixed(jnp.asarray(d)) for d in draws])
    mt = it.Mixture(it.Prior, [_Fixed(t(d)) for d in draws])
    got_j = np.asarray(mj.sample(jax.random.PRNGKey(0), n))
    got_t = mt.sample(tkeys.generator(1, "cpu"), n).numpy()
    assert got_t.shape == (n, z)
    np.testing.assert_allclose(got_t, got_j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(mt.labels.numpy(), np.asarray(mj.labels))
    np.testing.assert_array_equal(got_t, draws[labels, np.arange(n)])


def test_mixture_draws_differ_between_calls_and_follow_the_weights():
    """keys.spawn moves the generator on: a second draw is another one; the
    labels follow ``diversity``."""
    m = it.Mixture(it.Prior, [it.Normal(-10, 1), it.Normal(10, 1)],
                   [0.2, 0.8])
    gen = tkeys.generator(5, "cpu")
    a, b = m.sample(gen, 4000), m.sample(gen, 4000)
    assert not torch.equal(a, b)
    assert abs(float((a > 0).float().mean()) - 0.8) < 0.03
    again = m.sample(tkeys.generator(5, "cpu"), 4000)
    torch.testing.assert_close(a, again, atol=0, rtol=0)


@pytest.mark.parametrize("dof", [1, 2, 3])
def test_euclid_distance_residual_matches_jax(dof):
    """1e-6 absolute in float32, on inputs of unit scale."""
    r = rng(dof)
    meas = r.normal(1.0, 0.1, size=(64, 1)).astype(np.float32)
    x1 = r.normal(0, 1, size=(64, dof)).astype(np.float32)
    x2 = r.normal(0, 1, size=(64, dof)).astype(np.float32)
    x2[0] = x1[0]                      # zero distance: the 1e-12 under the root
    fj = jl.EuclidDistance(jl.Normal(1.0, 0.1))
    ft = it.EuclidDistance(it.Normal(1.0, 0.1))
    got_j = np.asarray(fj.residual(jnp.asarray(meas), jnp.asarray(x1),
                                   jnp.asarray(x2)))
    got_t = ft.residual(t(meas), t(x1), t(x2)).numpy()
    np.testing.assert_allclose(got_t, got_j, atol=1e-6, rtol=0)
    assert ft.zdim == fj.zdim == 1


def _components(pkg, kind):
    if kind == "scalar":
        return [pkg.Normal(-100, 3.0), pkg.Normal(0, 3.0),
                pkg.Uniform(90.0, 110.0), pkg.Rayleigh(4.0)], \
            [0.1, 0.2, 0.3, 0.4]
    return [pkg.MvNormal([0.0, 1.0], [1.0, 2.0]),
            pkg.MvNormal([5.0, -1.0], [[2.0, 0.3], [0.3, 1.0]])], None


@pytest.mark.parametrize("kind", ["scalar", "euclid2"])
def test_mixture_mean_cov_matches_jax(kind):
    """Moment-matched Gaussian and per-component moments: 1e-5 relative to
    the largest entry."""
    mech = {"scalar": "Prior", "euclid2": "LinearRelative"}[kind]
    cj, wj = _components(jl, kind)
    ct, wt = _components(it, kind)
    mj = jl.Mixture(getattr(jl, mech), cj, wj)
    mt = it.Mixture(getattr(it, mech), ct, wt)
    assert mt.is_prior == mj.is_prior
    assert mt.linear_residual == mj.linear_residual
    assert mt.zdim == mj.zdim
    for got, want in zip(mt.mean_cov() + mt.mixture_mean_cov(),
                         mj.mean_cov() + mj.mixture_mean_cov()):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def _dist_pairs():
    r = rng(11)
    grid = np.arange(1.0, 51.0)
    w = r.random(50)
    pts = r.normal(0.0, 2.0, size=(75, 1)).astype(np.float32)
    return {
        "Uniform": (lambda p: p.Uniform(-2.0, 3.0),
                    r.uniform(-3, 4, size=(40, 1))),
        "Rayleigh": (lambda p: p.Rayleigh(2.5), r.uniform(-1, 8, (40, 1))),
        "Categorical": (lambda p: p.Categorical([0.1, 0.2, 0.7]),
                        r.integers(0, 3, size=(40, 1)).astype(np.float64)),
        "AliasingScalarSampler": (
            lambda p: p.AliasingScalarSampler(grid, w, snr_floor=0.2),
            r.uniform(0, 52, size=(40, 1))),
        "manikde": (lambda p: p.manikde(p.ContinuousScalar, pts, bw=[0.7]),
                    r.uniform(-5, 5, size=(40, 1))),
    }


@pytest.mark.parametrize("name", ["Uniform", "Rayleigh", "Categorical",
                                  "AliasingScalarSampler", "manikde"])
def test_distribution_matches_jax(name):
    """logpdf and mean_cov on the same inputs (1e-5); draws have the
    distribution's own mean and spread."""
    make, x = _dist_pairs()[name]
    x = x.astype(np.float32)
    dj, dt = make(jl), make(it)
    lj = np.asarray(dj.logpdf(jnp.asarray(x)))
    lt = dt.logpdf(t(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(lt), np.isfinite(lj))
    fin = np.isfinite(lj)
    np.testing.assert_allclose(lt[fin], lj[fin], atol=1e-5, rtol=1e-5)
    for got, want in zip(dt.mean_cov(), dj.mean_cov()):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    s = dt.sample(tkeys.generator(2, "cpu"), 20000)
    assert s.shape == (20000, 1)
    m, c = dt.mean_cov()
    sd = float(np.sqrt(c[0, 0]))
    extra = 0.7 if name == "manikde" else 0.0      # the kernel's own width
    assert abs(float(s.mean()) - float(m[0])) < 0.05 * max(sd, 1.0)
    assert abs(float(s.std()) - float(np.hypot(sd, extra))) < 0.05 * max(sd, 1)


def test_manikde_selects_the_jax_bandwidth():
    pts = rng(4).normal(0.0, 1.0, size=(100, 1)).astype(np.float32)
    bj = jl.manikde(jl.ContinuousScalar, pts).belief
    bt = it.manikde(it.ContinuousScalar, pts).belief
    np.testing.assert_allclose(bt.bw.numpy(), np.asarray(bj.bw), rtol=1e-5)
    np.testing.assert_array_equal(bt.points.numpy(), np.asarray(bj.points))


# -- tests/test_hypo_recipe.py on the port's build_masks ---------------------

_RECIPES = {
    "nullhypo-only": (2, None, 0.5, 0),
    "no-hypo": (2, None, 0.0, 0),
    "multihypo-certain-target": (3, (1.0, 0.5, 0.5), 0.0, 0),
    "multihypo-uncertain-target": (3, (1.0, 0.5, 0.5), 0.1, 1),
    "multihypo-other-uncertain-target": (3, (1.0, 0.5, 0.5), 0.1, 2),
}


@pytest.mark.parametrize("case", list(_RECIPES))
def test_build_masks_match_jax_on_identical_mhidx(case):
    """The JAX package draws the hypothesis ids; both packages build the
    masks from them: exact equality."""
    nvars, multihypo, nullhypo, sfidx = _RECIPES[case]
    mh = jhypo.draw_hypotheses(jax.random.PRNGKey(7), 2000, nvars, multihypo,
                               nullhypo)
    mj = jhypo.build_masks(mh, sfidx, nvars, multihypo)
    mt = thypo.build_masks(torch.as_tensor(np.asarray(mh), dtype=torch.int64),
                           sfidx, nvars, multihypo)
    for f in ("solve_mask", "null_mask", "snap_mask"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(mj, f)), err_msg=f)
    assert mt.mech_vars == mj.mech_vars
    assert mt.uncertain_slot == mj.uncertain_slot
    if mj.gather_idx is None:
        assert mt.gather_idx is None
    else:
        np.testing.assert_array_equal(mt.gather_idx.numpy(),
                                      np.asarray(mj.gather_idx))
    assert thypo.parse_multihypo(multihypo) == jhypo.parse_multihypo(
        multihypo)


def test_port_hypothesis_draws_follow_the_weights():
    mh = thypo.draw_hypotheses(9, 4000, 3, (1.0, 0.25, 0.75), 0.2, "cpu")
    frac = [float((mh == k).float().mean()) for k in range(4)]
    assert frac[1] == 0.0
    for got, want in zip((frac[0], frac[2], frac[3]), (0.2, 0.2, 0.6)):
        assert abs(got - want) < 0.03, frac
    with pytest.raises(ValueError):
        thypo.parse_multihypo((1.0, 0.4, 0.4))


# -- solves at the JAX tests' bars -------------------------------------------

def _mass(fg, v, c, tol=3.0):
    p = fg.points(v)[:, 0].numpy()
    return float(np.mean(np.abs(p - c) < tol))


def test_three_door_multihypo_association():
    """tests/test_multihypo_tree.py:16."""
    fg = it.initfg(it.SolverParams(N=200, gibbs_iters=5), device="cpu")
    doors = {"l0": 0.0, "l1": 10.0, "l2": 20.0, "l3": 40.0}
    for lbl, c in doors.items():
        fg.add_variable(lbl, it.ContinuousScalar)
        fg.add_factor([lbl], it.Prior(it.Normal(c, 0.01)))
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0", "l0", "l1", "l2", "l3"],
                  it.LinearRelative(it.Normal(0.0, 0.25)),
                  multihypo=[1.0, 0.25, 0.25, 0.25, 0.25])
    it.solve_tree(fg)
    masses = [_mass(fg, "x0", c) for c in doors.values()]
    assert sum(masses) > 0.75, masses
    assert sum(m > 0.08 for m in masses) >= 3, masses

    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 0.1)))
    fg.add_factor(["x1", "l0", "l1", "l2", "l3"],
                  it.LinearRelative(it.Normal(0.0, 0.25)),
                  multihypo=[1.0, 0.25, 0.25, 0.25, 0.25])
    it.solve_tree(fg)
    m_x1 = [_mass(fg, "x1", c) for c in (10.0, 20.0)]
    assert sum(m_x1) > 0.6, m_x1
    bad = [_mass(fg, "x1", c) for c in (0.0, 40.0, 30.0, 50.0)]
    assert sum(bad) < 0.25, bad
    for lbl, c in doors.items():
        assert _mass(fg, lbl, c, 1.0) > 0.9, lbl


def test_nullhypo_through_tree():
    """tests/test_multihypo_tree.py:52."""
    fg = it.initfg(device="cpu")
    fg.add_variable("a", it.ContinuousScalar)
    fg.add_factor(["a"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_variable("b", it.ContinuousScalar)
    fg.add_factor(["a", "b"], it.LinearRelative(it.Normal(10.0, 1.0)),
                  nullhypo=0.2)
    it.solve_tree(fg)
    p = fg.points("b")[:, 0].numpy()
    assert np.mean(np.abs(p - 10.0) < 5.0) > 0.6
    assert np.all(np.isfinite(p))


def test_multihypo_with_odometry_chain():
    """tests/test_multihypo_tree.py:68."""
    fg = it.initfg(it.SolverParams(N=150), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.3)))
    for i in (1, 2):
        fg.add_variable(f"x{i}", it.ContinuousScalar)
        fg.add_factor([f"x{i - 1}", f"x{i}"],
                      it.LinearRelative(it.Normal(5.0, 0.3)))
    for lbl, c in (("la", 14.0), ("lb", 26.0)):
        fg.add_variable(lbl, it.ContinuousScalar)
        fg.add_factor([lbl], it.Prior(it.Normal(c, 0.1)))
    fg.add_factor(["x2", "la", "lb"], it.LinearRelative(it.Normal(4.0, 0.5)),
                  multihypo=[1.0, 0.5, 0.5])
    it.solve_tree(fg)
    for i, c in ((0, 0.0), (1, 5.0), (2, 10.0)):
        p = fg.points(f"x{i}")[:, 0].numpy()
        assert np.mean(np.abs(p - c) < 3.0) > 0.7, (i, p.mean())
    assert _mass(fg, "la", 14.0, 1.0) > 0.9
    assert _mass(fg, "lb", 26.0, 1.0) > 0.9


def _mode_stats(pts):
    n = pts.shape[0]
    return {"lo": np.sum((-5 < pts) & (pts < 5)) / n,
            "hi": np.sum((5 < pts) & (pts < 15)) / n,
            "above": np.sum(pts > 15) / n, "below": np.sum(pts < -5) / n,
            "valley": np.sum((3 < pts) & (pts < 7)) / n}


@pytest.mark.parametrize("mechanics", ["Prior", "LinearRelative"])
def test_mixture_conv_sampling_bimodal(mechanics):
    """tests/test_priors_mixtures.py:82 and :97: the convolution through a
    two-mode mixture is bimodal with an empty valley."""
    fg = it.initfg(it.SolverParams(N=200), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    comps = [it.Normal(0.0, 1.0), it.Normal(10.0, 1.0)]
    if mechanics == "Prior":
        f = fg.add_factor(["x0"], it.Mixture(it.Prior, comps, [0.5, 0.5]))
        target = "x0"
    else:
        fg.add_variable("x1", it.ContinuousScalar)
        fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)), graphinit=False)
        it.init_variable(fg, "x0", [np.zeros(1) for _ in range(200)])
        f = fg.add_factor(["x0", "x1"],
                          it.Mixture(it.LinearRelative, comps, [0.5, 0.5]),
                          graphinit=False)
        target = "x1"
    pts, dim_mask = eval_factor(fg, f.label, target)
    assert bool(dim_mask.all())
    s = _mode_stats(pts[:, 0].numpy())
    assert s["lo"] > 0.2 and s["hi"] > 0.2, s
    assert s["above"] < 0.1 and s["below"] < 0.1, s
    assert s["valley"] < 0.1, s


def test_simple_mixture_posterior_split_stats():
    """tests/test_priors_mixtures.py:116."""
    fg = it.initfg(it.SolverParams(N=150), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.1)))
    fg.add_factor(["x0", "x1"],
                  it.Mixture(it.LinearRelative,
                             [it.Normal(-1.0, 0.1), it.Normal(1.0, 0.1)],
                             [0.5, 0.5]))
    it.solve_tree(fg)
    x0 = fg.points("x0")[:, 0].numpy()
    assert abs(x0.mean()) < 0.15, x0.mean()
    assert abs(x0.std() - 0.1) < 0.07, x0.std()
    x1 = fg.points("x1")[:, 0].numpy()
    pos, neg = x1[x1 >= 0], x1[x1 < 0]
    assert len(pos) > 0.2 * len(x1) and len(neg) > 0.2 * len(x1)
    assert abs(pos.mean() - 1.0) < 0.2, pos.mean()
    assert abs(neg.mean() + 1.0) < 0.2, neg.mean()


def test_mixture_prior_with_alias_sampler_and_kde_component():
    """tests/test_priors_mixtures.py:142 and :227 without their save/load
    legs: a weighted-grid sampler and a KDE as mixture components."""
    r = np.random.default_rng(42)
    v = r.random(50)
    v[19:29] += 5 * r.random(10)
    bss = it.AliasingScalarSampler(np.arange(1.0, 51.0), v / v.sum())
    N = 100
    fg = it.initfg(it.SolverParams(N=N), device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    f1 = fg.add_factor(["x0"], it.Mixture(it.Prior,
                                          [it.Normal(-5.0, 1.0), bss],
                                          [0.5, 0.5]))
    smpls = eval_factor(fg, f1.label, "x0")[0][:, 0].numpy()
    assert abs(np.sum(smpls < -2.5) - np.sum(smpls > -2.5)) < 0.35 * N
    it.solve_tree(fg)
    marg = fg.points("x0")[:, 0].numpy()
    assert abs(np.sum(marg < -2.5) - np.sum(marg > -2.5)) < 0.35 * N

    fg = it.initfg(it.SolverParams(N=N), device="cpu")
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x1"], it.Prior(it.manikde(it.ContinuousScalar,
                                              np.zeros((100, 1)), bw=[3.0])))
    fg.add_variable("x2", it.ContinuousScalar)
    fg.add_factor(["x1", "x2"], it.LinearRelative(it.Normal(50.0, 2.0)))
    fancy = it.manikde(it.ContinuousScalar, r.normal(0.0, 1.0, (75, 1)))
    fg.add_variable("x3", it.ContinuousScalar)
    fg.add_factor(["x2", "x3"], it.Mixture(
        it.LinearRelative, [fancy, it.Normal(0.0, 10.0)], [0.4, 0.6]))
    it.solve_tree(fg)
    assert abs(float(fg.points("x2").mean()) - 50.0) < 15.0
    assert abs(float(fg.points("x3").mean()) - 50.0) < 20.0


def test_euclid_distance_multimodal():
    """tests/test_solve.py:172-193: two range rings meet in two modes.  The
    range residual is not linear: dof 2 through the LM branch of
    batched_gauss_newton."""
    fg = it.generate_euclid_distance(device="cpu")
    it.solve_tree(fg)
    pts = fg.points("l1").numpy()
    d_a = np.linalg.norm(pts - np.array([0.0, 0.0]), axis=1)
    d_b = np.linalg.norm(pts - np.array([100.0, 100.0]), axis=1)
    frac_a, frac_b = np.mean(d_a < 30), np.mean(d_b < 30)
    assert frac_a > 0.04 and frac_b > 0.04, (frac_a, frac_b)
    assert frac_a + frac_b > 0.6, (frac_a, frac_b)
    r1 = np.abs(np.linalg.norm(pts - np.array([100.0, 0.0]), axis=1) - 100)
    r2 = np.abs(np.linalg.norm(pts - np.array([0.0, 100.0]), axis=1) - 100)
    assert np.mean(r1 < 15) > 0.85 and np.mean(r2 < 15) > 0.85

"""Concurrent solves in one process: one graph per thread.

The port's Jacobians are reverse mode (``torch.func.jacrev`` under
``vmap``), whose transform levels are per thread; forward mode's dual
levels are global to the process, so two threads in ``jacfwd`` at once
raise or, worse, read each other's tangents.  Each case here builds and
solves its own graph on two threads at once, both released by one
barrier, and holds each thread's result bit-equal (``torch.equal``) to the
same graph solved alone on the main thread first: alone, a CPU solve of a
seeded graph is deterministic.  A guard makes entering a forward-AD level
raise and runs every family through it; a user's own ``vmap(jacfwd(f))``
loop on another thread beside a solve keeps its Jacobians.  Solving the
*same* graph from two threads is out of scope, as in the JAX package.

The Jacobian sites against the JAX package's ``jacfwd`` of the matching
function, on identical numpy inputs: float32 on both sides, every entry
within 1e-5·(1 + |J|) (``SITE_TOL``).

Every barrier has a 30 s timeout and every join a deadline, so a failing
thread fails the test instead of hanging it.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from torch_port_helpers import rng, t

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference_torch.ops import convolve, deconv
from incrementalinference_torch.ops.gradients import factor_jacobian
from incrementalinference_torch.parallel.mesh import (
    Mesh, shard_group_arrays, sharded_normal_equations)
from incrementalinference_torch.parametric.solver import ParametricProblem

CPU = torch.device("cpu")
SITE_TOL = 1e-5
JOIN_S = 240.0


def concurrently(*fns):
    """Each of ``fns`` on its own thread, all released by one barrier;
    their results in order.  A thread's exception is raised here (and
    breaks the barrier, so no other thread waits for it); a thread still
    running after ``JOIN_S`` fails the test."""
    barrier = threading.Barrier(len(fns), timeout=30)
    out, errors = [None] * len(fns), []

    def run(i, fn):
        try:
            barrier.wait()
            out[i] = fn()
        except BaseException as e:             # noqa: BLE001 - re-raised
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads), "a thread hung"
    if errors:
        raise errors[0]
    return out


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), \
            float((g.double() - w.double()).abs().max())


# ----------------------------------------------------------------- families
# Each builds its graph on the calling thread (graph building runs the
# graphinit convolutions) and returns the tensors that must not move.

def two_variable(n=100):
    """The ROADMAP recipe: Prior(Normal(0, 1)) on x0, LinearRelative(
    Normal(10, 1)), Prior(Normal(10, 1)) on x1."""
    fg = it.initfg(it.SolverParams(N=n), device=CPU)
    for v in ("x0", "x1"):
        fg.add_variable(v, it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)))
    fg.add_factor(["x1"], it.Prior(it.Normal(10.0, 1.0)))
    it.solve_tree(fg)
    return (fg.points("x1").clone(),)


def _se2_graph(n=32):
    se2 = it.SE2()
    pose2 = it.VariableType("Pose2", se2)
    fg = it.initfg(it.SolverParams(N=n), device=CPU)
    fg.add_variable("x0", pose2)
    fg.add_factor(["x0"], it.ManifoldPrior(se2, np.zeros(3), it.MvNormal(
        [0.0] * 3, [0.1, 0.1, 0.05])))
    fg.add_variable("x1", pose2)
    f = fg.add_factor(["x0", "x1"], it.ManifoldFactor(se2, it.MvNormal(
        [10.0, 0.0, math.pi / 3], [0.5, 0.5, 0.05])))
    return fg, f.label


def se2_two_pose():
    """ManifoldFactor on SE(2): the convolution's LM loop."""
    fg, _ = _se2_graph()
    it.solve_tree(fg)
    return fg.points("x0").clone(), fg.points("x1").clone()


def derelative(n=32, steps=4):
    """A DERelative through a few RK4 steps."""
    fg = it.initfg(it.SolverParams(N=n), device=CPU)
    for v in ("x0", "x1"):
        fg.add_variable(v, it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(5.0, 0.1)))
    fg.add_factor(["x0", "x1"], it.DERelative(
        lambda tt, x: torch.sin(x), t0=0.0, t1=1.0, steps=steps))
    it.solve_tree(fg)
    return fg.points("x0").clone(), fg.points("x1").clone()


def approx_deconv():
    fg, label = _se2_graph()
    solved, sampled = it.approx_deconv(fg, label, key=7)
    return solved, sampled


def factor_jacobian_se2():
    fg, label = _se2_graph()
    return (factor_jacobian(fg, label),
            factor_jacobian(fg, label, meas=[8.0, 1.0, 0.6],
                            at_points=[[1.0, 2.0, 0.5], [9.0, 4.0, 1.2]]))


def _se2_chain(pkg, **device):
    """A prior and four odometry steps on SE(2), without graphinit, built
    by either package (``pkg`` is ``it`` or ``jl``)."""
    se2 = pkg.SE2()
    pose2 = pkg.VariableType("Pose2", se2)
    fg = pkg.initfg(pkg.SolverParams(graphinit=False), **device)
    fg.add_variable("x0", pose2)
    fg.add_factor(["x0"], pkg.ManifoldPrior(se2, np.zeros(3), pkg.MvNormal(
        [0.0] * 3, [0.1, 0.1, 0.05])))
    for i in range(1, 5):
        fg.add_variable(f"x{i}", pose2)
        fg.add_factor([f"x{i - 1}", f"x{i}"], pkg.ManifoldFactor(
            se2, pkg.MvNormal([2.0, 0.5, 0.3], [0.1, 0.1, 0.05])))
    return fg


def parametric():
    """autoinit_parametric, then the dense LM solve, on an SE(2) chain."""
    fg = _se2_chain(it, device=CPU)
    it.autoinit_parametric(fg)
    seeded = [fg.points(v).clone() for v in fg.ls()]
    it.solve_graph_parametric(fg)
    return (*seeded, *(torch.as_tensor(fg.var(v).parametric_point)
                       for v in fg.ls()),
            *(torch.as_tensor(fg.var(v).parametric_cov) for v in fg.ls()))


def mesh_normal_equations():
    """The factor-split normal equations on a two-device CPU mesh."""
    prob = ParametricProblem(it.generate_line_step(8, graphinit=False,
                                                   device=CPU))
    mesh = Mesh([CPU] * 2)
    for g in prob.groups:
        shard_group_arrays(mesh, g)
    x = torch.linspace(-0.5, 0.5, prob.total_dof)
    return sharded_normal_equations(mesh, prob.residuals, x)


FAMILIES = {
    "two-variable": two_variable,
    "se2-two-pose": se2_two_pose,
    "derelative": derelative,
    "approx-deconv": approx_deconv,
    "factor-jacobian": factor_jacobian_se2,
    "parametric": parametric,
    "mesh": mesh_normal_equations,
}


# ------------------------------------------------------------------ recipes

def _jax_two_variable(n=100):
    fg = jl.initfg(jl.SolverParams(N=n))
    for v in ("x0", "x1"):
        fg.add_variable(v, jl.ContinuousScalar)
    fg.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 1.0)))
    fg.add_factor(["x0", "x1"], jl.LinearRelative(jl.Normal(10.0, 1.0)))
    fg.add_factor(["x1"], jl.Prior(jl.Normal(10.0, 1.0)))
    jl.solve_tree(fg)
    return (torch.as_tensor(np.array(fg.points("x1"))),)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_two_threads_build_and_solve_the_recipe(package):
    """ROADMAP Queue 3's recipe, the build inside the threads: six rounds
    of two threads each building and solving the two-variable graph at
    N=100.  Each thread's x1 is bit-equal to the graph solved alone, and
    its mean is within 1.5 of 10; the JAX package on two threads meets the
    same bar."""
    fn = two_variable if package == "port" else _jax_two_variable
    alone = fn()
    assert abs(float(alone[0].mean()) - 10.0) < 1.5
    for _ in range(6):
        for got in concurrently(fn, fn):
            assert_bit_equal(got, alone)


@pytest.mark.parametrize("family", [k for k in FAMILIES
                                    if k != "two-variable"])
def test_two_threads_give_what_each_gives_alone(family):
    fn = FAMILIES[family]
    alone = fn()
    assert all(torch.isfinite(a).all() for a in alone)
    for got in concurrently(fn, fn):
        assert_bit_equal(got, alone)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_no_path_enters_a_forward_ad_level(monkeypatch, family):
    """With entering a forward-AD level made to raise, every family still
    builds and solves: no port path uses forward AD."""
    def refuse():
        raise AssertionError("a port path entered a forward-AD level")

    monkeypatch.setattr(torch.autograd.forward_ad, "enter_dual_level",
                        refuse)
    with pytest.raises(AssertionError, match="forward-AD level"):
        jacfwd(torch.sin)(torch.ones(2))          # the guard does guard
    out = FAMILIES[family]()
    assert all(torch.isfinite(a).all() for a in out)


def test_the_package_source_names_no_forward_ad():
    """No module of the port calls forward-mode AD: ``jacfwd``,
    ``torch.func.jvp``, ``linearize`` or ``torch.autograd.forward_ad``."""
    import pathlib
    import re

    root = pathlib.Path(it.__file__).parent
    pattern = re.compile(r"\bjacfwd\b|\bjvp\(|\blinearize\b|forward_ad")
    hits = [f"{p.relative_to(root)}:{i}" for p in sorted(root.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits


def test_a_users_jacfwd_on_another_thread_keeps_its_values():
    """A user's ``vmap(jacfwd(f))`` loop on a third thread, beside two
    threads solving SE(2) graphs: every Jacobian it takes is equal to its
    one-thread value, and the solves are bit-equal to alone."""
    def f(x):
        return torch.stack([torch.sin(x[0]) * x[1], x[0] * x[0] - x[1]])

    x = t(rng(3).standard_normal((1000, 2)))
    user_jac = vmap(jacfwd(f))
    want = user_jac(x)
    alone = se2_two_pose()
    solving, lock = [2], threading.Lock()

    def user():
        wrong, calls = 0, 0
        while solving[0] > 0 or calls < 20:
            wrong += not torch.equal(user_jac(x), want)
            calls += 1
        return wrong, calls

    def solve():
        try:
            return se2_two_pose()
        finally:
            with lock:
                solving[0] -= 1

    (wrong, calls), got_a, got_b = concurrently(user, solve, solve)
    assert wrong == 0, f"{wrong} of {calls} user Jacobians changed"
    assert_bit_equal(got_a, alone)
    assert_bit_equal(got_b, alone)


# ------------------------------------------- Jacobian parity with the JAX one

def _site_inputs(M, n=16, seed=31):
    """(x, meas, other) for a relative factor on manifold M: points x and
    other made by exp from the identity, measurements in tangent
    coordinates, as numpy."""
    r = rng(seed)
    ident = np.broadcast_to(np.asarray(M.identity()), (n, M.point_dim))

    def pts():
        return np.asarray(M.exp(jnp.asarray(ident), jnp.asarray(
            (0.7 * r.standard_normal((n, M.dof))).astype(np.float32))))
    return pts(), (0.5 * r.standard_normal((n, M.dof))).astype(
        np.float32), pts()


def close(got, want, slack=0.0):
    """Every entry within SITE_TOL·(1 + |want|) + ``slack``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and not np.isnan(got).any()
    err = np.abs(got - want)
    assert np.all(err <= SITE_TOL * (1.0 + np.abs(want)) + slack), err.max()


def _spy(monkeypatch, module):
    """Record what the site ``module.vmap(module.jacrev(...))`` returns."""
    seen = []
    orig_jacrev, orig_vmap = module.jacrev, module.vmap

    def jacrev(fn, *a, **k):
        g = orig_jacrev(fn, *a, **k)
        g.site = True
        return g

    def vmap(fn, *a, **k):
        g = orig_vmap(fn, *a, **k)
        if not getattr(fn, "site", False):
            return g

        def h(*x, **y):
            out = g(*x, **y)
            seen.append(out)
            return out
        return h
    monkeypatch.setattr(module, "jacrev", jacrev)
    monkeypatch.setattr(module, "vmap", vmap)
    return seen


@pytest.mark.parametrize("name", ["SE2", "SE3", "Sphere2"])
def test_convolution_site_matches_jax_jacfwd(monkeypatch, name):
    """ops/convolve.py's ``vmap(jacrev(res))`` at the zero tangent, in a
    one-step Gauss-Newton through a ManifoldFactor, against the JAX
    package's ``vmap(jacfwd)`` of residual(meas, other, exp(x, X)).  Where
    a row's relative rotation is small, float32 loses digits in the
    small-angle forms ((1 - cos φ)/φ) in either package: there the port may
    differ from JAX's float32 Jacobian by as much as that one differs from
    the JAX package's own float64 Jacobian (``jax.enable_x64``), the slack
    of ``close``.  The slack is the JAX package's alone, so it cannot hide
    an error of the port's: all rows but at most one take no slack beyond
    SITE_TOL, and scaling any such row of the port's Jacobian by 1 + 1e-3
    fails the check."""
    jman = getattr(jl.manifolds, name)()
    tman = getattr(it.manifolds, name)()
    x, meas, other = _site_inputs(jman)
    jmodel = jl.ManifoldFactor(jman, jl.MvNormal([0.0] * jman.dof,
                                                 [1.0] * jman.dof))
    tmodel = it.ManifoldFactor(tman, it.MvNormal([0.0] * tman.dof,
                                                 [1.0] * tman.dof))
    seen = _spy(monkeypatch, convolve)
    convolve.batched_gauss_newton(tman, tmodel, t(meas), (t(other),), t(x),
                                  1, linear=True)
    assert len(seen) == 1

    def jres(X, x, z, o):
        return jmodel.residual(z, o, jman.exp(x, X))

    args = (np.zeros((x.shape[0], jman.dof), np.float32), x, meas, other)
    want = np.asarray(jax.vmap(jax.jacfwd(jres))(*map(jnp.asarray, args)))
    with jax.enable_x64(True):
        want64 = np.asarray(jax.vmap(jax.jacfwd(jres))(
            *(jnp.asarray(a, jnp.float64) for a in args)))
    assert want64.dtype == np.float64
    slack = np.abs(want - want64)
    got = seen[0].numpy()
    close(got, want, slack)
    tight = np.all(slack <= SITE_TOL * (1.0 + np.abs(want)), axis=(1, 2))
    assert tight.sum() >= len(tight) - 1, np.flatnonzero(~tight)
    for i in np.flatnonzero(tight):
        bad = got.copy()
        bad[i] *= 1.0 + 1e-3
        with pytest.raises(AssertionError):
            close(bad, want, slack)


def test_deconvolution_site_matches_jax_jacfwd(monkeypatch):
    """ops/deconv.py's ``vmap(jacrev(model.residual))`` over the
    measurement, on SE(2)."""
    jm, tm = jl.SE2(), it.SE2()
    x, meas, other = _site_inputs(jm, seed=32)
    jmodel = jl.ManifoldFactor(jm, jl.MvNormal([0.0] * 3, [1.0] * 3))
    tmodel = it.ManifoldFactor(tm, it.MvNormal([0.0] * 3, [1.0] * 3))
    seen = _spy(monkeypatch, deconv)
    deconv._solve_measurement(tmodel, t(meas), (t(other), t(x)), iters=1)
    want = jax.vmap(jax.jacfwd(jmodel.residual))(
        jnp.asarray(meas), jnp.asarray(other), jnp.asarray(x))
    assert len(seen) == 1
    close(seen[0].numpy(), want)


def test_factor_jacobian_site_matches_jax_jacfwd():
    """ops/gradients.py's blocks against jacfwd of the JAX package's
    residual in tangent coordinates, at given points and measurement."""
    jm = jl.SE2()
    fg, label = _se2_graph()
    at = [np.array([1.0, 2.0, 0.5], np.float32),
          np.array([9.0, 4.0, 1.2], np.float32)]
    meas = np.array([8.0, 1.0, 0.6], np.float32)
    jmodel = jl.ManifoldFactor(jm, jl.MvNormal([0.0] * 3, [1.0] * 3))

    def res(X0, X1):
        return jmodel.residual(jnp.asarray(meas),
                               jm.exp(jnp.asarray(at[0]), X0),
                               jm.exp(jnp.asarray(at[1]), X1))
    z = jnp.zeros((3,))
    want = np.concatenate([np.asarray(jax.jacfwd(res, argnums=i)(z, z))
                           for i in (0, 1)], axis=-1)
    close(factor_jacobian(fg, label, meas=meas, at_points=at).numpy(), want)


@pytest.mark.parametrize("site", ["parametric", "mesh"])
def test_parametric_and_mesh_sites_match_jax_jacfwd(site):
    """parametric/solver.py's group Jacobians (placed into the problem's
    J by ``res_jac``) and parallel/mesh.py's normal equations, on an SE(2)
    chain at a tangent point away from the origin, against ``jacfwd`` of
    the JAX package's own problem's residuals (its padded columns
    dropped)."""
    from incrementalinference.jl_tpu.parametric.solver import \
        ParametricProblem as JaxProblem

    pj = JaxProblem(_se2_chain(jl))
    pt = ParametricProblem(_se2_chain(it, device=CPU))
    assert pj.var_labels == pt.var_labels
    lay = [(int(pj.offsets[pj.slot[v]]), int(pt.offsets[pt.slot[v]]),
            pj.dofs[pj.slot[v]]) for v in pj.var_labels]
    x = (0.2 * rng(33).standard_normal(pt.total_dof)).astype(np.float32)
    xj = np.zeros(pj.total_dof, np.float32)
    for oj, ot, d in lay:
        xj[oj:oj + d] = x[ot:ot + d]
    Jj = np.asarray(jax.jacfwd(pj.residuals)(jnp.asarray(xj)))
    Jj = np.concatenate([Jj[:, oj:oj + d] for oj, _, d in lay], axis=1)
    rj = np.asarray(pj.residuals(jnp.asarray(xj)))
    real = np.any(Jj != 0.0, axis=1)            # JAX's padded rows are 0
    Jj, rj = Jj[real], rj[real]
    if site == "parametric":
        r, J = pt.res_jac(t(x))
        close(r.numpy(), rj)
        close(J.numpy(), Jj)
    else:
        # J within SITE_TOL·(1 + |J|) entry by entry (the parametric case)
        # carries into the sums of products JᵀJ and Jᵀr as the bounds
        # 2·SITE_TOL·(1 + |J|)ᵀ|J| and SITE_TOL·(1 + |J|)ᵀ|r|
        H, g = sharded_normal_equations(Mesh([CPU]), pt.residuals, t(x))
        aJ = np.abs(Jj)
        close(H.numpy(), Jj.T @ Jj, 2 * SITE_TOL * ((1.0 + aJ).T @ aJ))
        close(g.numpy(), Jj.T @ rj, SITE_TOL * ((1.0 + aJ).T @ np.abs(rj)))


# ------------------------------------------------------- shared counters

@pytest.mark.parametrize("counter", ["libcache-listener", "kernel-wrapper"])
def test_counters_lose_nothing_across_threads(monkeypatch, counter):
    """Eight threads count 1,000 events each at once: the load listener
    of libcache.py and the row-logsumexp wrapper's call count both reach
    8,000 (``+=`` on a dict entry is a read and a write; each counter
    takes its lock).  A short switch interval makes a lost count likely
    where a lock is missing."""
    import sys

    from incrementalinference_torch import libcache
    from incrementalinference_torch.ops.kernels import row_lse

    if counter == "libcache-listener":
        monkeypatch.setattr(libcache, "_listeners", [])
        counts, key = {"hits": 0, "misses": 0}, "hits"
        libcache.add_listener(counts)

        def count():
            for _ in range(1000):
                libcache._count("hits")
    else:
        counts, key = {"launches": 0, "problems": 0, "calls": 0}, "calls"
        monkeypatch.setattr(row_lse, "counts", counts)
        a2, iva, mu = torch.zeros(2), torch.ones((2, 1)), torch.zeros((3, 1))

        def count():
            for _ in range(1000):
                row_lse.row_logsumexp(a2, iva, iva, mu)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        concurrently(*[count] * 8)
    finally:
        sys.setswitchinterval(interval)
    assert counts[key] == 8000

"""The six scripts of examples_torch/ against the JAX package's examples/.

Structure: each JAX example's graph, built here with that example's own
lines through the JAX package, holds the same variables, factors, types
and parameters as the port example's ``build``.  Deterministic parts are
held numerically against the JAX functions; the stochastic solves run
through each example's ``main(device="cpu")`` at a reduced particle count,
where the example asserts the bars of the JAX tests it names.
"""

import functools
import importlib.util
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_graph_to_arrays

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "dfg_archive")
EXAMPLES = ("fourdoor", "range_only", "migrate_from_reference", "se2_slam",
            "ode_smoothing", "multihost")
_STATE = ("points", "bw", "ipc", "parametric_point", "parametric_cov")


def example(name):
    """examples_torch/<name>.py, imported as a module."""
    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def no_graphinit(monkeypatch, mod):
    """The example's graphs built without graphinit: the structure is the
    same, and no proposal is drawn."""
    monkeypatch.setattr(mod, "SolverParams",
                        functools.partial(it.SolverParams, graphinit=False))


def jax_params():
    return jl.SolverParams(N=100, graphinit=False)


def assert_same(a, b, where="", rtol=0.0):
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}", rtol)
    elif isinstance(a, (list, tuple)) and a and not isinstance(a[0], str):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{where}[{i}]", rtol)
    elif a is None or isinstance(a, (str, bool, list, tuple)):
        assert list(a) == list(b) if isinstance(a, (list, tuple)) \
            else a == b, (where, a, b)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=rtol,
                                   atol=0.0, err_msg=where)


def assert_same_structure(fj, ft, rtol=0.0):
    """Same variables, factors, types and parameters; solver state apart."""
    def strip(spec):
        return {"N": spec["params"]["N"],
                "variables": [{k: v for k, v in d.items() if k not in _STATE}
                              for d in spec["variables"]],
                "factors": spec["factors"]}

    assert ft.ls() == fj.ls() and ft.lsf() == fj.lsf()
    assert_same(strip(jax_graph_to_arrays(fj)),
                strip(it.graph_to_arrays(ft)), rtol=rtol)


# --------------------------------------------------------------- fourdoor

def jax_fourdoor():
    """examples/fourdoor.py's graph after its three sightings."""
    fg = jl.initfg(jax_params())
    door = jl.Mixture(jl.Prior, [jl.Normal(-100, 3), jl.Normal(0, 3),
                                 jl.Normal(100, 3), jl.Normal(300, 3)],
                      [0.25] * 4)
    fg.add_variable("x1", jl.ContinuousScalar)
    fg.add_factor(["x1"], door)
    fg.add_variable("x2", jl.ContinuousScalar)
    fg.add_factor(["x1", "x2"], jl.LinearRelative(jl.Normal(50.0, 2.0)))
    fg.add_variable("x3", jl.ContinuousScalar)
    fg.add_factor(["x2", "x3"], jl.LinearRelative(jl.Normal(50.0, 4.0)))
    fg.add_factor(["x3"], door)
    fg.add_variable("x4", jl.ContinuousScalar)
    fg.add_factor(["x3", "x4"], jl.LinearRelative(jl.Normal(200.0, 4.0)))
    fg.add_factor(["x4"], door)
    return fg


def test_fourdoor_builds_the_jax_examples_graph(monkeypatch):
    ex = example("fourdoor")
    no_graphinit(monkeypatch, ex)
    assert_same_structure(jax_fourdoor(), ex.build(device="cpu"))


def test_fourdoor_solves_at_the_bars_of_test_solve():
    fg, tree = example("fourdoor").main(device="cpu", n=64)
    assert fg.var("x1").N == 64
    assert sum(c.is_recycled for c in tree.cliques.values()) > 0


# ------------------------------------------------------------- range only

def jax_range_only():
    fg = jl.initfg(jax_params())
    fg.add_variable("x1", jl.ContinuousEuclid(2))
    fg.add_factor(["x1"], jl.Prior(jl.MvNormal([100.0, 0.0], [1.0, 1.0])))
    fg.add_variable("x2", jl.ContinuousEuclid(2))
    fg.add_factor(["x2"], jl.Prior(jl.MvNormal([0.0, 100.0], [1.0, 1.0])))
    fg.add_variable("l1", jl.ContinuousEuclid(2))
    fg.add_factor(["x1", "l1"], jl.EuclidDistance(jl.Normal(100.0, 1.0)))
    fg.add_factor(["x2", "l1"], jl.EuclidDistance(jl.Normal(100.0, 1.0)))
    fg.add_variable("x3", jl.ContinuousEuclid(2))
    fg.add_factor(["x3"], jl.Prior(jl.MvNormal([100.0, 100.0], [1.0, 1.0])))
    fg.add_factor(["x3", "l1"], jl.EuclidDistance(jl.Normal(141.42, 1.0)))
    return fg


def test_range_only_builds_the_jax_examples_graph(monkeypatch):
    ex = example("range_only")
    no_graphinit(monkeypatch, ex)
    assert_same_structure(jax_range_only(), ex.build(device="cpu"))


def test_range_only_solves_at_the_bars_of_test_solve():
    _, out = example("range_only").main(device="cpu", n=64)
    assert out["three"]["(0,0)"] > 0.8


# ------------------------------------------------------------- migration

def test_migrate_loads_the_archive_exactly_as_jax():
    """Variables, factors and the stored points of the golden archive,
    loaded by the port example and by the JAX package: equal exactly."""
    from incrementalinference.jl_tpu.serialization import load_dfg_archive

    fj = load_dfg_archive(FIXTURE)
    ft = example("migrate_from_reference").build(device="cpu")
    assert ft.ls() == fj.ls() and ft.lsf() == fj.lsf()
    assert_same(jax_graph_to_arrays(fj), it.graph_to_arrays(ft))
    assert [v for v in ft.ls() if ft.var(v).is_initialized()] == ["x1"]


def test_migrate_solves_saves_and_loads_back():
    fg, fg2 = example("migrate_from_reference").main(device="cpu")
    assert sorted(fg2.ls()) == ["l1", "theta", "x0", "x1", "x2"]
    assert len(fg2.lsf()) == 7


# ---------------------------------------------------------------- SE(2)

def jax_se2_slam():
    from incrementalinference.jl_tpu.canonical import _Pose2Point2Bearingless
    from incrementalinference.jl_tpu.manifolds import SE2

    se2 = SE2()
    pose2 = jl.VariableType("Pose2", se2)
    fg = jl.initfg(jax_params())
    fg.add_variable("x0", pose2)
    fg.add_factor(["x0"], jl.ManifoldPrior(
        se2, jnp.zeros(3), jl.MvNormal([0.0] * 3, [0.05, 0.05, 0.02])))
    odo = jl.MvNormal([2.0, 0.0, 0.6], [0.05, 0.05, 0.02])
    for i in range(1, 5):
        fg.add_variable(f"x{i}", pose2)
        fg.add_factor([f"x{i-1}", f"x{i}"], jl.ManifoldFactor(se2, odo))
        if i == 2:
            fg.add_variable("l1", jl.ContinuousEuclid(2))
            fg.add_factor(["x2", "l1"], _Pose2Point2Bearingless(
                jl.MvNormal([3.0, 0.0], [0.1, 0.1])))
    return fg


def test_se2_slam_builds_the_jax_examples_graph_and_its_optimum(
        monkeypatch, tmp_path):
    """The structure, and solve_graph_parametric on the JAX example's graph
    saved by the JAX package and loaded by the port (the example's own
    save/load path): the points agree with the JAX solve's to 1e-3."""
    from incrementalinference.jl_tpu.parametric import (
        solve_graph_parametric as jax_parametric)

    ex = example("se2_slam")
    no_graphinit(monkeypatch, ex)
    fj = jax_se2_slam()
    assert_same_structure(fj, ex.build(device="cpu"))
    path = jl.save_graph(fj, str(tmp_path / "se2_slam.json"))
    ft = it.load_graph(path, device="cpu")
    assert_same_structure(fj, ft)
    jax_parametric(fj)
    ex.solve_graph_parametric(ft)
    for v in fj.ls():
        np.testing.assert_allclose(
            ft.var(v).parametric_point.numpy(),
            np.asarray(fj.var(v).parametric_point), atol=1e-3, err_msg=v)
    x4 = ex.truth(ft.var("x0").manifold, 4, "cpu")
    np.testing.assert_allclose(ft.var("x4").parametric_point.numpy(),
                               x4.numpy(), atol=1e-3)


def test_se2_slam_recycles_and_solves_at_the_bars():
    fg, fg2, tree = example("se2_slam").main(device="cpu", n=48)
    assert sum(c.is_recycled for c in tree.cliques.values()) > 0
    assert fg2.ls() == fg.ls()


# ------------------------------------------------------------------ ODE

def jax_ode_setup():
    from incrementalinference.jl_tpu.distributions import MvNormal
    from incrementalinference.jl_tpu.models import DERelative

    tgrid = jnp.linspace(0.0, 6.0, 25)
    data = jnp.stack([tgrid, jnp.sin(tgrid)])

    def f(t, x, u):
        return -0.5 * x + jnp.interp(t, u[0], u[1])

    truth = {0: 2.0}
    for k in range(3):
        seg = DERelative(f, 2.0 * k, 2.0 * (k + 1), dim=1, data=data,
                         steps=32)
        truth[k + 1] = float(seg.flow(jnp.asarray([truth[k]]))[0])
    fg = jl.initfg(jax_params())
    for k in range(4):
        fg.add_variable(f"x{k}", jl.ContinuousScalar)
    fg.add_factor(["x0"], jl.Prior(jl.Normal(2.0, 0.05)))
    fg.add_factor(["x3"], jl.Prior(jl.Normal(truth[3] + 0.1, 0.2)))
    for k in range(3):
        fg.add_factor([f"x{k}", f"x{k+1}"],
                      DERelative(f, 2.0 * k, 2.0 * (k + 1),
                                 Z=MvNormal([0.0], [0.01]), dim=1,
                                 data=data, steps=32))

    def g(t, x, k):
        return -k[0] * x

    de = DERelative(g, 0.0, 2.0, MvNormal([0.0], [1e-4]), dim=1, steps=32)
    fk = jl.initfg(jax_params())
    for v in ("a", "b", "k"):
        fk.add_variable(v, jl.ContinuousScalar)
    fk.add_factor(["a"], jl.Prior(jl.Normal(2.0, 0.02)))
    fk.add_factor(["b"], jl.Prior(jl.Normal(2.0 * float(np.exp(-1.4)),
                                            0.02)))
    fk.add_factor(["k"], jl.Prior(jl.Normal(0.5, 0.5)))
    fk.add_factor(["a", "b", "k"], de)
    return truth, fg, fk


def test_ode_truth_flows_and_graphs_match_jax(monkeypatch):
    """The integrated truth of the forced flow to rtol 1e-5 (jnp.interp
    against the example's floor-index lerp, RK4 in both), the two graphs'
    structure (the control grid to float32 rounding: linspace and sin are
    two libraries' own), and the two flows on the same inputs."""
    ex = example("ode_smoothing")
    no_graphinit(monkeypatch, ex)
    truth, fj, fkj = jax_ode_setup()
    got = ex.truth_states("cpu")
    np.testing.assert_allclose(got, [truth[k] for k in range(4)], rtol=1e-5)
    ft = ex.build_forced(got, "cpu")
    assert_same_structure(fj, ft, rtol=1e-6)
    fkt = ex.build_decay("cpu")
    assert_same_structure(fkj, fkt)
    x = np.linspace(-1.0, 3.0, 9).astype(np.float32)
    for fl in fj.lsf():
        mj, mt = fj.factor(fl).model, ft.factor(fl).model
        if type(mj).__name__ != "DERelative":
            continue
        want = np.asarray([mj.flow(jnp.asarray([v]))[0] for v in x])
        have = np.asarray([float(mt.flow(torch.tensor([v]))[0]) for v in x])
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6)
    mj = fkj.factor(fkj.lsf()[-1]).model
    mt = fkt.factor(fkt.lsf()[-1]).model
    for k in (0.3, 0.7, 1.1):
        want = float(mj.flow(jnp.asarray([2.0]), jnp.asarray([k]))[0])
        have = float(mt.flow(torch.tensor([2.0]), torch.tensor([k]))[0])
        assert abs(have - want) <= 1e-5 * abs(want), (k, have, want)
        assert abs(have - 2.0 * math.exp(-2.0 * k)) < 1e-4


def test_ode_smoothing_solves_at_the_bars(monkeypatch):
    """main() at N = 32 with every DERelative of the example (the truth's
    too) at 8 RK4 steps, which integrate the flows over 2 s to within 1e-4
    of 32 steps: a DERelative proposal's host time grows with the steps."""
    ex = example("ode_smoothing")

    def de(*a, steps=32, **k):
        return it.DERelative(*a, steps=8, **k)

    monkeypatch.setattr(ex, "DERelative", de)
    fg, fk, truth = ex.main(device="cpu", n=32, nary_steps=8)
    assert len(truth) == 4 and fg.var("x0").N == 32
    assert fk.factor(fk.lsf()[-1]).model.steps == 8


# ------------------------------------------------------------ multihost

def test_multihost_two_gloo_processes_on_the_cpu():
    reps, reps_p = example("multihost").main(device="cpu", scale=4,
                                             timeout=300.0)
    assert sorted(r["pid"] for r in reps) == [0, 1]
    for r in reps:
        assert r["incr"]["n_recycled"] > 0
        assert r["warm"]["means"] == reps[0]["warm"]["means"]
    assert abs(reps_p[0]["warm"]["max_err"]
               - reps_p[1]["warm"]["max_err"]) < 1e-6


# ------------------------------------------------------- every example

@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_raise_without_cuda_by_default(monkeypatch, name):
    """CUDA is the default device; without it an example raises and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = example(name)
    with pytest.raises(RuntimeError, match="CUDA|multihost launch failed"):
        if name == "multihost":
            ex.main(scale=2, timeout=120.0)
        else:
            ex.main()


def test_fourdoor_runs_as_a_script_without_jax():
    """`python examples_torch/fourdoor.py --device cpu --n 64` in a fresh
    process: exit 0, its printout, and no module of JAX or the JAX
    package imported (-X importtime lists every import)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-X", "importtime",
         os.path.join("examples_torch", "fourdoor.py"), "--device", "cpu",
         "--n", "64"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "after 2 sightings, x1 modes:" in out.stdout
    assert "x4: mean=" in out.stdout
    mods = [ln.rsplit("|", 1)[-1].strip() for ln in out.stderr.splitlines()
            if ln.startswith("import time:")]
    assert "incrementalinference_torch" in mods
    assert not [m for m in mods if m.split(".")[0]
                in ("jax", "jaxlib", "incrementalinference")]

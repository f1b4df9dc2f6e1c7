"""Distribution over a device mesh in the port (parallel/mesh.py, the
``mesh=``/``distribute=`` paths of solve_tree and the parametric solves,
graft_entry.py): the tests of tests/test_multichip.py and
tests/test_multichip_policy.py on ``Mesh([torch.device("cpu")] * 8)``, the
port's stand-in for the JAX package's eight virtual host devices, at their
bars.  Every test stands alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import torch_port_helpers  # noqa: F401  (two torch threads a worker)

import incrementalinference_torch as it
import incrementalinference_torch.parallel.scheduler as sched
from incrementalinference_torch.parallel.mesh import (
    Mesh, make_mesh, replicate, shard_group_arrays, shard_particles,
    sharded_normal_equations)
from incrementalinference_torch.parametric.solver import ParametricProblem

CPU = torch.device("cpu")


def _mesh(n=8):
    return Mesh([CPU] * n)


def test_eight_shard_mesh():
    """tests/test_multichip.py:13: the mesh has eight devices.  make_mesh
    takes CUDA devices only and raises where there are none."""
    mesh = _mesh()
    assert len(mesh) == 8 == mesh.size and mesh.axis_names == ("shard",)
    chunks = shard_particles(mesh, torch.arange(20.0)[:, None])
    assert len(chunks) == 8 and all(c.shape == (3, 1) for c in chunks)
    assert float(chunks[-1][-1, 0]) == 19.0          # padded with the last
    assert all(torch.equal(c, torch.ones(2)) for c in
               replicate(mesh, torch.ones(2)))


def test_make_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)


def test_graft_entry_runs():
    """tests/test_multichip.py:17 on the port's entry()."""
    from incrementalinference_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    mu, prec = fn(*args)
    assert mu.shape == (128, 2) and prec.shape == (128, 2)
    assert bool(torch.isfinite(mu).all())


def test_dryrun_multichip():
    """tests/test_multichip.py:24 on the port's dryrun_multichip(8)."""
    from incrementalinference_torch.graft_entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")


def test_sharded_parametric_matches_single_device():
    """tests/test_multichip.py:29: the factor-split normal equations equal
    the single-device ones, and the JAX package's factor-sharded ones on
    the same graph (its eight virtual devices), to 1e-5."""
    from incrementalinference.jl_tpu.canonical import generate_line_step
    from incrementalinference.jl_tpu.parallel import mesh as jm
    from incrementalinference.jl_tpu.parametric.solver import (
        ParametricProblem as JaxProblem)

    prob = ParametricProblem(it.generate_line_step(8, graphinit=False,
                                                   device="cpu"))
    x = torch.zeros((prob.total_dof,))
    J = jacfwd(prob.residuals)(x)
    H_ref, g_ref = J.T @ J, J.T @ prob.residuals(x)

    prob2 = ParametricProblem(it.generate_line_step(8, graphinit=False,
                                                    device="cpu"))
    mesh = _mesh()
    for g in prob2.groups:
        shard_group_arrays(mesh, g)
        assert g.meas.shape[0] % 8 == 0
    H, gv = sharded_normal_equations(mesh, prob2.residuals, x)
    np.testing.assert_allclose(H.numpy(), H_ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), g_ref.numpy(), rtol=1e-5,
                               atol=1e-5)

    pj = JaxProblem(generate_line_step(8, graphinit=False))
    assert list(pj.var_labels) == list(prob.var_labels)
    jmesh = jm.make_mesh(8)
    for g in pj.groups:
        jm.shard_group_arrays(jmesh, g)
    Hj, gj = jm.sharded_normal_equations(jmesh, pj.residuals,
                                         jnp.zeros((pj.total_dof,)))
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)


def test_particle_split_solve_equals_unsplit():
    """The particle axis splits the per-particle solves and nothing else:
    the same graph and keys give the same particles split over eight
    shards as on one device."""
    def solved(mesh):
        fg = it.generate_line_step(6, graphinit=True, device="cpu",
                                   params=it.SolverParams(N=64))
        it.solve_tree(fg, mesh=mesh)
        return {v: fg.points(v) for v in fg.ls()}

    one, eight = solved(None), solved(_mesh())
    for v in one:
        np.testing.assert_allclose(eight[v].numpy(), one[v].numpy(),
                                   rtol=1e-5, atol=1e-5)


def _doors(N, params=None):
    fg = it.initfg(params or it.SolverParams(N=N), device="cpu")
    door = it.Mixture(it.Prior, [it.Normal(-100, 3), it.Normal(0, 3),
                                 it.Normal(100, 3), it.Normal(300, 3)])
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x1"], door)
    fg.add_variable("x2", it.ContinuousScalar)
    fg.add_factor(["x1", "x2"], it.LinearRelative(it.Normal(50.0, 2.0)))
    fg.add_variable("x3", it.ContinuousScalar)
    fg.add_factor(["x2", "x3"], it.LinearRelative(it.Normal(50.0, 4.0)))
    fg.add_factor(["x3"], door)
    return fg


def test_sharded_tree_solve_end_to_end():
    """tests/test_multichip.py:56: the particle-split solve keeps the
    mode bars."""
    fg = _doors(128)
    it.solve_tree(fg, mesh=_mesh())
    p1 = fg.points("x1")[:, 0].numpy()
    m = np.mean(np.abs(p1 + 100) < 20) + np.mean(np.abs(p1 - 0) < 20)
    assert m > 0.7, m
    p3 = fg.points("x3")[:, 0].numpy()
    m3 = np.mean(np.abs(p3 - 0) < 20) + np.mean(np.abs(p3 - 100) < 20)
    assert m3 > 0.7, m3


def test_particles_need_n_divisible_by_the_mesh():
    """As in the JAX package: under "particles" each N must divide the
    mesh size."""
    fg = it.generate_line_step(4, graphinit=True, device="cpu",
                               params=it.SolverParams(N=50))
    with pytest.raises(ValueError, match="must divide the mesh size"):
        it.solve_tree(fg, mesh=_mesh())


def _branches(params, n, graphinit=True):
    fg = it.initfg(params, device="cpu")
    for b in range(n):
        fg.add_variable(f"b{b}x0", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0"], it.Prior(it.Normal(float(b), 0.5)),
                      graphinit=graphinit)
        fg.add_variable(f"b{b}x1", it.ContinuousScalar)
        fg.add_factor([f"b{b}x0", f"b{b}x1"],
                      it.LinearRelative(it.Normal(1.0, 0.5)),
                      graphinit=graphinit)
    return fg


def _count_calls(monkeypatch, name):
    calls = {"n": 0}
    orig = getattr(sched, name)

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sched, name, counting)
    return calls


def test_sharded_solve_wide_graph(monkeypatch):
    """tests/test_multichip.py:87: under "particles" a wide graph gives up
    its level batches (batch_cliques is switched off) and keeps its bars."""
    calls = _count_calls(monkeypatch, "up_solve_level")
    fg = _branches(it.SolverParams(N=128, batch_cliques="auto",
                                   batch_min_width=2), 6)
    it.solve_tree(fg, mesh=_mesh())
    assert calls["n"] == 0 and fg.params.batch_cliques is False
    for b in range(6):
        m = float(fg.points(f"b{b}x1").mean())
        assert abs(m - (b + 1)) < 1.5, (b, m)


def test_mesh_sharded_parametric_tree_solve():
    """tests/test_multichip.py:109: the parametric tree solve with each
    level's batch split over the mesh gives the exact answer."""
    fg = _branches(it.SolverParams(), 16, graphinit=False)
    tree = it.solve_tree(fg, algorithm="parametric", mesh=_mesh())
    assert max(tree.param_batches) == 16
    for b in range(16):
        e1 = float(fg.var(f"b{b}x1").parametric_point[0])
        assert abs(e1 - (b + 1)) < 1e-3, (b, e1)
        cov = float(fg.var(f"b{b}x1").parametric_cov[0, 0])
        assert np.isfinite(cov) and cov > 0


def test_clique_sharded_incremental_recycling():
    """tests/test_multichip.py:136: recycling under distribute="cliques"."""
    mesh = _mesh()
    fg = it.initfg(it.SolverParams(batch_cliques=True, batch_min_width=2,
                                   N=64), device="cpu")
    fg.add_variable("r0", it.ContinuousScalar)
    fg.add_factor(["r0"], it.Prior(it.Normal(0.0, 0.5)))
    for i in range(1, 5):
        fg.add_variable(f"r{i}", it.ContinuousScalar)
        fg.add_factor([f"r{i-1}", f"r{i}"],
                      it.LinearRelative(it.Normal(1.0, 0.5)))
    tree = it.solve_tree(fg, mesh=mesh, distribute="cliques", order=fg.ls())
    for i in range(5, 7):
        fg.add_variable(f"r{i}", it.ContinuousScalar)
        fg.add_factor([f"r{i-1}", f"r{i}"],
                      it.LinearRelative(it.Normal(1.0, 0.5)))
    tree2 = it.solve_tree(fg, old_tree=tree, mesh=mesh,
                          distribute="cliques", order=fg.ls())
    assert sum(c.is_recycled for c in tree2.cliques.values()) >= 2
    # the JAX test's bar: chain-end sigma 0.5*sqrt(7), N=64, 4 s.e.
    for i in range(7):
        m = float(fg.points(f"r{i}")[:, 0].mean())
        assert abs(m - i) < 0.66, (i, m)


def test_clique_sharded_multihypo():
    """tests/test_multichip.py:175: multihypo under distribute="cliques"."""
    fg = it.initfg(it.SolverParams(batch_cliques=True, batch_min_width=2,
                                   N=64), device="cpu")
    for d, pos in (("d0", 0.0), ("d1", 8.0)):
        fg.add_variable(d, it.ContinuousScalar)
        fg.add_factor([d], it.Prior(it.Normal(pos, 0.3)))
    fg.add_variable("mx", it.ContinuousScalar)
    fg.add_factor(["mx", "d0", "d1"], it.LinearRelative(it.Normal(0.0, 0.3)),
                  multihypo=[1.0, 0.5, 0.5])
    fg.add_factor(["mx"], it.Prior(it.Normal(0.0, 1.0)))
    it.solve_tree(fg, mesh=_mesh(), distribute="cliques")
    pm = fg.points("mx")[:, 0].numpy()
    assert float(np.mean(np.abs(pm - 0.0) < 2.0)) > 0.6, pm.mean()


def test_clique_sharded_batched_level_solve(monkeypatch):
    """tests/test_multichip.py:200: 12 branches batched, padded to 16 and
    split over the eight shards, two members each."""
    sizes = []
    orig = sched._run_members

    def recording(fn, models, nested, old, keys, mesh, home):
        sizes.append((len(keys), None if mesh is None else len(mesh)))
        return orig(fn, models, nested, old, keys, mesh, home)

    monkeypatch.setattr(sched, "_run_members", recording)
    fg = _branches(it.SolverParams(batch_cliques=True, batch_min_width=4),
                   12)
    it.solve_tree(fg, mesh=_mesh(), distribute="cliques")
    assert sizes and all(s == (16, 8) for s in sizes), sizes
    for b in range(12):
        m = float(fg.points(f"b{b}x1")[:, 0].mean())
        assert abs(m - (b + 1.0)) < 1.0, (b, m)


def test_cliques_without_batching_round_robin(monkeypatch):
    """distribute="cliques" with batch_cliques off places each level's
    cliques on the mesh's devices in turn."""
    placed = []
    orig = sched.up_solve_clique

    def recording(*a, **k):
        placed.append(k.get("device"))
        return orig(*a, **k)

    monkeypatch.setattr(sched, "up_solve_clique", recording)
    fg = _branches(it.SolverParams(batch_cliques=False), 4)
    it.solve_tree(fg, mesh=_mesh(), distribute="cliques")
    assert placed and all(d == CPU for d in placed)
    for b in range(4):
        assert abs(float(fg.points(f"b{b}x1").mean()) - (b + 1)) < 1.0


def test_particle_sharded_narrow_chain_parity():
    """tests/test_multichip_policy.py:13: distribute="auto" on a narrow
    chain splits each clique's particles and matches the unsplit
    statistics."""
    def build():
        fg = it.initfg(it.SolverParams(N=64), device="cpu")
        prev = None
        for i in range(10):
            v = f"x{i}"
            fg.add_variable(v, it.ContinuousScalar)
            if prev is None:
                fg.add_factor([v], it.Prior(it.Normal(0.0, 0.5)))
            else:
                fg.add_factor([prev, v],
                              it.LinearRelative(it.Normal(3.0, 0.5)))
            prev = v
        return fg

    fg_ref = build()
    it.solve_tree(fg_ref)
    fg_sh = build()
    assert it.solve_tree(fg_sh, mesh=_mesh(), distribute="auto") is not None
    for i in range(10):
        a = float(fg_ref.points(f"x{i}")[:, 0].mean())
        b = float(fg_sh.points(f"x{i}")[:, 0].mean())
        assert abs(a - 3.0 * i) < 1.0, (i, a)
        assert abs(b - 3.0 * i) < 1.0, (i, b)
        assert abs(a - b) < 1.0, (i, a, b)


def test_auto_distribute_mixed_width_graph():
    """tests/test_multichip_policy.py:52: a wide level batched and split
    by cliques, the narrow chain split by particles."""
    fg = it.initfg(it.SolverParams(N=32, batch_cliques="auto",
                                   batch_min_width=4), device="cpu")
    fg.add_variable("r0", it.ContinuousScalar)
    fg.add_factor(["r0"], it.Prior(it.Normal(0.0, 0.5)))
    fg.add_variable("r1", it.ContinuousScalar)
    fg.add_factor(["r0", "r1"], it.LinearRelative(it.Normal(1.0, 0.5)))
    for b in range(8):
        v = f"b{b}"
        fg.add_variable(v, it.ContinuousScalar)
        fg.add_factor(["r1", v], it.LinearRelative(it.Normal(float(b), 0.5)))
    assert it.solve_tree(fg, mesh=_mesh(), distribute="auto") is not None
    for b in range(8):
        m = float(fg.points(f"b{b}")[:, 0].mean())
        assert abs(m - (1.0 + b)) < 1.0, (b, m)


def test_unknown_distribute_raises():
    fg = it.generate_kaess(graphinit=True, device="cpu")
    with pytest.raises(ValueError, match="unknown distribute"):
        it.solve_tree(fg, mesh=_mesh(), distribute="devices")

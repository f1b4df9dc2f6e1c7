"""The batched same-level clique solve and chain segments in the port
(parallel/scheduler.py up_solve_level, up_solve_segment; ops/fused.py
_make_update_batched, fused_up_segment; the row-logsumexp's member axis),
held against the JAX package and against the per-member path.

Every test stands alone: under pytest-xdist's ``--dist load`` one file's
tests run on several workers."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_native_ordering, rng, t  # noqa: F401

import incrementalinference_torch as it
import incrementalinference_torch.parallel.scheduler as sched
from incrementalinference.jl_tpu.ops.kernels import pallas_product as jk
from incrementalinference_torch import keys
from incrementalinference_torch.ops import fused, product as tp
from incrementalinference_torch.ops.graphops import prepare_update
from incrementalinference_torch.ops.kernels import row_lse as K

CPU = "cpu"


def _members(B, na, nb, dof, seed):
    r = rng(seed)
    muA = r.normal(size=(B, na, dof)).astype(np.float32)
    muB = (r.normal(size=(B, nb, dof)) + 0.5).astype(np.float32)
    precA = (np.abs(r.normal(size=(B, na, dof))) + 0.5).astype(np.float32)
    precB = np.broadcast_to(
        np.abs(r.normal(size=(B, 1, dof))).astype(np.float32) + 0.5,
        (B, nb, dof)).copy()
    return muA, precA, muB, precB


@pytest.mark.parametrize("dof", [1, 3, 6])
def test_batched_plain_row_lse_matches_jax_vmap(dof):
    """(a) The member axis of the plain row-logsumexp against the JAX
    package's Pallas kernel (interpret mode) under jax.vmap, which is what
    a batched level runs there."""
    muA, precA, muB, precB = _members(3, 300, 500, dof, seed=dof)
    got = K.pair_row_logsumexp(t(muA), t(precA), t(muB), t(precB)).numpy()
    assert got.shape == (3, 300)
    want = np.asarray(jax.vmap(functools.partial(
        jk.pair_row_logsumexp, interpret=True))(
        jnp.asarray(muA), jnp.asarray(precA), jnp.asarray(muB),
        jnp.asarray(precB)))
    # float32 sums in another order (column blocks vs 512-column tiles);
    # the values here lie between about 1 and 10, so no atol is needed
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # and each member equals its own unbatched call bit for bit: the
    # member axis is a batch dimension of the same expressions
    for b in range(3):
        one = K.pair_row_logsumexp(t(muA[b]), t(precA[b]), t(muB[b]),
                                   t(precB[b])).numpy()
        np.testing.assert_array_equal(got[b], one)


def test_split_plan_counts_every_member():
    """A batch has B times the row blocks: its plan equals the plan of
    one problem with B times the rows, to a rows-per-block multiple."""
    for na, nb, B in ((50_000, 50_000, 8), (1_000, 30_000, 3)):
        assert K.split_plan(na, nb, 64, 256, 264, B) == K.split_plan(
            B * -(-na // 64) * 64, nb, 64, 256, 264)


def _two_var_members(B, N, shift=None):
    """B two-variable graphs, member b with its own measurements; each
    gives the update plan of x1 (a prior and a relative from x0)."""
    plans = []
    for b in range(B):
        fg = it.initfg(it.SolverParams(N=N), device=CPU)
        fg.add_variable("x0", it.ContinuousScalar)
        fg.add_factor(["x0"], it.Prior(it.Normal(float(b), 1.0)))
        fg.add_variable("x1", it.ContinuousScalar)
        rel = (it.LinearRelative(it.Normal(10.0 + b, 1.0 + 0.1 * b))
               if shift is None else shift(it.Normal(10.0, 1.0), float(b)))
        fg.add_factor(["x0", "x1"], rel)
        fg.add_factor(["x1"], it.Prior(it.Normal(10.0 + 2.0 * b, 1.0)))
        plans.append(prepare_update(fg, "x1", fg.factors_of("x1")))
    return plans


def _assert_members_agree(plans, batched, flip_bar=0.005):
    """Batched (points, bw) against each plan's own update with the same
    key: particles within 1e-5 but for draws that flipped at a near-tie
    (at most ``flip_bar`` of them), bandwidths within 1e-5 relative."""
    ks = keys.split(keys.make_key(7), len(plans))
    pts_b, bw_b = batched(plans, ks)
    for b, p in enumerate(plans):
        pts, bw = fused.fused_variable_update(
            p.manifold, p.models, p.nested, p.old_points, p.specs, p.masks,
            ks[b], p.n_out)
        rows = (torch.abs(pts_b[b] - pts) > 1e-5).any(dim=-1)
        assert float(rows.float().mean()) <= flip_bar, b
        if not bool(rows.any()):
            np.testing.assert_allclose(bw_b[b].numpy(), bw.numpy(),
                                       rtol=1e-5)


def test_batched_update_matches_members_on_the_large_pair_path(monkeypatch):
    """(b) The batched update against the per-member update, keys equal,
    with every product stage on the large-pair path; the batch calls the
    row-logsumexp once per stage for all members."""
    monkeypatch.setattr(tp, "LARGE_PAIR_THRESHOLD", 1)
    plans = _two_var_members(3, 256)
    K.reset_counts()
    ks = keys.split(keys.make_key(3), 3)
    fused.fused_variable_update_batched(plans, ks)
    # x1's two proposals (the relative's and the prior's): one pair stage,
    # one call for the 3 members
    assert K.counts["calls"] == 1
    assert K.counts["launches"] == 0          # no kernel on the CPU
    _assert_members_agree(plans, fused.fused_variable_update_batched)


class _Shift(it.FactorModel):
    """x2 − x1 = z + shift, the shift read by the residual as a tensor."""

    zdim = 1

    def __init__(self, Z, shift):
        self.Z, self.shift = Z, float(shift)

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, x1, x2):
        return self.residual_with((torch.full_like(meas, self.shift),),
                                  meas, x1, x2)

    def residual_params(self, device):
        return (torch.tensor([self.shift], device=device),)

    def residual_with(self, params, meas, x1, x2):
        return meas + params[0] - (x2 - x1)

    def mean_cov(self):
        return self.Z.mean_cov()


class _ShiftOpaque(it.FactorModel):
    """The same residual from a model that neither says how to stack its
    tensors nor is registered."""

    zdim = 1

    def __init__(self, Z, shift):
        self.Z, self.shift = Z, float(shift)

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, x1, x2):
        return meas + self.shift - (x2 - x1)

    def mean_cov(self):
        return self.Z.mean_cov()


it.register_factor_model(_Shift, ("Z",))


@pytest.mark.parametrize("model", [_Shift, _ShiftOpaque],
                         ids=["stacked-params", "member-by-member"])
def test_batched_update_reads_each_members_residual(model):
    """A residual that reads the model's own tensor: stacked per particle
    when the model says how (residual_params), else each member solved
    alone; both agree with the per-member update, keys equal."""
    plans = _two_var_members(3, 64, shift=model)
    _assert_members_agree(plans, fused.fused_variable_update_batched)


def _count_calls(monkeypatch, name):
    calls = {"n": 0}
    orig = getattr(sched, name)

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sched, name, counting)
    return calls


def test_fourdoor_batched_matches(monkeypatch):
    """(c) tests/test_solve.py:218 on the port: batch_cliques=True batches
    every level of the fourdoor story and keeps its bars."""
    calls = _count_calls(monkeypatch, "up_solve_level")
    fg, steps = it.fourdoor_sequence(it.SolverParams(batch_cliques=True),
                                     device=CPU)
    tree = None
    for s in steps:
        s()
        tree = it.solve_tree(fg, old_tree=tree)
    assert calls["n"] >= len(steps)
    for v, c in [("x1", 0.0), ("x3", 100.0), ("x4", 300.0)]:
        p = fg.points(v)[:, 0]
        assert abs(float(p.mean()) - c) < 10.0, (v, float(p.mean()))


def _forest(mod, params, branches=12):
    fg = mod.initfg(params, **({"device": CPU} if mod is it else {}))
    for b in range(branches):
        fg.add_variable(f"b{b}x0", mod.ContinuousScalar)
        fg.add_factor([f"b{b}x0"], mod.Prior(mod.Normal(float(10 * b), 0.3)))
        fg.add_variable(f"b{b}x1", mod.ContinuousScalar)
        fg.add_factor([f"b{b}x0", f"b{b}x1"],
                      mod.LinearRelative(mod.Normal(1.0, 0.3)))
    return fg


@pytest.mark.parametrize("stacked", [True, False])
def test_auto_batched_wide_level(monkeypatch, stacked):
    """(c) tests/test_solve.py:297 on the port: "auto" at width 4 batches
    the 12-branch level, in one class (stacked) or grouped plan by plan
    (``batch_stacked=False``), at the JAX test's bars."""
    calls = _count_calls(monkeypatch, "up_solve_level")
    fg = _forest(it, it.SolverParams(batch_cliques="auto",
                                     batch_min_width=4))
    fg.params.batch_stacked = stacked
    it.solve_tree(fg)
    assert calls["n"] == 1
    for b in range(12):
        m = float(fg.points(f"b{b}x1").mean())
        assert abs(m - (10 * b + 1)) < 1.5, (b, m)


@pytest.mark.parametrize("bc,width,batched", [
    ("auto", 8, False), ("auto", 4, True), (False, 4, False),
    (True, 100, True)])
def test_batch_cliques_settings(monkeypatch, bc, width, batched):
    """"auto" batches a level of at least batch_min_width cliques (the
    default width is 8: a 4-branch level is not batched), True every
    level, False none."""
    calls = _count_calls(monkeypatch, "up_solve_level")
    fg = _forest(it, it.SolverParams(batch_cliques=bc,
                                     batch_min_width=width), branches=4)
    it.solve_tree(fg)
    assert (calls["n"] > 0) == batched
    for b in range(4):
        assert abs(float(fg.points(f"b{b}x1").mean()) - (10 * b + 1)) < 1.5


def test_fault_injection_takes_the_per_clique_sweep(monkeypatch):
    """As in the JAX package, a solve that skips or delays cliques never
    batches."""
    calls = _count_calls(monkeypatch, "up_solve_level")
    fg = _forest(it, it.SolverParams(batch_cliques=True), branches=4)
    tree = it.solve_tree(fg, delay_cliques={0: 0.0})
    assert calls["n"] == 0
    assert tree.num_cliques() >= 4


def test_forest_by_both_packages():
    """(d) The forest of tests/test_solve.py:297 (cut to 4 branches, the
    batch width lowered to match), solved by the JAX package and by the
    port, each at that test's bars."""
    from incrementalinference import jl_tpu as jt

    for mod, kw in ((jt, {}), (it, {})):
        fg = _forest(mod, mod.SolverParams(batch_cliques="auto",
                                           batch_min_width=4), branches=4)
        mod.solve_tree(fg, **kw)
        for b in range(4):
            m = float(np.asarray(fg.points(f"b{b}x1")).mean())
            assert abs(m - (10 * b + 1)) < 1.5, (mod.__name__, b, m)


def _shared_separator_forest(pair, branches=8):
    """``branches`` copies of a three-level branch: the root {s, r}, the
    middle clique {x, z | r}, and its two children {y | x} and {w | x},
    whose separators share x.  A batched level of middle cliques then holds
    two factors of one kind on x in every member.  ``pair="messages"``:
    the two children's message priors disagree (y says x = 10 b + 3, w
    says x = 10 b - 3, each with std 2); ``pair="priors"``: the messages
    agree and two Priors on x in the middle clique disagree the same way.
    Either way x and r lie at 10 b.  Returns the graph and the elimination
    order that gives that tree."""
    fg = it.initfg(it.SolverParams(N=100), device=CPU)
    off = 3.0 if pair == "messages" else 0.0
    order, top = [], []
    for b in range(branches):
        s, r, z, x, y, w = (f"b{b}{c}" for c in "srzxyw")
        o = 10.0 * b
        for v in (s, r, z, x, y, w):
            fg.add_variable(v, it.ContinuousScalar)
        fg.add_factor([s], it.Prior(it.Normal(o, 3.0)))
        fg.add_factor([s, r], it.LinearRelative(it.Normal(0.0, 0.5)))
        fg.add_factor([r, x], it.LinearRelative(it.Normal(0.0, 0.3)))
        fg.add_factor([z, x], it.LinearRelative(it.Normal(0.0, 3.0)))
        fg.add_factor([z, r], it.LinearRelative(it.Normal(0.0, 3.0)))
        fg.add_factor([y], it.Prior(it.Normal(o, 2.0)))
        fg.add_factor([y, x], it.LinearRelative(it.Normal(off, 0.3)))
        fg.add_factor([w], it.Prior(it.Normal(o, 2.0)))
        fg.add_factor([w, x], it.LinearRelative(it.Normal(-off, 0.3)))
        if pair == "priors":
            fg.add_factor([x], it.Prior(it.Normal(o + 3.0, 2.0)))
            fg.add_factor([x], it.Prior(it.Normal(o - 3.0, 2.0)))
        order += [y, w]
        top += [z, x, r, s]
    return fg, order + top


@pytest.mark.parametrize("pair", ["messages", "priors"])
def test_batched_level_keeps_each_factor_of_a_kind(monkeypatch, pair):
    """A batched level whose members hold two factors of one kind on the
    same variables (two children's message priors on a shared separator,
    or two Priors) uses each of them once, as the per-clique path does.
    The forest of eight branches is solved with the default "auto" (its
    levels of 8 and 16 cliques batch) and with batch_cliques=False, from
    the same seed.  The statistic is r's mean less 10 b, averaged over
    the branches: using one of the pair twice and dropping the other
    shifts every branch the same way, by 1.3 to 2.3, while one branch's
    Gibbs noise (up to about 2 here) is its own, so that the average of
    eight stays within about 0.2.  Bar: 0.6."""
    calls = _count_calls(monkeypatch, "up_solve_level")
    bias = {}
    for bc in ("auto", False):
        fg, order = _shared_separator_forest(pair)
        tree = it.build_tree(fg, order=order)
        mids = [c for c in tree.cliques.values()
                if len(tree.children(c.cid)) == 2]
        assert len(mids) == 8 and all(
            ch.separator == [x for x in c.frontals if x.endswith("x")]
            for c in mids for ch in tree.children(c.cid))
        fg.params.batch_cliques = bc
        n0 = calls["n"]
        it.solve_tree(fg, order=order)
        assert (calls["n"] > n0) == (bc == "auto")
        bias[bc] = float(np.mean([float(fg.points(f"b{b}r").mean())
                                  - 10.0 * b for b in range(8)]))
    for bc, m in bias.items():
        assert abs(m) < 0.6, (pair, bc, bias)
    assert abs(bias["auto"] - bias[False]) < 0.6, (pair, bias)


def test_fused_segment_matches_per_clique(monkeypatch):
    """(e) tests/test_fused_chain.py:64 on the port: fuse_sweep=True
    engages a segment, and the segment solve and the per-clique solve both
    hold the JAX test's bars."""
    calls = _count_calls(monkeypatch, "up_solve_segment")
    means = {}
    for fs in (True, False):
        fg = it.generate_line_step(
            8, graphinit=True, device=CPU,
            params=it.SolverParams(N=75, fuse_sweep=fs, fuse_clique=True))
        it.solve_tree(fg)
        means[fs] = {lbl: float(fg.points(lbl)[:, 0].mean())
                     for lbl in fg.ls()}
    assert calls["n"] >= 1, "segment fusion did not engage"
    for lbl, m in means[True].items():
        truth = float(lbl.lstrip("xlm"))
        assert abs(m - truth) < 0.5, (lbl, m)
        assert abs(means[False][lbl] - truth) < 0.5, (lbl, means[False])


def test_fuse_sweep_auto_is_off(monkeypatch):
    """"auto" resolves to off, as in the JAX package."""
    calls = _count_calls(monkeypatch, "up_solve_segment")
    fg = it.generate_line_step(4, graphinit=True, device=CPU,
                               params=it.SolverParams(N=50))
    it.solve_tree(fg)
    assert calls["n"] == 0


def _chain(mod, N):
    fg = mod.initfg(mod.SolverParams(N=N, fuse_clique=True,
                                     batch_cliques=False),
                    **({"device": CPU} if mod is it else {}))
    fg.add_variable("x0", mod.ContinuousScalar)
    fg.add_factor(["x0"], mod.Prior(mod.Normal(0.0, 0.5)))
    for i in range(4):
        fg.add_variable(f"x{i+1}", mod.ContinuousScalar)
        fg.add_factor([f"x{i}", f"x{i+1}"],
                      mod.LinearRelative(mod.Normal(5.0, 0.5)))
    return fg


class _Enumerate:
    """Stands in for the JAX package's compile pool: takes the jobs and
    runs none, so that its precompile_updates only counts them."""

    def __init__(self, max_workers):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, arg):
        from concurrent.futures import Future

        done = Future()
        done.set_result(None)
        return done


def _jax_count(monkeypatch, fg_t, build):
    """The JAX package's precompile count (its distinct structures,
    enumerated, not compiled) on the port graph's twin, with the port
    tree's elimination order."""
    from incrementalinference.jl_tpu.parallel import precompile as jp
    from incrementalinference.jl_tpu.tree.bayestree import build_tree

    monkeypatch.setattr(jp, "ThreadPoolExecutor", _Enumerate)
    fg_j = build()
    return jp.precompile_updates(fg_j, build_tree(
        fg_j, order=list(it.build_tree(fg_t).elimination_order)))


def test_precompile_seeds_chain_plans(monkeypatch):
    """(e) tests/test_fused_chain.py:96 on the port, its count equal to the
    JAX package's on the same graph and elimination order."""
    from incrementalinference import jl_tpu as jt
    from incrementalinference_torch.parallel.precompile import (
        precompile_updates)

    fg = _chain(it, 80)
    n = precompile_updates(fg, it.build_tree(fg))
    assert n > 0
    assert n == _jax_count(monkeypatch, fg, lambda: _chain(jt, 80))
    it.solve_tree(fg)
    for i in range(5):
        m = float(fg.points(f"x{i}")[:, 0].mean())
        assert abs(m - 5.0 * i) < 2.0, (i, m)


def test_precompile_shard_partitions_jobs(monkeypatch):
    """(e) tests/test_fused_chain.py:125 on the port: the shards are
    disjoint and cover the job list, whose length is the JAX package's."""
    from incrementalinference.jl_tpu.canonical import generate_line_step
    from incrementalinference_torch.parallel.precompile import (
        precompile_updates)

    fg = it.generate_line_step(8, graphinit=True, device=CPU)
    tree = it.build_tree(fg)
    total = precompile_updates(fg, tree)
    parts = [precompile_updates(fg, tree, shard=(i, 3)) for i in range(3)]
    assert sum(parts) == total > 0
    # the JAX package's "auto" resolves the chain off on its CPU backend;
    # the port's always takes it, so the JAX count asks for it by name
    assert total == _jax_count(monkeypatch, fg, lambda: _with(
        generate_line_step(8, graphinit=True), fuse_clique=True))


def _with(fg, **kw):
    fg.params = fg.params.replace(**kw)
    return fg


def test_precompile_option(caplog):
    """(e) tests/test_solve.py:289 on the port; an int asks for the JAX
    package's process farm, which the port runs in-process, saying so."""
    from incrementalinference_torch.parallel import precompile_updates

    fg = it.generate_kaess(graphinit=True, device=CPU)
    tree = it.solve_tree(fg, precompile=True)
    assert tree.num_cliques() >= 1
    assert precompile_updates(fg, tree) >= 1
    with caplog.at_level(logging.INFO):
        it.solve_tree(it.generate_kaess(graphinit=True, device=CPU),
                      precompile=2)
    assert any("no process farm" in r.getMessage() for r in caplog.records)

"""Incremental solves of the port on the CPU: clique recycling against the
JAX package's ``build_tree_reset``, the wildfire gate and its statistic, the
single-clique harness, and the fourdoor story end to end against the JAX
package from identical starting particles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_graph_to_arrays, rng, t

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu.parallel import scheduler as jsched
from incrementalinference.jl_tpu.tree import bayestree as jtree
from incrementalinference_torch.parallel import scheduler as tsched
from incrementalinference_torch.parallel.messages import LikelihoodMessage
from incrementalinference_torch.tree import bayestree as ttree


def _mode_mass(fg, v, center, tol=20.0):
    p = np.asarray(fg.points(v))[:, 0]
    return float(np.mean(np.abs(p - center) < tol))


def _check_fourdoor_step(fg, step):
    """The bars of tests/test_solve.py:23-39 after solve number ``step``."""
    if step == 1:
        for c in (-100, 0, 100, 300):
            assert _mode_mass(fg, "x1", c) > 0.08, c
    elif step == 2:
        assert _mode_mass(fg, "x1", -100) + _mode_mass(fg, "x1", 0) > 0.8
        assert _mode_mass(fg, "x1", 300) < 0.1
        assert _mode_mass(fg, "x3", 0) + _mode_mass(fg, "x3", 100) > 0.8
    else:
        for v, c in [("x1", 0.0), ("x2", 50.0), ("x3", 100.0),
                     ("x4", 300.0)]:
            p = np.asarray(fg.points(v))[:, 0]
            assert np.mean(np.abs(p - c) < 20.0) >= 0.8, (v, c, p.mean())
            assert abs(p.mean() - c) < 10.0, (v, c, p.mean())


def _chain(pkg, n, N=64, sigma=1.0, step=10.0, **params):
    """tests/test_solvekey_wildfire.py's chain, in either package."""
    kw = {} if pkg is jl else {"device": "cpu"}
    fg = pkg.initfg(pkg.SolverParams(N=N, **params), **kw)
    fg.add_variable("x0", pkg.ContinuousScalar)
    fg.add_factor(["x0"], pkg.Prior(pkg.Normal(0.0, sigma)))
    for i in range(n):
        _grow(pkg, fg, i + 1, step, sigma)
    return fg


def _grow(pkg, fg, i, step=10.0, sigma=1.0):
    fg.add_variable(f"x{i}", pkg.ContinuousScalar)
    fg.add_factor([f"x{i - 1}", f"x{i}"],
                  pkg.LinearRelative(pkg.Normal(step, sigma)))


# -- build_tree_reset against the JAX package --------------------------------

def _marks(tree):
    return {(c.signature(), c.is_recycled, c.is_marginalized, c.status.value)
            for c in tree.cliques.values()}


@pytest.mark.parametrize("case", ["grow-end", "prior-in-the-middle",
                                  "incremental-off", "marginalized-leaf",
                                  "errored-clique"])
def test_build_tree_reset_matches_jax(case):
    """Same graph, same order, same growth, the old tree's statuses taken
    from a JAX solve: the same set of (signature, is_recycled,
    is_marginalized, status), exactly."""
    fj = _chain(jl, 6, incremental=case != "incremental-off")
    old_j = jl.solve_tree(fj, order=fj.ls())
    ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
    old_t = ttree.build_tree(ft, order=ft.ls())
    by_sig = {c.signature(): c for c in old_j.cliques.values()}
    assert set(by_sig) == {c.signature() for c in old_t.cliques.values()}
    for c in old_t.cliques.values():
        c.status = ttree.CliqStatus(by_sig[c.signature()].status.value)
    leaf_sig = next(c.signature() for c in old_j.cliques.values()
                    if not c.children)
    for tree, CS in ((old_j, jtree.CliqStatus), (old_t, ttree.CliqStatus)):
        leaf = next(c for c in tree.cliques.values()
                    if c.signature() == leaf_sig)
        if case == "marginalized-leaf":
            leaf.is_marginalized = True
        if case == "errored-clique":
            leaf.status = CS.ERROR_STATUS
        tree.down_cache = {leaf_sig: {"kept": 1}, ("gone",): {"dropped": 1}}

    for pkg, fg in ((jl, fj), (it, ft)):
        if case == "prior-in-the-middle":
            fg.add_factor(["x3"], pkg.Prior(pkg.Normal(35.0, 0.5)),
                          graphinit=False)
        else:
            _grow(pkg, fg, 7)
    new_j = jtree.build_tree_reset(fj, order=fj.ls(), old_tree=old_j)
    new_t = ttree.build_tree_reset(ft, order=ft.ls(), old_tree=old_t)
    assert _marks(new_t) == _marks(new_j)
    assert set(new_t.down_cache) == set(new_j.down_cache)
    n_rec = sum(c.is_recycled for c in new_t.cliques.values())
    # an errored leaf un-recycles every clique above it in the chain
    assert (n_rec == 0) == (case in ("incremental-off", "errored-clique"))
    # without an old tree nothing is marked
    assert not any(c.is_recycled for c in
                   ttree.build_tree_reset(ft, order=ft.ls()).cliques.values())


def test_clique_of_and_delete_clique():
    fg = _chain(it, 4)
    tree = ttree.build_tree(fg, order=fg.ls())
    leaf = next(c for c in tree.cliques.values() if not c.children)
    assert tree.clique_of(leaf.frontals[0]) is leaf
    parent = tree.clique(leaf.parent)
    gone = tree.delete_clique(parent.cid)
    assert gone is parent and parent.cid not in tree.cliques
    assert leaf.parent is None and leaf.cid in tree.root_ids
    assert all(f not in tree.frontal_to_clique for f in parent.frontals)


# -- the fourdoor story and the recycling tests of tests/test_solve.py --------

def test_fourdoor_incremental():
    """tests/test_solve.py:17-39 through the port's entry points."""
    fg, steps = it.fourdoor_sequence(device="cpu")
    tree = None
    for k, step in enumerate(steps, start=1):
        step()
        tree = it.solve_tree(fg, old_tree=tree)
        _check_fourdoor_step(fg, k)
    assert sum(c.is_recycled for c in tree.cliques.values()) >= 1


def test_recycling_skips_unchanged_cliques():
    """tests/test_solve.py:136-160."""
    fg = _chain(it, 4, N=100, sigma=0.5, step=1.0)
    tree = it.solve_tree(fg, order=fg.ls())
    _grow(it, fg, 5, 1.0, 0.5)
    tree2 = it.solve_tree(fg, old_tree=tree, order=fg.ls())
    assert sum(c.is_recycled for c in tree2.cliques.values()) >= 1
    assert any(c.status == it.CliqStatus.DOWNSOLVED and not c.is_recycled
               for c in tree2.cliques.values())


def test_incremental_growth_recycling_soak():
    """tests/test_solve.py:264-286."""
    fg = it.initfg(device="cpu")
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.5)))
    tree, i, recycled = None, 0, []
    for step in range(3):
        for _ in range(6):
            i += 1
            _grow(it, fg, i, 1.0, 0.1)
        tree = it.solve_tree(fg, old_tree=tree)
        recycled.append(sum(c.is_recycled for c in tree.cliques.values()))
        err = abs(float(fg.points(f"x{i}").mean()) - i)
        assert err < 0.5, (step, err)
    assert recycled[1] > 0 and recycled[2] > recycled[1], recycled


def test_fixed_lag_freeze():
    """tests/test_solve.py:232-251: frozen points are bit-identical after a
    second solve, here an incremental one."""
    fg = _chain(it, 5, N=100, sigma=0.5,
                is_fixed_lag=True, qfl=3)
    tree = it.solve_tree(fg)
    frozen = [v for v in fg.ls() if fg.var(v).marginalized]
    assert "x0" in frozen and "x5" not in frozen
    before = fg.points("x0").numpy().copy()
    it.solve_tree(fg, old_tree=tree)
    np.testing.assert_array_equal(before, fg.points("x0").numpy())
    assert abs(float(fg.points("x5").mean()) - 50.0) < 5.0


def test_marginalized_clique_is_skipped_up_and_down():
    """A clique marked marginalized in the old tree keeps the mark, emits
    its messages from the graph and leaves its frontals as they are."""
    fg = _chain(it, 4, record_cliques=True)
    tree = it.solve_tree(fg, order=fg.ls())
    leaf = next(c for c in tree.cliques.values() if not c.children)
    leaf.is_marginalized = True
    before = {v: fg.points(v).clone() for v in leaf.frontals}
    tree2 = it.solve_tree(fg, old_tree=tree, order=fg.ls())
    leaf2 = next(c for c in tree2.cliques.values()
                 if c.signature() == leaf.signature())
    assert leaf2.is_marginalized
    assert leaf2.status == it.CliqStatus.MARGINALIZED
    assert tree2.up_msgs[leaf2.cid].status == it.CliqStatus.MARGINALIZED
    steps = [s for _, s, _ in tree2.traces[leaf2.cid].events]
    assert steps == ["recycle", "marginalized"], steps
    for v, p in before.items():
        assert torch.equal(fg.points(v), p)


# -- tests/test_solvekey_wildfire.py on the port ------------------------------

def _mean(fg, lbl, key="default"):
    return float(fg.points(lbl, key).mean())


def _recycle_events(tree, needle):
    return [(tr.cid, d) for tr in tree.traces.values()
            for (_, s, d) in tr.events if s == "recycle" and needle in d]


def test_named_solve_key_independent():
    fg = _chain(it, 3)
    it.solve_tree(fg, solve_key="alt")
    for i in range(4):
        assert abs(_mean(fg, f"x{i}", "alt") - 10.0 * i) < 2.5
    before = [_mean(fg, f"x{i}", "alt") for i in range(4)]
    tree = it.solve_tree(fg)
    assert [_mean(fg, f"x{i}", "alt") for i in range(4)] == before
    for i in range(4):
        assert abs(_mean(fg, f"x{i}", "default") - 10.0 * i) < 2.5
    # a recycled up message carries the beliefs of the key being solved
    _grow(it, fg, 4)
    tree2 = it.solve_tree(fg, old_tree=tree, solve_key="alt")
    recycled = [c for c in tree2.cliques.values() if c.is_recycled]
    assert recycled
    for c in recycled:
        assert tree2.up_msgs[c.cid].status == it.CliqStatus.UPRECYCLED
    for i in range(5):
        assert abs(_mean(fg, f"x{i}", "alt") - 10.0 * i) < 2.5


def test_recycled_up_message_reads_the_solve_key():
    fg = _chain(it, 3)
    tree = it.solve_tree(fg)
    it.solve_tree(fg, solve_key="alt")
    leaf = next(c for c in tree.cliques.values() if not c.children)
    leaf.is_recycled, leaf.status = True, it.CliqStatus.UPRECYCLED
    for key in ("default", "alt"):
        msg = tsched.up_solve_clique(fg, tree, leaf, [], key)
        assert msg.status == it.CliqStatus.UPRECYCLED
        assert set(msg.beliefs) == set(leaf.separator)
        for v, b in msg.beliefs.items():
            assert b.points is fg.get_belief(v, key).points


def test_default_keeps_reference_down_semantics():
    fg = _chain(it, 6, incremental=True, record_cliques=True)
    tree = it.solve_tree(fg)
    _grow(it, fg, 7)
    tree2 = it.solve_tree(fg, old_tree=tree)
    assert len(_recycle_events(tree2, "up-solve")) > 0
    assert len(_recycle_events(tree2, "down-solve")) == 0
    assert tree2.wildfire_stats == {
        "exact_skips": 0, "stat_syncs": 0, "wildfire_skips": 0,
        "down_solves": tree2.num_cliques()}
    assert tree2.down_cache == {}          # nothing recorded with the gate off
    for tr in tree2.traces.values():
        steps = [s for _, s, _ in tr.events]
        assert "up_done" in steps or "recycle" in steps, (tr.cid, steps)
        assert "down_done" in steps, (tr.cid, steps)


def test_wildfire_skips_unchanged_down_solves():
    fg = _chain(it, 9, incremental=True, record_cliques=True,
                wildfire_tol=0.6)
    tree = it.solve_tree(fg)
    _grow(it, fg, 10)
    tree2 = it.solve_tree(fg, old_tree=tree)
    assert len(_recycle_events(tree2, "down-solve")) >= 3
    wf = tree2.wildfire_stats
    assert wf["exact_skips"] + wf["wildfire_skips"] >= 3, wf
    assert wf["wildfire_skips"] <= wf["stat_syncs"], wf
    assert wf["down_solves"] + wf["exact_skips"] + wf["wildfire_skips"] \
        == tree2.num_cliques(), wf
    for i in range(11):
        assert abs(_mean(fg, f"x{i}") - 10.0 * i) < 3.0


def test_wildfire_resolves_when_information_changes():
    fg = _chain(it, 6, incremental=True, record_cliques=True,
                wildfire_tol=0.3)
    tree = it.solve_tree(fg)
    fg.add_factor(["x3"], it.Prior(it.Normal(35.0, 0.5)))
    tree2 = it.solve_tree(fg, old_tree=tree)
    assert len(_recycle_events(tree2, "wildfire")) == 0
    assert 31.0 < _mean(fg, "x3") < 37.0
    assert _mean(fg, "x6") > 55.0


def test_wildfire_auto_stays_off_below_crossover():
    fg = _chain(it, 6, incremental=True, record_cliques=True,
                wildfire_tol="auto")
    tree = it.solve_tree(fg)
    assert tree.down_cache                 # recorded though the gate is off
    _grow(it, fg, 7)
    tree2 = it.solve_tree(fg, old_tree=tree)
    assert tree2.wildfire_stats["stat_syncs"] == 0
    assert tree2.wildfire_stats["wildfire_skips"] == 0
    assert len(_recycle_events(tree2, "down-solve")) == 0


def test_wildfire_auto_enables_past_crossover(monkeypatch):
    assert tsched.WILDFIRE_AUTO_MIN_RECYCLED == \
        jsched.WILDFIRE_AUTO_MIN_RECYCLED == 64
    assert tsched.WILDFIRE_AUTO_TOL == jsched.WILDFIRE_AUTO_TOL
    monkeypatch.setattr(tsched, "WILDFIRE_AUTO_MIN_RECYCLED", 5)
    fg = _chain(it, 9, incremental=True, record_cliques=True,
                wildfire_tol="auto")
    tree = it.solve_tree(fg)
    _grow(it, fg, 10)
    tree2 = it.solve_tree(fg, old_tree=tree)
    wf = tree2.wildfire_stats
    assert wf["exact_skips"] + wf["wildfire_skips"] >= 3, wf
    for i in range(11):
        assert abs(_mean(fg, f"x{i}") - 10.0 * i) < 3.0


def test_wildfire_tol_string_other_than_auto_is_refused():
    fg = _chain(it, 2, wildfire_tol="on")
    with pytest.raises(ValueError, match="wildfire_tol"):
        it.solve_tree(fg)


# -- the statistic, its host reads, and what the summary holds ----------------

def _msg(points_by_var):
    msg = LikelihoodMessage(sender=1, status=it.CliqStatus.DOWNSOLVED,
                            direction="down")
    for v, p in points_by_var.items():
        msg.beliefs[v] = it.make_belief(it.ContinuousEuclid(p.shape[1])
                                        .manifold, t(p), bw=torch.ones(
                                            p.shape[1]))
    return msg


def test_wildfire_statistic_matches_jax():
    """``_wildfire_stat`` of the two summaries against the JAX package's
    ``_wildfire_stat_many`` on identical arrays: 1e-6 relative."""
    r = rng(5)
    olds = {"a": r.normal(0, 1, (64, 1)), "b": r.normal(5, 2, (64, 3)),
            "c": r.normal(-3, 0.1, (64, 2))}
    news = {"a": olds["a"] + 0.3, "b": r.normal(5.5, 1, (64, 3)),
            "c": olds["c"]}
    olds = {k: v.astype(np.float32) for k, v in olds.items()}
    news = {k: v.astype(np.float32) for k, v in news.items()}
    want = float(jsched._wildfire_stat_many(
        tuple(jnp.asarray(news[k]) for k in news),
        tuple(jnp.asarray(olds[k]) for k in news)))
    s_new, s_old = tsched._msg_summary(_msg(news)), \
        tsched._msg_summary(_msg(olds))
    got = float(tsched._wildfire_stat(s_new, s_old))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    assert tsched._wildfire_unchanged(s_new, s_old, want * 1.01)
    assert not tsched._wildfire_unchanged(s_new, s_old, want * 0.99)
    assert not tsched._wildfire_unchanged(s_new, None, 10.0)
    assert not tsched._wildfire_unchanged(
        s_new, {k: v for k, v in s_old.items() if k != "a"}, 10.0)
    short = dict(s_old, a=tsched._msg_summary(_msg({"a": olds["a"][:32]}))["a"])
    assert not tsched._wildfire_unchanged(s_new, short, 10.0)


def test_one_host_read_per_consulted_clique(monkeypatch):
    """The gate's only device-to-host read is ``_wildfire_unchanged``'s
    ``.item()``: ``stat_syncs`` counts every call of it, and recording
    summaries with the gate resolved off calls it never."""
    calls = []
    orig = tsched._wildfire_unchanged

    def counting(new, old, tol):
        calls.append(tol)
        return orig(new, old, tol)

    monkeypatch.setattr(tsched, "_wildfire_unchanged", counting)
    fg = _chain(it, 9, wildfire_tol=0.6)
    tree = it.solve_tree(fg)
    assert calls == [] and tree.wildfire_stats["stat_syncs"] == 0
    _grow(it, fg, 10)
    tree2 = it.solve_tree(fg, old_tree=tree)
    assert len(calls) == tree2.wildfire_stats["stat_syncs"] > 0

    calls.clear()
    fg = _chain(it, 6, wildfire_tol="auto")
    tree = it.solve_tree(fg)
    _grow(it, fg, 7)
    it.solve_tree(fg, old_tree=tree)
    assert calls == []


def test_summary_survives_growth_and_in_place_writes():
    """The cached summary of the first solve still equals what it was after
    the graph grew and was solved again, and after a belief's points were
    overwritten in place: it holds statistics, not the particle tensors.
    The port itself replaces beliefs and never writes into them."""
    fg = _chain(it, 6, wildfire_tol="auto")
    tree = it.solve_tree(fg)
    assert tree.down_cache
    snap = {sig: {v: (shape, mean.clone(), spread.clone())
                  for v, (shape, mean, spread) in s.items()}
            for sig, s in tree.down_cache.items()}
    held = {v: fg.points(v) for v in fg.ls()}
    copies = {v: p.clone() for v, p in held.items()}
    _grow(it, fg, 7)
    tree2 = it.solve_tree(fg, old_tree=tree)
    for v, p in held.items():              # replaced, never mutated
        assert torch.equal(p, copies[v]), v
    assert set(tree2.down_cache) <= {c.signature()
                                     for c in tree2.cliques.values()}
    for v in fg.ls():
        fg.points(v).add_(1000.0)          # what a caller might do
    assert set(tree.down_cache) == set(snap)
    for sig, s in tree.down_cache.items():
        for v, (shape, mean, spread) in s.items():
            assert shape == snap[sig][v][0]
            assert torch.equal(mean, snap[sig][v][1])
            assert torch.equal(spread, snap[sig][v][2])


# -- the single-clique harness (tests/test_cliq_harness.py:14, :69) -----------

def test_solve_cliq_up_down_harness():
    N = 8
    fg = it.generate_line_step(N, graphinit=False, pose_every=1,
                               landmark_every=N + 1, pose_priors_at=(0,),
                               sight_distance=N + 1, device="cpu")
    it.init_all(fg)
    tree = it.build_tree(fg)
    leaf = next(c for c in tree.cliques.values() if not c.children)
    msg = it.solve_cliq_up(fg, tree, leaf.frontals[0])
    assert msg.status == it.CliqStatus.UPSOLVED
    assert set(msg.beliefs) <= set(leaf.separator)
    assert leaf.status == it.CliqStatus.UPSOLVED
    assert it.solve_cliq_with_state_machine is it.solve_cliq_up

    root = tree.clique(tree.root_ids[0])
    out = it.solve_cliq_down(fg, tree, root.frontals[0], child_msgs=[msg])
    assert isinstance(out, dict)
    assert root.status == it.CliqStatus.DOWNSOLVED
    for ch_cid, dmsg in out.items():
        ch = tree.clique(ch_cid)
        assert dmsg.direction == "down"
        assert set(dmsg.beliefs) <= set(ch.separator) | set(ch.frontals)

    marg = it.approx_cliq_marginal_up(fg, tree, leaf.frontals[0])
    assert set(marg) == set(leaf.all_vars)
    est = it.set_ppe(fg, leaf.frontals[0])
    assert set(est) == {"mean", "max", "suggested"}
    assert fg.var(leaf.frontals[0]).ppe["default"] is est


def test_harness_auto_builds_messages():
    fg = _chain(it, 3, N=100, sigma=0.5, step=5.0)
    it.init_all(fg)
    tree = it.build_tree(fg)
    root = tree.clique(tree.root_ids[0])
    msg = it.solve_cliq_up(fg, tree, root.frontals[0])
    assert msg.status == it.CliqStatus.UPSOLVED
    leaf = next(c for c in tree.cliques.values() if c.parent is not None)
    out = it.solve_cliq_down(fg, tree, leaf.frontals[0])
    assert isinstance(out, dict)
    assert leaf.status == it.CliqStatus.DOWNSOLVED
    for v in leaf.frontals:
        assert abs(_mean(fg, v) - 5.0 * int(v[1:])) < 3.0, v


def test_init_variable_and_reset_initial_values():
    """jl_tpu/graphinit.py:68-97: from points, one point, a distribution, a
    belief; and back to the graphinit snapshot."""
    fg = _chain(it, 1, N=50)
    snap = fg.points("x1", "graphinit").clone()
    b = it.init_variable(fg, "x1", np.full((50, 1), 3.0), bw=[0.5])
    assert torch.equal(fg.points("x1"), torch.full((50, 1), 3.0))
    assert float(b.bw[0]) == 0.5 and fg.var("x1").is_initialized()
    it.init_variable(fg, "x1", np.array([7.0]))
    assert fg.points("x1").shape == (50, 1)
    assert float(fg.points("x1").min()) == 7.0
    it.init_variable(fg, "x1", it.Normal(20.0, 1.0))
    assert abs(_mean(fg, "x1") - 20.0) < 1.0
    it.init_variable(fg, "x1", fg.get_belief("x0"), solve_key="other")
    assert fg.points("x1", "other") is fg.points("x0")
    it.reset_initial_values(fg)
    assert torch.equal(fg.points("x1"), snap)


@pytest.mark.parametrize("name,nvars,nfactors", [
    ("generate_test_symbolic", 8, 10), ("generate_caesar_ring1d", 8, 9)])
def test_canonical_generators_match_jax(name, nvars, nfactors):
    import incrementalinference.jl_tpu.canonical as jcanon
    fj = getattr(jcanon, name)()
    ft = getattr(it, name)(device="cpu")
    assert ft.ls() == fj.ls() and len(ft.ls()) == nvars
    assert ft.lsf() == fj.lsf() and len(ft.lsf()) == nfactors
    for fl in ft.lsf():
        assert ft.factor(fl).variables == fj.factor(fl).variables
        assert type(ft.factor(fl).model).__name__ == \
            type(fj.factor(fl).model).__name__
    order = fj.ls()
    tj = jtree.build_tree(fj, order=order)
    tt = ttree.build_tree(ft, order=order)
    assert {c.signature() for c in tt.cliques.values()} == \
        {c.signature() for c in tj.cliques.values()}


# -- the fourdoor story end to end, against the JAX package ------------------

def _by_sig(tree, what):
    return {c.signature(): what(c) for c in tree.cliques.values()}


def test_fourdoor_matches_jax_from_identical_particles():
    """The JAX package builds each fourdoor step (its graphinit draws the new
    variables); the port gets that graph through convert, so both solve
    from identical particles, each recycling against its own previous
    tree.  Deterministic parts are equal: the tree (clique signatures), the
    recycled set, the statuses, the variable sets of the up and down
    messages.  The posteriors are random streams of two packages: each is
    held at the bars of tests/test_solve.py:23-39, and after the last step
    their means agree within 6 (the sd of a mean of 100 draws from a door,
    sigma 3, is 0.3; the bars allow 10)."""
    from incrementalinference.jl_tpu.canonical import fourdoor_sequence
    fj, steps = fourdoor_sequence()
    tree_j = tree_t = None
    for k, step in enumerate(steps, start=1):
        step()
        ft = it.graph_from_arrays(jax_graph_to_arrays(fj), device="cpu")
        for v in fj.ls():
            if fj.var(v).is_initialized():
                np.testing.assert_array_equal(ft.points(v).numpy(),
                                              np.asarray(fj.points(v)))
        assert isinstance(ft.factor(fj.lsf()[0]).model, it.Mixture)
        order = fj.ls()
        tree_j = jl.solve_tree(fj, old_tree=tree_j, order=order)
        tree_t = it.solve_tree(ft, old_tree=tree_t, order=order)
        for what in (lambda c: c.is_recycled, lambda c: c.status.value,
                     lambda c: sorted(c.iter_vars)):
            assert _by_sig(tree_t, what) == _by_sig(tree_j, what), k
        for attr in ("up_msgs", "down_msgs"):
            got = _by_sig(tree_t, lambda c: sorted(
                getattr(tree_t, attr)[c.cid].beliefs)
                if c.cid in getattr(tree_t, attr) else None)
            want = _by_sig(tree_j, lambda c: sorted(
                getattr(tree_j, attr)[c.cid].beliefs)
                if c.cid in getattr(tree_j, attr) else None)
            assert got == want, (k, attr)
        _check_fourdoor_step(fj, k)
        _check_fourdoor_step(ft, k)
    assert sum(c.is_recycled for c in tree_t.cliques.values()) >= 1
    for v in ("x1", "x2", "x3", "x4"):
        assert abs(float(ft.points(v).mean())
                   - float(np.asarray(fj.points(v)).mean())) < 6.0, v

"""Diagnostics in the port on the CPU: compat names, the blob store,
debugging, fault injection, history files and warmup.

The cases of tests/test_compat.py (the names slice 9a did not carry),
tests/test_debugging.py, tests/test_accessors.py:303-331 and :436-451,
tests/test_solve.py:98-105 and :316-333 on the port.  Where the output is
deterministic (packed constructors, node data, dot and TeX renderings of
one tree or graph), the same call of both packages is compared."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_native_ordering  # noqa: F401

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import compat as jcompat
from incrementalinference.jl_tpu import debugging as jdbg
from incrementalinference_torch import compat
from incrementalinference_torch import debugging as dbg
from incrementalinference_torch.parallel.scheduler import (
    CliqueTrace, build_clique_subgraph)
from incrementalinference_torch.serialization.packed import (
    unpack_belief, unpack_distribution, unpack_factor_model)
from incrementalinference_torch.tree.bayestree import CliqStatus

CPU = "cpu"


def _doc(d):
    return json.loads(json.dumps(d))


def _chain(n=3, record=False, pkg=it):
    params = pkg.SolverParams(record_cliques=record)
    fg = pkg.initfg(params, device=CPU) if pkg is it else pkg.initfg(params)
    for i in range(n):
        fg.add_variable(f"x{i}", pkg.ContinuousScalar)
    fg.add_factor(["x0"], pkg.Prior(pkg.Normal(0.0, 1.0)))
    for i in range(n - 1):
        fg.add_factor([f"x{i}", f"x{i + 1}"],
                      pkg.LinearRelative(pkg.Normal(1.0, 0.5)))
    return fg


def _ring(record=True, logpath=None):
    """tests/test_debugging.py's solved fixture on the port."""
    fg = it.generate_caesar_ring1d(graphinit=True, device=CPU)
    fg.params.record_cliques = record
    if logpath is not None:
        fg.params.logpath = logpath
    return fg


# -- compat ---------------------------------------------------------------------

def test_aliases_and_summaries():
    fg = it.initfg(device=CPU)
    assert isinstance(fg, it.GraphsDFG) and compat.LocalDFG is it.FactorGraph
    assert it.AbstractBayesTree is it.BayesTree
    assert it.TreeBelief is it.Belief and it.BeliefArray is torch.Tensor
    assert it.CommonConvWrapper.__name__ == "ConvSpec"
    assert it.get_solver_params(fg) is fg.params
    assert np.allclose(it.diagm([1.0, 2.0]), np.diag([1.0, 2.0]))
    fg.add_variable("x0", it.ContinuousScalar, tags=("POSE",))
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    assert isinstance(fg.var("x0").vartype, it.InferenceVariable)
    # the summaries of the same graph in both packages
    gj = jl.initfg()
    gj.add_variable("x0", jl.ContinuousScalar, tags=("POSE",))
    gj.add_factor(["x0"], jl.Prior(jl.Normal(0.0, 1.0)))
    for g in (fg, gj):
        g.var("x0").timestamp = 5.0
        g.factor("x0f1").timestamp = 6.0
    assert (it.variable_summary(fg.var("x0")).__dict__
            == jl.variable_summary(gj.var("x0")).__dict__)
    assert (it.factor_summary(fg.factor("x0f1")).__dict__
            == jl.factor_summary(gj.factor("x0f1")).__dict__)
    vs = it.variable_summary(fg.var("x0"))
    assert vs.label == "x0" and vs.npoints == fg.params.N


_CTORS = [("PackedNormal", (3.0, 0.5)), ("PackedUniform", (-1.0, 2.0)),
          ("PackedCategorical", ([0.25, 0.75],)), ("PackedRayleigh", (2.0,)),
          ("PackedDiagNormal", ([1.0, 2.0], [4.0, 9.0])),
          ("PackedZeroMeanDiagNormal", ([4.0, 9.0],)),
          ("PackedFullNormal", ([1.0, 2.0], [[2.0, 0.5], [0.5, 1.0]])),
          ("PackedZeroMeanFullNormal", (np.eye(2) * 4.0,)),
          ("PackedAliasingScalarSampler", ([0.0, 1.0, 2.0], [0.2, 0.3, 0.5]))]


@pytest.mark.parametrize("name,args", _CTORS, ids=[c[0] for c in _CTORS])
def test_packed_distribution_constructors(name, args):
    """Each Packed* constructor makes the JAX package's dict, and it
    unpacks to the distribution it describes."""
    d = getattr(compat, name)(*args)
    assert _doc(d) == _doc(getattr(jcompat, name)(*args))
    z = unpack_distribution(d, device=CPU)
    mu, cov = z.mean_cov()
    mj, cj = jl.serialization.unpack_distribution(_doc(d)).mean_cov()
    np.testing.assert_allclose(mu, np.asarray(mj), atol=1e-6)
    np.testing.assert_allclose(cov, np.asarray(cj), atol=1e-6)


def test_packed_model_constructors():
    p = compat.PackedPrior(it.Normal(1.0, 2.0))
    assert _doc(p) == _doc(jcompat.PackedPrior(jl.Normal(1.0, 2.0)))
    assert type(unpack_factor_model(p, device=CPU)).__name__ == "Prior"
    assert compat.PackedGenericMarginal() == jcompat.PackedGenericMarginal()
    pp = compat.PackedPartialPrior(it.Normal(0.0, 1.0), [0])
    assert _doc(pp) == _doc(jcompat.PackedPartialPrior(jl.Normal(0.0, 1.0),
                                                       [0]))
    assert unpack_factor_model(pp, device=CPU).partial == (0,)
    assert _doc(compat.PackedSamplableBelief(it.Normal(0.0, 1.0))) == \
        _doc(jcompat.PackedSamplableBelief(jl.Normal(0.0, 1.0)))
    mix = it.Mixture(it.Prior(it.Normal(0.0, 1.0)),
                     [it.Normal(0.0, 1.0), it.Normal(5.0, 1.0)], [0.5, 0.5])
    assert type(unpack_factor_model(compat.PackedMixture(mix),
                                    device=CPU)).__name__ == "Mixture"

    fg = it.initfg(device=CPU)
    fg.add_variable("x", it.ContinuousScalar)
    fg.add_factor(["x"], it.Prior(it.Normal(0.0, 1.0)))
    b = fg.get_belief("x")
    b2 = unpack_belief(compat.PackedManifoldKernelDensity(b), device=CPU)
    assert torch.equal(b2.points, b.points)
    assert "points" not in compat.PackedManifoldKernelDensity(b, parch=True)
    pm = compat.PackedMsgPrior(b, it.Euclidean(1))
    assert pm["_type"] == "MsgPrior" and pm["belief"]["npts"] == b.n
    xs = np.linspace(0, 1, 4, dtype=np.float32)
    grid = np.outer(xs, xs)
    for ctor, z in (("PackedHeatmapGridDensity",
                     it.HeatmapGridDensity(grid, (xs, xs))),
                    ("PackedLevelSetGridNormal",
                     it.LevelSetGridNormal(grid, (xs, xs), 0.5, 0.1))):
        d = getattr(compat, ctor)(z)
        assert d["_type"] == ctor[len("Packed"):]
        assert _doc(d) == _doc(getattr(jcompat, ctor)(
            jl.serialization.unpack_distribution(_doc(d))))
    spec = (("dense", 2, 1),)
    nn = it.FluxModelsDistribution(it.SequentialNet(spec),
                                   it.nn_init(torch.Generator(), spec, 2),
                                   torch.ones(2), out_dim=1)
    assert compat.PackedFluxModelsDistribution(nn)["apply"] == "sequential"


def test_packed_node_data():
    """PackedBayesTreeNodeData / PackedFunctionNodeData of one chain, equal
    in both packages."""
    order = ["x0", "x1", "x2"]
    fg, gj = _chain(3), _chain(3, pkg=jl)
    tree, tj = it.build_tree(fg, order=order), jl.build_tree(gj, order=order)
    for cid in tree.cliques:
        cd = compat.PackedBayesTreeNodeData(tree.clique(cid))
        assert "frontals" in cd and "potentials" in cd
        assert cd == jcompat.PackedBayesTreeNodeData(tj.clique(cid))
    for fl in fg.lsf():
        fd = compat.PackedFunctionNodeData(fg.factor(fl))
        assert _doc(fd) == _doc(jcompat.PackedFunctionNodeData(gj.factor(fl)))
    assert compat.PackedFunctionNodeData(
        fg.factor(fg.lsf()[0]))["fnc"]["_type"] == "Prior"


def test_fsm_shims():
    fg = _chain(3, record=True)
    traces = it.solve_tree(fg).traces
    cid = next(iter(traces))
    assert dbg.get_state_label(traces[cid].events[0])
    assert f"cliq{cid}[0]" in dbg.draw_state_transition_step(traces, cid, 0)
    assert dbg.draw_state_machine_history(traces)
    assert repr(dbg.exit_state_machine) == "exitStateMachine"
    assert dbg.exit_state_machine() is None


def test_cliq_state_machine_container():
    fg = _chain(3)
    tree = it.build_tree(fg)
    cl = tree.clique(list(tree.cliques)[0])
    csmc = it.CliqStateMachineContainer(
        dfg=fg, cliq_sub_fg=build_clique_subgraph(fg, cl), tree=tree,
        cliq=cl)
    assert csmc.solve_key == "default" and csmc.cliq is cl


def test_reference_type_aliases():
    prior = it.Prior(it.Normal(0.0, 1.0))
    rel = it.LinearRelative(it.Normal(0.0, 1.0))
    assert isinstance(prior, it.AbstractPrior)
    assert isinstance(prior, it.AbstractFactor) and it.CalcFactor is \
        it.AbstractFactor
    assert isinstance(rel, it.AbstractRelative)
    # the reference's hierarchies are disjoint
    assert not isinstance(prior, it.AbstractRelative)
    assert not isinstance(prior, it.AbstractRelativeMinimize)
    assert isinstance(rel, it.AbstractManifoldMinimize)
    mix_rel = it.Mixture(it.LinearRelative,
                         [it.Normal(0.0, 1.0), it.Normal(2.0, 1.0)])
    mix_pri = it.Mixture(it.Prior, [it.Normal(0.0, 1.0), it.Normal(2.0, 1.0)])
    assert isinstance(mix_rel, it.AbstractRelative)
    assert not isinstance(mix_pri, it.AbstractRelative)
    assert issubclass(it.LinearRelative, it.AbstractRelative)
    assert not issubclass(it.Prior, it.AbstractRelative)
    assert issubclass(it.Mixture, it.AbstractRelative)
    # reflexive on the virtual base and its aliases
    assert issubclass(it.AbstractRelative, it.AbstractRelative)
    assert issubclass(it.AbstractRelativeMinimize, it.AbstractRelative)


# -- datastore (tests/test_accessors.py:303-331) ----------------------------------

def test_datastore_roundtrip(tmp_path):
    fg = _chain(2)
    store = it.FolderStore(str(tmp_path / "blobs"), key="data")
    it.add_blob_store(fg, store)
    assert it.list_blob_stores(fg) == ["data"]
    payload = json.dumps({"camera": "left", "seq": 7}).encode()
    entry = it.add_data(fg, "x0", "img_meta", payload,
                        mime_type="application/json/octet-stream")
    assert it.list_blob_entries(fg, "x0") == ["img_meta"] == \
        it.list_data_entries(fg, "x0")
    got_entry, raw = it.get_data(fg, "x0", "img_meta")
    assert raw == payload and got_entry.blob_id == entry.blob_id
    doc = it.fetch_data_json(fg, "x0", "img_meta")
    assert doc["camera"] == "left" and doc["seq"] == 7
    assert os.path.exists(str(tmp_path / "blobs" / entry.blob_id))
    it.delete_data(fg, "x0", "img_meta")
    assert it.list_blob_entries(fg, "x0") == []
    assert not os.path.exists(str(tmp_path / "blobs" / entry.blob_id))


def test_datastore_memory_and_hash_check():
    fg = _chain(2)
    it.add_blob_store(fg, it.InMemoryBlobStore())
    e = it.add_data(fg, "x1", "scan", b"\x01\x02\x03")
    assert isinstance(e, it.BlobEntry) and e.origin == "x1"
    assert it.get_data(fg, "x1", "scan")[1] == b"\x01\x02\x03"
    bid = it.add_blob(fg, b"raw")
    assert it.get_blob(fg, bid) == b"raw"
    it.get_blob_store(fg).put(e.blob_id, b"tampered")
    with pytest.raises(ValueError):
        it.get_data(fg, "x1", "scan")
    it.add_data(fg, "x1", "note", b"plain", mime_type="text/plain")
    with pytest.raises(ValueError, match="JSON"):
        it.fetch_data_json(fg, "x1", "note")
    with pytest.raises(KeyError):
        it.get_blob_store(_chain(1))


# -- debugging (tests/test_debugging.py) -----------------------------------------

@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    fg = _ring(logpath=str(tmp_path_factory.mktemp("ringlogs")))
    return fg, it.solve_tree(fg)


def test_traces_recorded_and_printable(solved):
    fg, tree = solved
    traces = tree.traces
    assert len(traces) == tree.num_cliques()
    assert "up_done" in dbg.print_clique_history(traces)
    assert "cliq" in dbg.print_history_sequential(traces)
    one = dbg.print_clique_history(traces, cid=next(iter(traces)))
    assert one.count("clique ") == 1


def test_traces_capture_replay_inputs(solved):
    """CliqueTrace's child_msgs, down_msg and subfg (record_cliques)."""
    fg, tree = solved
    for cid, tr in tree.traces.items():
        cl = tree.clique(cid)
        assert isinstance(tr, CliqueTrace)
        assert tr.child_msgs is not None
        assert sorted(m.sender for m in tr.child_msgs) == sorted(cl.children)
        assert (tr.down_msg is None) == (cl.parent is None)
        if tr.subfg is not None:
            assert set(cl.all_vars) <= set(tr.subfg.ls())


def test_replay_clique_up(solved):
    fg, tree = solved
    # a clique with children (their captured messages feed the replay) and
    # a separator (so that its own message carries beliefs)
    target = next(c for c in tree.cliques.values()
                  if c.children and c.separator)
    msg = dbg.replay_clique_up(fg, tree, target.cid, tree.traces)
    assert set(msg.beliefs) == set(target.separator)
    for b in msg.beliefs.values():
        assert torch.isfinite(b.points).all()
    assert dbg.sandbox_state_machine_step is dbg.replay_clique_up
    with pytest.raises(ValueError, match="record_cliques"):
        dbg.replay_clique_up(fg, tree, target.cid, {})


def test_tree_to_dot_and_tex_match_jax(tmp_path):
    """The dot and TeX renderings of the same tree, text for text."""
    order = ["l1", "l2", "x1", "x2", "x3"]
    tree = it.build_tree(it.generate_kaess(device=CPU), order=order)
    tj = jl.build_tree(jl.canonical.generate_kaess(), order=order)
    dot = dbg.tree_to_dot(tree)
    assert dot == jdbg.tree_to_dot(tj)
    assert dot.startswith("digraph")
    assert dot.count("->") == tree.num_cliques() - len(tree.root_ids)
    tex = open(dbg.generate_tex_tree(tree, path=str(tmp_path / "p.tex"))).read()
    assert tex == open(jdbg.generate_tex_tree(
        tj, path=str(tmp_path / "j.tex"))).read()
    assert r"\begin{tikzpicture}" in tex and "$" in tex
    assert tex.count("->") == tree.num_cliques() - len(tree.root_ids)
    path = dbg.save_tree_dot(tree, str(tmp_path / "bt.dot"))
    assert open(path).read() == dot


def test_graph_to_dot_matches_jax(tmp_path):
    fg = it.generate_kaess(graphinit=True, device=CPU)
    gj = jl.canonical.generate_kaess(graphinit=True)
    dot = dbg.graph_to_dot(fg)
    assert dot == jdbg.graph_to_dot(gj)
    assert dot.startswith("graph FactorGraph")
    assert dot.count("--") == sum(len(fg.factor(f).variables)
                                  for f in fg.lsf())
    assert open(dbg.save_graph_dot(fg, str(tmp_path / "fg.dot"))).read() == \
        dot


def test_history_dump_written(tmp_path):
    fg = it.generate_kaess(graphinit=True, device=CPU)
    fg.params.record_cliques = True
    fg.params.logpath = str(tmp_path)
    it.solve_tree(fg)
    files = os.listdir(tmp_path)
    hist = [f for f in files if f.startswith("HistoryAll_")]
    assert hist == ["HistoryAll_0.txt"], files
    assert "up_done" in open(tmp_path / hist[0]).read()
    logdirs = sorted(os.listdir(tmp_path / "logs"))
    assert logdirs and all(d.startswith("cliq") for d in logdirs), logdirs
    cliqlog = open(tmp_path / "logs" / logdirs[0] / "log.txt").read()
    assert "# solve 0" in cliqlog and "up_done" in cliqlog
    it.solve_tree(fg)
    cliqlog = open(tmp_path / "logs" / logdirs[0] / "log.txt").read()
    assert "# solve 1" in cliqlog and "# solve 0" in cliqlog


def test_spy_clique_matrix(tmp_path):
    fg = it.generate_kaess(graphinit=True, device=CPU)
    tree = it.build_tree(fg)
    cid = next(iter(tree.cliques))
    out = tmp_path / "spy.png"
    dbg.spy_clique_matrix(fg, tree, cid, path=str(out))
    assert out.exists() and out.stat().st_size > 0


def test_animate_csm(tmp_path):
    fg = it.generate_kaess(graphinit=True, device=CPU)
    fg.params.record_cliques = True
    fg.params.logpath = str(tmp_path / "logs")
    tree = it.solve_tree(fg)
    out = tmp_path / "csm.gif"
    assert dbg.animate_csm(tree, tree.traces, path=str(out)) == str(out)
    assert out.exists() and out.stat().st_size > 100


def test_matplotlib_imported_only_by_the_plots():
    """import incrementalinference_torch.debugging needs no matplotlib: a
    fresh interpreter imports the package and the module without it."""
    import subprocess
    code = ("import sys, incrementalinference_torch, "
            "incrementalinference_torch.debugging; "
            "print('matplotlib' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_history_filters_and_summary(solved):
    fg, tree = solved
    traces = tree.traces
    cid = next(iter(traces))
    ev = dbg.cliq_hist_filter_transitions(traces[cid], "up_done")
    assert len(ev) == 1 and ev[0][1] == "up_done"
    arr = dbg.filter_hist_all_to_array(traces, "up_done")
    assert len(arr) == tree.num_cliques() and arr == sorted(arr)
    counts = dbg.hist_state_machine_transitions(traces)
    assert sum(counts.values()) > 0
    assert all(isinstance(k, tuple) and len(k) == 2 for k in counts)
    s = dbg.print_clique_summary(fg, tree, cid)
    assert f"clique {cid}" in s and "frontals" in s


def test_down_msgs_and_subfg_history(tmp_path):
    """tests/test_accessors.py:436-451."""
    fg = _chain(4, record=True)
    fg.params.logpath = str(tmp_path)
    tree = it.solve_tree(fg)
    root = tree.clique(tree.root_ids[0])
    sent = it.get_cliq_down_msgs_after_down_solve(tree, root.cid)
    assert set(sent) == set(root.children)
    leaf = [c for c in tree.cliques.values() if not c.children][0]
    sub = dbg.get_cliq_subgraph_from_history(tree.traces, leaf.cid)
    assert set(sub.ls()) == set(leaf.all_vars)
    assert dbg.get_graph_from_history is dbg.get_cliq_subgraph_from_history
    lanes = dbg.print_history_lanes(tree.traces)
    assert f"cliq{leaf.cid}" in lanes and "up_done" in lanes


def test_draw_tree_async_loop(tmp_path):
    tree = it.build_tree(it.generate_kaess(device=CPU))
    path = str(tmp_path / "live.dot")
    stop = dbg.draw_tree_async_loop(tree, path=path, rate_hz=50.0)
    import time
    deadline = time.time() + 10.0
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.02)
    stop()
    assert open(path).read() == dbg.tree_to_dot(tree)


# -- fault injection (tests/test_solve.py:98-105 and :316-333) --------------------

def test_skip_cliques_fault_injection(tmp_path):
    fg = _ring(logpath=str(tmp_path))
    tree0 = it.solve_tree(fg)
    some = list(tree0.cliques)[-1]
    before = {v: fg.points(v).clone() for v in tree0.clique(some).frontals}
    tree = it.solve_tree(fg, skip_cliques=[some])
    skipped = tree.cliques[some]
    assert skipped.status != CliqStatus.ERROR_STATUS
    # left untouched: its frontals keep their beliefs, its trace says why
    for v, p in before.items():
        assert torch.equal(fg.points(v), p), v
    steps = [s for _, s, _ in tree.traces[some].events]
    assert steps == ["skip"], steps
    others = [c for c in tree.cliques.values() if c.cid != some]
    assert all(c.status == CliqStatus.DOWNSOLVED for c in others)


def test_solve_timeout_floods_errors(tmp_path):
    fg = _ring(record=False)
    tree0 = it.solve_tree(fg)
    leafish = tree0.levels()[-1][0]
    with pytest.raises(RuntimeError, match="clique solves failed"):
        it.solve_tree(fg, timeout=0.4, delay_cliques={leafish: 1.0})
    tree = it.solve_tree(fg, timeout=120.0)
    assert all(c.status in (CliqStatus.DOWNSOLVED, CliqStatus.MARGINALIZED)
               for c in tree.cliques.values())


def test_timeout_marks_unreached_cliques(tmp_path):
    """An expired budget marks ERROR_STATUS each clique reached after it,
    and the error names a timeout."""
    fg = _ring(logpath=str(tmp_path))
    tree0 = it.solve_tree(fg)
    first = tree0.levels()[-1][0]
    with pytest.raises(RuntimeError) as exc:
        it.solve_tree(fg, timeout=0.2, delay_cliques={first: 0.5})
    assert isinstance(exc.value.__cause__, TimeoutError)


# -- warmup (api.warmup) ------------------------------------------------------------

@pytest.mark.parametrize("parametric", [False, True])
def test_warmup_on_cpu(parametric):
    """warmup solves the Kaess example (and its parametric form) on the
    device it is given; on the CPU nothing is built."""
    assert it.warmup(parametric=parametric, device=CPU) is None

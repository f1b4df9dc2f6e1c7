"""The multi-process tree solve in the port (parallel/multihost.py), held
against the JAX package's module and against the bars of
tests/test_multihost.py.

The partition, the codec's slot table and its packed bytes are compared
with the JAX package's on the same fixtures and on messages made from the
same numpy particles.  The cross-process tests launch two (or one) port
processes joined by gloo over loopback, each computing on the CPU
(``device="cpu"``), and hold them to the JAX tests' bars, with the port's
own single-process solve as the comparison; the JAX package's own
cross-process tests run in tests/test_multihost.py.

Every test stands alone: under pytest-xdist's ``--dist load`` one file's
tests run on several workers."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    jax_native_ordering, jax_native_ordering_available, rng, t)

import incrementalinference_torch as it
from incrementalinference.jl_tpu import beliefs as jbeliefs
from incrementalinference.jl_tpu.config import SolverParams as JParams
from incrementalinference.jl_tpu.parallel import messages as jmessages
from incrementalinference.jl_tpu.parallel import multihost as jmh
from incrementalinference.jl_tpu.tree import bayestree as jbt
from incrementalinference_torch.graphinit import ensure_solvable, init_all
from incrementalinference_torch.parallel import messages as tmessages
from incrementalinference_torch.parallel import multihost as mh
from incrementalinference_torch.parallel.multihost import (
    build_fixture, fixture_truth, launch_multihost, partition_tree,
    solve_tree_multihost, solve_tree_parametric_multihost)
from incrementalinference_torch.tree.bayestree import (CliqStatus,
                                                       build_tree_reset)

CPU = "cpu"


def _tree_for(name, scale):
    fg = build_fixture(name, scale, device=CPU)
    ensure_solvable(fg)
    init_all(fg)
    return fg, build_tree_reset(fg)


def _single_errs(name, scale):
    """The port's one-process solve of a fixture: |mean - truth| each."""
    fg = build_fixture(name, scale, device=CPU)
    solve_tree_multihost(fg)
    return [abs(float(fg.points(v)[:, 0].mean()) - mu)
            for v, mu in fixture_truth(name, scale).items()]


def _agree(reps, phase="warm"):
    """Every process ends with the same posterior (the sync phase)."""
    assert abs(reps[0][phase]["max_err"]
               - reps[1][phase]["max_err"]) < 1e-6
    for v, m in reps[0][phase]["means"].items():
        assert abs(m - reps[1][phase]["means"][v]) < 1e-6, v


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

def _by_frontals(tree):
    return {cid: frozenset(c.frontals) for cid, c in tree.cliques.items()}


def _partition_keyed(tree, part):
    f = _by_frontals(tree)
    return ({f[c]: p for c, p in part.owner.items()},
            {f[c] for c in part.top}, {f[c] for c in part.cut_roots},
            [{f[c] for c in cids} for cids in part.part_cliques])


@pytest.mark.parametrize("name,scale,n_parts", [
    ("anchored_forest", 6, 3), ("anchored_forest", 4, 2), ("chain", 12, 3),
    ("forest", 8, 4)])
def test_partition_matches_jax(name, scale, n_parts):
    """partition_tree gives the JAX function's owner, top, cut roots and
    parts on the same fixture (cliques keyed by their frontal sets)."""
    fg = build_fixture(name, scale,
                       params=it.SolverParams(N=64, graphinit=False),
                       device=CPU)
    jfg = jmh.build_fixture(name, scale,
                            params=JParams(N=64, graphinit=False))
    tree, jtree = build_tree_reset(fg), jbt.build_tree_reset(jfg)
    assert sorted(_by_frontals(tree).values(), key=sorted) == sorted(
        _by_frontals(jtree).values(), key=sorted)
    got = _partition_keyed(tree, partition_tree(tree, n_parts))
    want = _partition_keyed(jtree, jmh.partition_tree(jtree, n_parts))
    assert got == want


def test_partition_matches_jax_after_a_lost_native_load(monkeypatch):
    """A worker that found the JAX package's native library half-written
    by another worker remembers the failed load for good, and its chain-12
    tree (the Python heuristic's) then differs from the port's.  The
    helper forgets the failure and loads again, so the comparison holds."""
    import incrementalinference.jl_tpu.native as jn

    monkeypatch.setattr(jn, "_LIB", None)
    monkeypatch.setattr(jn, "_FAILED", True)
    assert jax_native_ordering_available()
    test_partition_matches_jax("chain", 12, 3)


_LAYOUTS = {"se2_chain": [(3, ["x1", "x2"]), (5, ["x4"])],
            "anchored_forest": [(1, ["anchor", "b0x0"]), (4, ["b1x1"])]}


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("name", ["se2_chain", "anchored_forest"])
def test_msg_flat_layout_matches_jax(name, joint):
    """The codec's slot table (names, byte offsets, shapes, f16 flags) and
    size equal the JAX package's, plain and with the joint slots."""
    fg = build_fixture(name, 6, params=it.SolverParams(N=64,
                                                       graphinit=False),
                       device=CPU)
    jfg = jmh.build_fixture(name, 6, params=JParams(N=64, graphinit=False))
    flat = mh._msg_flat_layout(fg, _LAYOUTS[name], joint=joint)
    jflat = jmh._msg_flat_layout(jfg, _LAYOUTS[name], joint=joint)
    assert flat.slots == jflat.slots and flat.size == jflat.size
    assert mh._joint_slot_plan(fg, ["x1", "x2"] if name == "se2_chain"
                               else ["anchor", "b0x0"]) == \
        jmh._joint_slot_plan(jfg, ["x1", "x2"] if name == "se2_chain"
                             else ["anchor", "b0x0"])


def _codec_case():
    """Two messages on an SE(2) fixture from numpy particles, in both
    packages: a solved one with a joint payload (a relative and a prior)
    and coordinates past the f16 range (the scale word), and a NO_INIT
    partial one."""
    r = rng(3)
    N = 64
    pts = {v: r.normal(size=(N, 3)).astype(np.float32)
           for v in ("x1", "x2", "x4")}
    pts["x2"][:, :2] *= 5e4                  # past _F16_SAFE_MAX
    bw = {v: (np.abs(r.normal(size=3)) + 0.1).astype(np.float32)
          for v in pts}
    ipc = {v: r.uniform(0.5, 2.0, size=3).astype(np.float32) for v in pts}
    diffs = r.normal(size=(N, 3)).astype(np.float32)
    dbw = np.full(3, 0.2, np.float32)
    dipc = np.ones(3, np.float32)

    def build(B, Msg, Joint, status, arr):
        def bel(v):
            return B(points=arr(pts[v]), bw=arr(bw[v]), ipc=arr(ipc[v]))
        solved = Msg(sender=3, status=status.UPSOLVED, has_priors=True)
        solved.beliefs["x1"], solved.beliefs["x2"] = bel("x1"), bel("x2")
        jm = Joint()
        jm.relatives.append(("x1", "x2", B(points=arr(diffs), bw=arr(dbw),
                                           ipc=arr(dipc))))
        jm.priors["x2"] = bel("x2")
        solved.jointmsg = jm
        partial = Msg(sender=5, status=status.NO_INIT)
        partial.beliefs["x4"] = bel("x4")
        return {3: solved, 5: partial}

    msgs = build(it.Belief, tmessages.LikelihoodMessage, tmessages.JointMsg,
                 CliqStatus, t)
    jmsgs = build(jbeliefs.Belief, jmessages.LikelihoodMessage,
                  jmessages.JointMsg, jbt.CliqStatus, jnp.asarray)
    layout = [(3, ["x1", "x2"]), (5, ["x4", "x5"])]
    return msgs, jmsgs, layout


def _codec_graphs():
    p = dict(N=64, graphinit=False)
    return (build_fixture("se2_chain", 6, params=it.SolverParams(**p),
                          device=CPU),
            jmh.build_fixture("se2_chain", 6, params=JParams(**p)))


def test_pack_msgs_byte_identical_to_jax():
    """The same messages pack into byte-identical buffers (scaled f16
    blocks and their scale words, presence flags, the joint slots)."""
    fg, jfg = _codec_graphs()
    msgs, jmsgs, layout = _codec_case()
    flat = mh._msg_flat_layout(fg, layout, joint=True)
    jflat = jmh._msg_flat_layout(jfg, layout, joint=True)
    buf = mh._pack_msgs(fg, layout, flat, msgs)
    jbuf = jmh._pack_msgs(jfg, layout, jflat, jmsgs)
    assert buf.dtype == np.uint8 and buf.shape == jbuf.shape
    np.testing.assert_array_equal(buf, jbuf)
    # the scale word of the block past the f16 range is not 1
    off = flat.slots[((3, "x2"), "points")][0]
    assert np.frombuffer(buf[off:off + 4].tobytes(), np.float32)[0] > 1.0


def _msg_arrays(m):
    out = {("status",): m.status.value, ("has_priors",): m.has_priors}
    for v, b in m.beliefs.items():
        for k, x in zip(("points", "bw", "ipc"), b):
            out[(v, k)] = np.asarray(x)
    if m.jointmsg is not None:
        for va, vb, b in m.jointmsg.relatives:
            for k, x in zip(("points", "bw", "ipc"), b):
                out[("rel", va, vb, k)] = np.asarray(x)
        for v, b in m.jointmsg.priors.items():
            for k, x in zip(("points", "bw", "ipc"), b):
                out[("pri", v, k)] = np.asarray(x)
    return out


@pytest.mark.parametrize("packed_by", ["port", "jax"])
def test_unpack_msgs_equals_jax(packed_by):
    """Either package's buffer unpacks to the same arrays in both,
    exactly; the port's beliefs are float32 tensors on the graph's
    device, the NO_INIT message keeps its missing belief missing."""
    fg, jfg = _codec_graphs()
    msgs, jmsgs, layout = _codec_case()
    flat = mh._msg_flat_layout(fg, layout, joint=True)
    jflat = jmh._msg_flat_layout(jfg, layout, joint=True)
    buf = (mh._pack_msgs(fg, layout, flat, msgs) if packed_by == "port"
           else jmh._pack_msgs(jfg, layout, jflat, jmsgs))
    owner = {3: 0, 5: 0}
    got = mh._unpack_msgs(fg, None, layout, flat, buf[None], owner)
    want = jmh._unpack_msgs(jfg, None, layout, jflat, buf[None], owner)
    assert set(got) == set(want) == {3, 5}
    for cid in (3, 5):
        g, w = _msg_arrays(got[cid]), _msg_arrays(want[cid])
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
    b = got[3].beliefs["x2"]
    assert b.points.dtype == torch.float32 and b.points.device == fg.device
    assert got[5].status == CliqStatus.NO_INIT
    assert set(got[5].beliefs) == {"x4"}


def test_chain_end_prior_init_passes_in_both_packages():
    """The distributed tree-init fixed point engages (≥ 2 passes) in the
    one-process solve of both packages, and both meet the bar."""
    truth = fixture_truth("chain_end_prior", 8)
    fg = build_fixture("chain_end_prior", 8, device=CPU)
    tm = {}
    solve_tree_multihost(fg, timings=tm)
    jfg = jmh.build_fixture("chain_end_prior", 8)
    jtm = {}
    jmh.solve_tree_multihost(jfg, timings=jtm)
    assert tm["init_passes"] >= 2 and jtm["init_passes"] >= 2
    for v, mu in truth.items():
        assert abs(float(fg.points(v)[:, 0].mean()) - mu) < 1.0, v
        assert abs(float(np.asarray(jfg.points(v))[:, 0].mean())
                   - mu) < 1.0, v


@pytest.mark.parametrize("graphinit", [False, True])
def test_parametric_multihost_agrees_with_jax(graphinit):
    """The one-process parametric multihost solve of the port agrees with
    the JAX package's to 1e-4 on the same graph (carried over by
    convert.py, beliefs included).

    Without beliefs both start from autoinit and land on the optimum.
    With graphinit's beliefs the JAX package's clique-wise solve stops
    short of it (the anchor 0.078 off on this fixture, inside its test's
    bar of 0.35) while its whole-graph solve and the port's clique-wise
    solve reach it: there the port is held to the JAX whole-graph solve
    to 1e-4 and the JAX clique-wise solve to its own bar."""
    import incrementalinference.jl_tpu as jl
    from torch_port_helpers import jax_graph_to_arrays

    def jfixture():
        return jmh.build_fixture("anchored_forest", 4,
                                 params=JParams(N=64, graphinit=graphinit))

    jfg = jfixture()
    fg = it.graph_from_arrays(jax_graph_to_arrays(jfg), device=CPU)
    solve_tree_parametric_multihost(fg)
    jmh.solve_tree_parametric_multihost(jfg)
    ref = jfixture()
    jl.solve_graph_parametric(ref)
    for v in fg.ls():
        got = fg.var(v).parametric_point.numpy()
        if not graphinit:
            np.testing.assert_allclose(
                got, np.asarray(jfg.var(v).parametric_point), atol=1e-4,
                err_msg=v)
        np.testing.assert_allclose(
            got, np.asarray(ref.var(v).parametric_point), atol=1e-4,
            err_msg=v)
        assert np.abs(np.asarray(jfg.var(v).parametric_point)
                      - np.asarray(ref.var(v).parametric_point)).max() \
            < 0.35, v


@pytest.mark.parametrize("name", list(mh._FIXTURES))
def test_fixture_truth_equals_jax(name):
    """Equal, key for key; the SE(2) positions are float32 compositions of
    sin and cos, whose torch and XLA forms may differ in the last bit."""
    got, want = fixture_truth(name, 6), jmh.fixture_truth(name, 6)
    assert got.keys() == want.keys()
    for v in got:
        if name == "se2_chain":
            assert got[v].dtype == np.float32
            np.testing.assert_allclose(got[v], np.asarray(want[v]),
                                       rtol=1e-6, atol=0, err_msg=v)
        else:
            assert got[v] == want[v], v


@pytest.mark.parametrize("name", list(mh._FIXTURES))
def test_fixtures_match_jax(name):
    """Each fixture has the JAX one's variables (manifold, N) and
    factors."""
    fg = build_fixture(name, 4, params=it.SolverParams(N=64,
                                                       graphinit=False),
                       device=CPU)
    jfg = jmh.build_fixture(name, 4, params=JParams(N=64, graphinit=False))
    assert fg.ls() == jfg.ls()
    for v in fg.ls():
        assert fg.var(v).N == jfg.var(v).N
        assert (fg.var(v).manifold.dof, fg.var(v).manifold.point_dim) == (
            jfg.var(v).manifold.dof, jfg.var(v).manifold.point_dim)
    assert [(f.variables, type(f.model).__name__, f.multihypo)
            for f in fg.factors.values()] == \
        [(f.variables, type(f.model).__name__, f.multihypo)
         for f in jfg.factors.values()]


@pytest.mark.parametrize("k", [1, 1024, 50_000])
def test_categorical_cdf_never_scans_a_whole_tensor(monkeypatch, k):
    """keys.categorical's CDF never asks for a scan over all of a tensor's
    elements: on CUDA that is one CUB scan whose carries between tiles
    follow their timing, so two processes solving the same top could draw
    different components.  A scan within rows, or down the rows, is a
    kernel of fixed order."""
    from incrementalinference_torch import keys

    scans = []
    cumsum = torch.cumsum

    def spy(x, dim, *args, **kw):
        scans.append((x.numel(), x.shape[dim]))
        return cumsum(x, dim, *args, **kw)

    monkeypatch.setattr(torch, "cumsum", spy)
    keys.categorical(keys.make_key(11, 3), t(rng(5).normal(size=k)), 64)
    assert scans
    assert all(numel != size for numel, size in scans), scans


@pytest.mark.parametrize("k", [1, 2, 1023, 1024, 1025, 50_000])
def test_categorical_cdf_is_the_running_sum(k):
    """keys.cdf is the running sum of the probabilities (to float32's
    rounding of a 50k-term sum), never decreases and ends at their total;
    the draws are the inverse CDF of one uniform each."""
    from incrementalinference_torch import keys

    logits = t(rng(k).normal(size=k) * 3.0)
    p = torch.softmax(logits, dim=0)
    c = keys.cdf(p)
    assert c.shape == (k,) and c.dtype == p.dtype
    np.testing.assert_allclose(c.double().numpy(),
                               np.cumsum(p.double().numpy()), atol=1e-6)
    assert bool((c[1:] >= c[:-1]).all())
    key = keys.make_key(11, 3)
    u = torch.rand(4096, generator=keys.generator(key, CPU)) * c[-1]
    want = torch.searchsorted(c, u, right=True).clamp_(max=k - 1)
    assert torch.equal(keys.categorical(key, logits, 4096), want)


# --------------------------------------------------------------------------
# the port's counterparts of tests/test_multihost.py
# --------------------------------------------------------------------------

class TestPartition:
    def test_partition_covers_tree_once(self):
        fg, tree = _tree_for("anchored_forest", 6)
        part = partition_tree(tree, 3)
        owned = [c for p in part.part_cliques for c in p]
        assert sorted(owned + part.top) == sorted(tree.cliques)
        assert len(set(owned)) == len(owned)

    def test_parts_are_connected_subtrees(self):
        fg, tree = _tree_for("anchored_forest", 6)
        part = partition_tree(tree, 3)
        for p, cids in enumerate(part.part_cliques):
            cidset = set(cids)
            roots = [c for c in cids
                     if tree.clique(c).parent not in cidset]
            for c in cids:
                if c not in roots:
                    assert tree.clique(c).parent in cidset

    def test_cut_roots_have_top_parents(self):
        fg, tree = _tree_for("anchored_forest", 6)
        part = partition_tree(tree, 3)
        top = set(part.top)
        for c in part.cut_roots:
            assert tree.clique(c).parent in top

    def test_forest_partition_has_no_top(self):
        fg, tree = _tree_for("forest", 8)
        part = partition_tree(tree, 4)
        assert part.top == []
        assert part.cut_roots == []

    def test_partition_deterministic(self):
        fg, tree = _tree_for("chain", 12)
        a = partition_tree(tree, 3)
        b = partition_tree(tree, 3)
        assert a.owner == b.owner and a.top == b.top

    def test_single_part_owns_everything(self):
        fg, tree = _tree_for("chain", 8)
        part = partition_tree(tree, 1)
        assert part.top == [] and len(part.part_cliques[0]) == \
            tree.num_cliques()

    def test_balance(self):
        fg, tree = _tree_for("forest", 8)
        part = partition_tree(tree, 4)
        sizes = [len(p) for p in part.part_cliques]
        assert max(sizes) - min(sizes) <= max(2, max(sizes) // 2)


class TestSingleProcessDegenerate:
    @pytest.mark.parametrize("name,scale", [("anchored_forest", 4),
                                            ("chain", 8)])
    def test_posterior_quality(self, name, scale):
        fg = build_fixture(name, scale, device=CPU)
        tm = {}
        solve_tree_multihost(fg, timings=tm)
        for v, mu in fixture_truth(name, scale).items():
            pts = fg.points(v)[:, 0]
            assert abs(float(pts.mean()) - mu) < 1.0, (v, float(pts.mean()))
        assert tm["exchange_up_s"] == 0.0 or tm["exchange_up_s"] < 0.5


class TestMessageCodec:
    def test_flat_pack_unpack_roundtrip_se2(self):
        se2 = it.SE2()
        pose2 = it.VariableType("Pose2", se2)
        fg = it.initfg(device=CPU)
        fg.add_variable("p0", pose2)
        fg.add_factor(["p0"], it.ManifoldPrior(
            se2, torch.zeros(3), it.MvNormal([0.0] * 3, [0.1] * 3)))
        fg.add_variable("p1", pose2)
        fg.add_factor(["p0", "p1"], it.ManifoldFactor(
            se2, it.MvNormal([1.0, 0.0, 0.2], [0.1] * 3)))

        msg = tmessages.LikelihoodMessage(sender=7,
                                          status=CliqStatus.UPSOLVED,
                                          has_priors=True)
        msg.beliefs["p0"] = fg.get_belief("p0")
        layout = [(7, ["p0"])]
        flat = mh._msg_flat_layout(fg, layout)
        buf = mh._pack_msgs(fg, layout, flat, {7: msg})
        out = mh._unpack_msgs(fg, None, layout, flat, buf[None, :], {7: 0})
        m2 = out[7]
        assert m2.status == CliqStatus.UPSOLVED and m2.has_priors
        np.testing.assert_allclose(m2.beliefs["p0"].points.numpy(),
                                   msg.beliefs["p0"].points.numpy(),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(m2.beliefs["p0"].bw.numpy(),
                                      msg.beliefs["p0"].bw.numpy())

    def test_flat_codec_partial_beliefs(self):
        fg = it.initfg(device=CPU)
        fg.add_variable("a", it.ContinuousScalar)
        fg.add_variable("b", it.ContinuousScalar)
        fg.add_factor(["a"], it.Prior(it.Normal(1.0, 0.5)))

        msg = tmessages.LikelihoodMessage(sender=3, status=CliqStatus.NO_INIT)
        msg.beliefs["a"] = fg.get_belief("a")
        layout = [(3, ["a", "b"])]
        flat = mh._msg_flat_layout(fg, layout)
        buf = mh._pack_msgs(fg, layout, flat, {3: msg})
        out = mh._unpack_msgs(fg, None, layout, flat, buf[None, :], {3: 0})
        assert out[3].status == CliqStatus.NO_INIT
        assert "a" in out[3].beliefs and "b" not in out[3].beliefs

    def test_flat_codec_joint_payload_roundtrip(self):
        fg = it.initfg(device=CPU)
        for v in ("a", "b"):
            fg.add_variable(v, it.ContinuousScalar)
        fg.add_factor(["a"], it.Prior(it.Normal(0.0, 1.0)))
        fg.add_factor(["a", "b"], it.LinearRelative(it.Normal(1.0, 0.5)))

        msg = tmessages.LikelihoodMessage(sender=5,
                                          status=CliqStatus.UPSOLVED,
                                          has_priors=True)
        msg.beliefs["a"] = fg.get_belief("a")
        msg.beliefs["b"] = fg.get_belief("b")
        jm = tmessages.JointMsg()
        diffs = torch.linspace(-1.0, 1.0, fg.var("a").N)[:, None]
        jm.relatives.append(("a", "b", it.make_belief(it.Euclidean(1),
                                                      diffs)))
        jm.priors["a"] = fg.get_belief("a")
        msg.jointmsg = jm

        layout = [(5, ["a", "b"])]
        flat = mh._msg_flat_layout(fg, layout, joint=True)
        buf = mh._pack_msgs(fg, layout, flat, {5: msg})
        out = mh._unpack_msgs(fg, None, layout, flat, buf[None, :], {5: 0})
        jm2 = out[5].jointmsg
        assert jm2 is not None
        assert len(jm2.relatives) == 1 and list(jm2.priors) == ["a"]
        va, vb, rb = jm2.relatives[0]
        assert (va, vb) == ("a", "b")
        np.testing.assert_allclose(rb.points.numpy(), diffs.numpy(),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(jm2.priors["a"].points.numpy(),
                                   jm.priors["a"].points.numpy(),
                                   rtol=1e-3, atol=1e-3)

    def test_flat_codec_no_joint_when_disabled(self):
        fg = it.initfg(device=CPU)
        fg.add_variable("a", it.ContinuousScalar)
        fg.add_factor(["a"], it.Prior(it.Normal(0.0, 1.0)))
        layout = [(1, ["a"])]
        plain = mh._msg_flat_layout(fg, layout)
        joint = mh._msg_flat_layout(fg, layout, joint=True)
        assert joint.size > plain.size


class TestCrossProcess:
    def test_two_process_anchored_forest_parity(self):
        reps = launch_multihost(2, "anchored_forest", scale=6,
                                devices_per_proc=2, timeout=300,
                                device=CPU)
        assert len(reps) == 2
        bar = max(1.0, 3.0 * max(_single_errs("anchored_forest", 6)))
        for r in reps:
            assert r["devices"] == 4          # 2 procs x 2 devices
            assert r["device"] == CPU
            for phase in ("cold", "warm"):
                assert r[phase]["max_err"] < bar, (r["pid"], phase,
                                                   r[phase]["max_err"])
            tm = r["warm"]["timings"]
            assert tm["bytes_cut"] > 0 and tm["bytes_sync"] > 0
            assert r["warm"]["collectives"]["count"] >= 4
            assert set(tm["kernel_launches"]) == {"local_up", "top",
                                                  "local_down"}
        _agree(reps)

    def test_parametric_multihost_matches_tree_solver(self):
        """One-process parametric multihost reproduces the port's
        clique-wise parametric tree solve bit for bit."""
        fg_a = build_fixture("anchored_forest", 4, device=CPU)
        it.solve_tree(fg_a, algorithm="parametric")
        fg_b = build_fixture("anchored_forest", 4, device=CPU)
        solve_tree_parametric_multihost(fg_b)
        for v in fg_a.ls():
            np.testing.assert_array_equal(
                fg_a.var(v).parametric_point.numpy(),
                fg_b.var(v).parametric_point.numpy())

    def test_two_process_parametric(self):
        reps = launch_multihost(2, "anchored_forest", scale=6,
                                devices_per_proc=1, timeout=300,
                                algorithm="parametric", device=CPU)
        for r in reps:
            assert r["warm"]["max_err"] < 0.35, r["warm"]["max_err"]
        _agree(reps)

    @pytest.mark.parametrize("grow", [2, 3])
    def test_two_process_incremental_recycling(self, grow):
        reps = launch_multihost(2, "anchored_forest", scale=6,
                                devices_per_proc=1, timeout=300, grow=grow,
                                device=CPU)
        for r in reps:
            assert "incr" in r
            assert r["incr"]["n_recycled"] >= 3, r["incr"]
            assert r["incr"]["max_err"] < 1.5, r["incr"]["max_err"]
        _agree(reps, "incr")

    def test_two_process_chain_exchange(self):
        reps = launch_multihost(2, "chain", scale=10, devices_per_proc=1,
                                timeout=300, device=CPU)
        for r in reps:
            assert r["warm"]["max_err"] < 1.2, r["warm"]["max_err"]
        _agree(reps)


class TestDistributedTreeInit:
    def test_single_process_chain_end_prior(self):
        fg = build_fixture("chain_end_prior", 8, device=CPU)
        assert not any(fg.var(v).is_initialized() for v in fg.ls())
        tm = {}
        solve_tree_multihost(fg, timings=tm)
        assert tm["init_passes"] >= 2
        for v, mu in fixture_truth("chain_end_prior", 8).items():
            assert abs(float(fg.points(v)[:, 0].mean()) - mu) < 1.0, v

    def test_two_process_cross_cut_down_init(self):
        reps = launch_multihost(2, "chain_end_prior", scale=10,
                                devices_per_proc=1, timeout=300, device=CPU)
        single = max(_single_errs("chain_end_prior", 10))
        for r in reps:
            assert r["warm"]["timings"]["init_passes"] >= 2
            assert r["warm"]["max_err"] < max(1.0, 3.0 * single), r["warm"]
        _agree(reps)

    def test_two_process_noinit_forest_both_sides(self):
        reps = launch_multihost(2, "anchored_forest_noinit", scale=6,
                                devices_per_proc=1, timeout=300, device=CPU)
        for r in reps:
            assert r["warm"]["timings"]["init_passes"] >= 2
            assert r["warm"]["timings"]["local_cliques"] > 0
            assert r["warm"]["max_err"] < 1.0, r["warm"]["max_err"]
        _agree(reps)


class TestReferenceParityWorkloads:
    def test_two_process_multihypo(self):
        reps = launch_multihost(2, "multihypo_forest", scale=4,
                                devices_per_proc=1, timeout=300, device=CPU)
        for r in reps:
            assert r["warm"]["max_err"] < 1.5, r["warm"]["max_err"]
        _agree(reps)

    def test_two_process_joint_up_messages(self):
        reps = launch_multihost(2, "anchored_forest", scale=6,
                                devices_per_proc=1, timeout=300,
                                use_joint=True, device=CPU)
        for r in reps:
            assert r["warm"]["max_err"] < 1.0, r["warm"]["max_err"]
        _agree(reps)

    def test_two_process_fourdoor_sequence(self):
        reps = launch_multihost(2, "fourdoor", devices_per_proc=1,
                                timeout=300, device=CPU)
        f0, f1 = reps[0]["fourdoor"], reps[1]["fourdoor"]
        for k in ("x1_0", "x2_50", "x3_100", "x4_300"):
            assert f0[k] >= 0.8, (k, f0[k])
            assert abs(f0[k] - f1[k]) < 1e-9
        for v, c in (("x1", 0.0), ("x2", 50.0), ("x3", 100.0),
                     ("x4", 300.0)):
            assert abs(f0["means"][v] - c) < 10.0, (v, f0["means"][v])
            assert abs(f0["means"][v] - f1["means"][v]) < 1e-6


class TestFaultFlooding:
    def test_two_process_error_floods(self):
        fg, tree = _tree_for("anchored_forest", 6)
        part = partition_tree(tree, 2)
        victim = next(c for c in part.cut_roots if part.owner[c] == 0)

        t0 = time.time()
        reps = launch_multihost(2, "anchored_forest", scale=6,
                                devices_per_proc=1, timeout=200,
                                fail_clique=victim, device=CPU)
        wall = time.time() - t0
        outcomes = {r["pid"]: r["fault"] for r in reps}
        assert outcomes[0]["outcome"] == "error"
        assert "injected" in outcomes[0]["message"] \
            or "failed on this process" in outcomes[0]["message"]
        assert outcomes[1]["outcome"] == "error"      # flooded, not hung
        assert wall < 200, wall

    def test_single_process_fault_hook(self):
        fg = build_fixture("chain", 6, device=CPU)
        with pytest.raises(RuntimeError):
            solve_tree_multihost(fg, fail_cliques={1})


class TestSE2Distributed:
    def test_two_process_se2_chain(self):
        # the longest launch of the file (~90 s alone: host time of the
        # manifold factors' Gauss-Newton), so the widest timeout
        reps = launch_multihost(2, "se2_chain", scale=8,
                                devices_per_proc=1, timeout=600, device=CPU)
        for r in reps:
            assert r["warm"]["max_err"] < 0.8, r["warm"]["max_err"]
        _agree(reps)


class TestProcessDeviceComposition:
    def test_two_process_two_device_mesh_parity(self):
        reps = launch_multihost(2, "anchored_forest", scale=6,
                                devices_per_proc=2, timeout=300, mesh=True,
                                device=CPU)
        assert len(reps) == 2
        bar = max(1.0, 3.0 * max(_single_errs("anchored_forest", 6)))
        for r in reps:
            assert r["mesh_devices"] == 2
            assert r["devices"] == 4
            for phase in ("cold", "warm"):
                assert r[phase]["max_err"] < bar, (r["pid"], phase,
                                                   r[phase]["max_err"])
        _agree(reps)

    def test_two_process_four_device_mesh_wide_forest(self):
        reps = launch_multihost(2, "forest", scale=8, devices_per_proc=4,
                                timeout=300, mesh=True, batch_min_width=3,
                                device=CPU)
        fg = build_fixture("forest", 8, device=CPU)
        solve_tree_multihost(fg)
        single_errs = [abs(float(fg.points(v)[:, 0].mean()) - mu)
                       for v, mu in fixture_truth("forest", 8).items()]
        bar = max(1.0, 3.0 * max(single_errs))
        for r in reps:
            assert r["mesh_devices"] == 4
            for phase in ("cold", "warm"):
                assert r[phase]["max_err"] < bar, (r["pid"], phase,
                                                   r[phase]["max_err"])
        _agree(reps)


def test_launch_reports_a_failed_child():
    """A child that cannot run (an unknown fixture) fails the launch with
    its output, and the launcher leaves no child behind."""
    with pytest.raises(RuntimeError, match="unknown fixture"):
        launch_multihost(2, "no_such_fixture", devices_per_proc=1,
                         timeout=60, device=CPU)

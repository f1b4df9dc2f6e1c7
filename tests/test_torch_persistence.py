"""Persistence in the port on the CPU: the cases of
tests/test_serialization.py (all but the warm-start pack),
tests/test_graph_packing_converters.py, tests/test_saveconverter_types.py,
tests/test_dfg_import.py and the save/load halves of
tests/test_extensions.py on the port, and the two packages' files against
each other.

The cross-format cases build one graph with every packable model kind from
one numpy seed in both packages.  Its packed documents must be equal key
for key, a file saved by either package must load in the other with every
belief bit-equal (float32 written as a JSON double reads back exactly), and
the saveDFG archives of the two must be equal file for file."""

import json
import os
import tarfile

import numpy as np
import pytest
import torch

from torch_port_helpers import rng, scaled

import jax
import jax.numpy as jnp

import incrementalinference.jl_tpu as jl
import incrementalinference_torch as it
from incrementalinference.jl_tpu import serialization as jser
from incrementalinference.jl_tpu.beliefs import Belief as JBelief
from incrementalinference_torch import serialization as ser
from incrementalinference_torch.beliefs import Belief, LazyPPE, make_belief
from incrementalinference_torch.convert import ensemble_params_from
from incrementalinference_torch.manifolds import Circle, Euclidean, Product
from incrementalinference_torch.serialization.packed import (
    _fn_name, pack_belief, pack_distribution, pack_factor_model,
    pack_manifold, unpack_belief, unpack_distribution, unpack_factor_model,
    unpack_manifold)
from incrementalinference_torch.utils.compare import (compare_beliefs,
                                                      compare_variables)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "dfg_archive")
CPU = "cpu"


def _doc(d):
    """A packed structure as JSON reads it back (tuples become lists)."""
    return json.loads(json.dumps(d))


# -- a custom factor model with an aux field, registered in both packages ----

class _JaxScaledRelative(jl.FactorModel):
    """x2 = x1 + scale * z: ``Z`` a child, ``scale`` static (aux)."""

    def __init__(self, Z, scale):
        self.Z = Z
        self.scale = scale

    @property
    def zdim(self):
        return 1

    def sample(self, key, n):
        return self.Z.sample(key, n)

    def residual(self, meas, x1, x2):
        return x2 - (x1 + self.scale * meas)

    def mean_cov(self):
        return self.Z.mean_cov()


class _PortScaledRelative(it.FactorModel):
    """The port's twin of :class:`_JaxScaledRelative`."""

    def __init__(self, Z, scale):
        self.Z = Z
        self.scale = scale

    @property
    def zdim(self):
        return 1

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, x1, x2):
        return x2 - (x1 + scaled(meas, self.scale))

    def mean_cov(self):
        return self.Z.mean_cov()


# both registries are keyed by class name: the file names one type
_JaxScaledRelative.__name__ = _PortScaledRelative.__name__ = "ScaledRelative"
jl.register_factor_model(_JaxScaledRelative, children=("Z",), aux=("scale",))
it.register_factor_model(_PortScaledRelative, children=("Z",),
                         aux=("scale",))


def _jax_forced(t, x, u):
    return -0.5 * x + jnp.interp(t, u[0], u[1])


def _port_forced(t, x, u):
    return scaled(x, -0.5) + u[1, 0]


jser.register_fn("zoo_forced", _jax_forced)
ser.register_fn("zoo_forced", _port_forced)

_SPEC = (("conv2d", 1, 2, 3), ("relu",), ("maxpool2d", 2), ("flatten",),
         ("dense", 2 * 4 * 4, 1))


def _zoo_arrays(seed=3, n=16):
    """Every array the zoo graph holds, from one numpy seed."""
    g = rng(seed)
    f32 = np.float32
    a = {"n": n}
    a["x0"] = g.normal(0.0, 3.0, (n, 1)).astype(f32)
    a["x1"] = g.normal(10.0, 1.0, (n, 1)).astype(f32)
    a["k"] = g.normal(1.0, 0.1, (n, 1)).astype(f32)
    a["l"] = g.normal(3.0, 1.0, (n, 2)).astype(f32)
    for v, dim in (("p2", 3), ("p2b", 3)):
        a[v] = g.normal(0.0, 0.3, (n, dim)).astype(f32)
    for v in ("p3", "p3b"):
        q = g.normal(0.0, 1.0, (n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        a[v] = np.concatenate([g.normal(0, 1, (n, 3)), q], 1).astype(f32)
    a["bw"] = {v: g.uniform(0.1, 0.5, (a[v].shape[1] if v[0] != "p"
                                       else 3 + 3 * (v[1] == "3"),)).astype(f32)
               for v in ("x0", "x1", "k", "l", "p2", "p2b", "p3", "p3b")}
    a["ipc"] = {v: np.ones_like(b) for v, b in a["bw"].items()}
    a["ipc"]["l"] = np.array([1.0, 0.0], f32)
    a["msg"] = g.normal(9.0, 1.0, (n, 1)).astype(f32)
    a["mkd"] = g.normal(-4.0, 1.0, (24, 1)).astype(f32)
    a["grid"] = g.uniform(0.0, 1.0, (8, 8)).astype(f32)
    a["xs"] = np.linspace(0.0, 10.0, 8, dtype=f32)
    a["ys"] = np.linspace(-5.0, 5.0, 8, dtype=f32)
    a["W_conv"] = g.normal(0, 0.3, (4, 3, 3, 1, 2)).astype(f32)   # HWIO
    a["b_conv"] = g.normal(0, 0.1, (4, 2)).astype(f32)
    a["W_dense"] = g.normal(0, 0.3, (4, 1, 32)).astype(f32)
    a["b_dense"] = g.normal(0, 0.1, (4, 1)).astype(f32)
    a["img"] = g.uniform(0, 1, (8, 8, 1)).astype(f32)
    a["u"] = np.stack([np.linspace(0, 1, 5), np.ones(5)]).astype(f32)
    a["p0"] = np.array([1.0, -2.0, 0.3], f32)
    return a


def _zoo(pkg, a, ts=1.7e9):
    """The graph with every packable model kind, built in ``pkg`` (the JAX
    package or the port) from the arrays ``a``; timestamps fixed."""
    port = pkg is it
    arr = (lambda x: torch.tensor(x)) if port else jnp.asarray
    se2, se3 = pkg.SE2(), pkg.SE3()
    params = pkg.SolverParams(N=a["n"], graphinit=False, logpath="zoo-logs")
    fg = pkg.initfg(params, device=CPU) if port else pkg.initfg(params)
    vts = {"x0": pkg.ContinuousScalar, "x1": pkg.ContinuousScalar,
           "k": pkg.ContinuousScalar, "l": pkg.ContinuousEuclid(2),
           "p2": pkg.VariableType("Pose2", se2),
           "p2b": pkg.VariableType("Pose2", se2),
           "p3": pkg.VariableType("Pose3", se3),
           "p3b": pkg.VariableType("Pose3", se3)}
    for v, vt in vts.items():
        fg.add_variable(v, vt, tags=("ZOO",) if v[0] == "p" else ())
        fg.set_belief(v, arr(a[v]), bw=arr(a["bw"][v]),
                      ipc=arr(a["ipc"][v]))
    if port:
        flux_params = ensemble_params_from([(a["W_conv"], a["b_conv"]),
                                            (a["W_dense"], a["b_dense"])])
        msg = Belief(torch.tensor(a["msg"]), torch.tensor([0.7]),
                     torch.tensor([1.0]))
        fn = _port_forced
    else:
        flux_params = [(jnp.asarray(a["W_conv"]), jnp.asarray(a["b_conv"])),
                       (jnp.asarray(a["W_dense"]), jnp.asarray(a["b_dense"]))]
        msg = JBelief(jnp.asarray(a["msg"]), jnp.asarray([0.7]),
                      jnp.asarray([1.0]))
        fn = _jax_forced
    nn = pkg.FluxModelsDistribution(pkg.SequentialNet(_SPEC), flux_params,
                                    arr(a["img"]), out_dim=1)
    heat = pkg.HeatmapGridDensity(a["grid"], (a["xs"], a["ys"]))
    level = pkg.LevelSetGridNormal(a["grid"], (a["xs"], a["ys"]),
                                   level=0.5, sigma=0.2)
    add = fg.add_factor
    add(["x0"], pkg.Mixture(pkg.Prior, [pkg.Normal(-5.0, 1.0),
                                        pkg.Uniform(2.0, 6.0),
                                        pkg.AliasingScalarSampler(
                                            [0.0, 1.0, 2.0], [0.2, 0.3, 0.5])],
                            [0.2, 0.3, 0.5]))
    # a KDE's bandwidth given: the two packages' LOO selections differ in
    # the last bit, which is not what this graph compares
    add(["x0"], pkg.Prior(pkg.manikde(pkg.ContinuousScalar, arr(a["mkd"]),
                                      bw=arr(a["bw"]["x0"]))))
    add(["x0"], pkg.MetaPrior({"note": "calibration", "rev": 2}))
    add(["x0", "x1"], pkg.MixtureFluxModels(pkg.LinearRelative, nn,
                                            [pkg.Normal(10.0, 1.0)],
                                            [0.5, 0.5]))
    add(["x0", "x1"], pkg.DERelative(fn, 0.0, 1.0,
                                     pkg.MvNormal([0.0], [0.1]), dim=1,
                                     steps=4, data=arr(a["u"])))
    add(["x1"], pkg.MsgPrior(msg, pkg.Euclidean(1)))
    add(["x1"], pkg.Prior(pkg.Rayleigh(2.0)), multihypo=None)
    add(["x1", "k"], _PortScaledRelative(pkg.Normal(1.0, 0.1), 2.5) if port
        else _JaxScaledRelative(pkg.Normal(1.0, 0.1), 2.5))
    add(["l"], pkg.PartialPrior(pkg.Normal(3.0, 0.5), (0,)))
    add(["l"], pkg.Prior(heat))
    add(["l"], pkg.PartialPriorPassThrough(level, (0, 1)))
    add(["l"], pkg.Prior(pkg.MvNormal([3.0, -2.0], [[0.25, 0.1],
                                                     [0.1, 0.5]])))
    add(["p2"], pkg.ManifoldPrior(se2, a["p0"],
                                  pkg.MvNormal([0.0] * 3, [0.1, 0.1, 0.05])))
    add(["p2", "p2b"], pkg.ManifoldFactor(
        se2, pkg.MvNormal([1.0, 0.0, 0.2], [0.3, 0.3, 0.05])))
    add(["p3"], pkg.ManifoldPrior(se3, se3.identity() if not port
                                  else se3.identity().numpy(),
                                  pkg.MvNormal([0.0] * 6, [0.1] * 6)))
    add(["p3", "p3b"], pkg.ManifoldFactor(
        se3, pkg.MvNormal([1.0, 0, 0, 0, 0, 0.1], [0.2] * 6)))
    add(["x0", "k"], pkg.EuclidDistance(pkg.Normal(5.0, 1.0)),
        multihypo=[1.0, 0.5], nullhypo=0.1, tags=("RANGE",))
    for f in fg.factors.values():
        f.timestamp = ts
    for v in fg.variables.values():
        v.timestamp = ts + 1.0
    return fg


@pytest.fixture(scope="module")
def zoo():
    a = _zoo_arrays()
    return _zoo(jl, a), _zoo(it, a)


def _points(fg, v, port):
    b = fg.get_belief(v)
    return [np.asarray(x.numpy() if port else x) for x in b]


def _assert_beliefs_bit_equal(gj, gp):
    for v in gj.ls():
        for a, b in zip(_points(gj, v, False), _points(gp, v, True)):
            assert a.dtype == b.dtype == np.float32, v
            np.testing.assert_array_equal(a, b, err_msg=v)


# -- cross-format: the core ----------------------------------------------------

def test_zoo_documents_equal(tmp_path, zoo):
    """save_graph of the same graph writes the same document in both
    packages: every key, _type name, array layout and value."""
    gj, gp = zoo
    dj = json.load(open(jser.save_graph(gj, str(tmp_path / "j.json"))))
    dp = json.load(open(ser.save_graph(gp, str(tmp_path / "p.json"))))
    kinds = {f["model"]["_type"] for f in dp["factors"]}
    assert kinds >= {"Mixture", "Prior", "MetaPrior", "DERelative",
                     "MsgPrior", "Custom:ScaledRelative", "PartialPrior",
                     "PartialPriorPassThrough", "ManifoldPrior",
                     "ManifoldFactor", "EuclidDistance"}, kinds
    assert dj == dp


@pytest.mark.parametrize("kind", ["factor", "distribution"])
def test_zoo_pack_structurally_equal(zoo, kind):
    """pack_factor_model of each factor, and pack_distribution of each
    measurement distribution, equal key for key across the packages."""
    gj, gp = zoo
    for fl in gj.lsf():
        mj, mp = gj.factor(fl).model, gp.factor(fl).model
        if kind == "factor":
            assert _doc(jser.pack_factor_model(mj)) == \
                _doc(pack_factor_model(mp)), fl
            continue
        zs = [(z, w) for z, w in zip(getattr(mj, "components", ()),
                                     getattr(mp, "components", ()))]
        if hasattr(mj, "Z"):
            zs.append((mj.Z, mp.Z))
        for zj, zp in zs:
            assert _doc(jser.pack_distribution(zj)) == \
                _doc(pack_distribution(zp)), fl


def test_jax_saved_graph_loads_in_port(tmp_path, zoo):
    gj, gp = zoo
    path = jser.save_graph(gj, str(tmp_path / "jax.json"))
    g2 = ser.load_graph(path, device=CPU)
    assert g2.ls() == gj.ls() and g2.lsf() == gj.lsf()
    _assert_beliefs_bit_equal(gj, g2)
    for fl in gj.lsf():
        assert _doc(pack_factor_model(g2.factor(fl).model)) == \
            _doc(jser.pack_factor_model(gj.factor(fl).model)), fl
        assert g2.factor(fl).multihypo == gj.factor(fl).multihypo
        assert g2.factor(fl).tags == gj.factor(fl).tags
    m = next(g2.factor(fl).model for fl in g2.lsf()
             if type(g2.factor(fl).model).__name__ == "ScaledRelative")
    assert type(m) is _PortScaledRelative and m.scale == 2.5
    # the loaded models compute: the network ensemble against the original
    # (conv weights carried HWIO -> OIHW), the ODE flow against JAX's
    nn2 = g2.factor("x0x1f4").model.components[0]
    nn = gp.factor("x0x1f4").model.components[0]
    torch.testing.assert_close(nn2.all_outputs(CPU), nn.all_outputs(CPU),
                               rtol=0, atol=0)
    de2 = g2.factor("x0x1f5").model
    assert de2.data.dtype == np.float32
    np.testing.assert_array_equal(de2.data, _zoo_arrays()["u"])


def test_port_saved_graph_loads_in_jax(tmp_path, zoo):
    gj, gp = zoo
    path = ser.save_graph(gp, str(tmp_path / "port.json"))
    g2 = jser.load_graph(path)
    assert g2.ls() == gp.ls() and g2.lsf() == gp.lsf()
    _assert_beliefs_bit_equal(g2, gp)
    for fl in gp.lsf():
        assert _doc(jser.pack_factor_model(g2.factor(fl).model)) == \
            _doc(pack_factor_model(gp.factor(fl).model)), fl
    m = next(g2.factor(fl).model for fl in g2.lsf()
             if type(g2.factor(fl).model).__name__ == "ScaledRelative")
    assert type(m) is _JaxScaledRelative and m.scale == 2.5
    # the JAX-side network sees the port's weights in its own layout
    nnj = g2.factor("x0x1f4").model.components[0]
    outs = jax.vmap(lambda p: nnj.apply_fn(p, nnj.data))(nnj.params)
    np.testing.assert_allclose(
        np.asarray(outs),
        gp.factor("x0x1f4").model.components[0].all_outputs(CPU).numpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tree_files_cross_load(tmp_path, writer):
    order = ["l1", "l2", "x1", "x2", "x3"]
    tj = jl.build_tree(jl.canonical.generate_kaess(), order=order)
    tp = it.build_tree(it.generate_kaess(device=CPU), order=order)
    path = str(tmp_path / "bt.json")
    if writer == "jax":
        jser.save_tree(tj, path)
        t2 = ser.load_tree(path)
    else:
        ser.save_tree(tp, path)
        t2 = jser.load_tree(path)
    assert t2.elimination_order == order
    for ref in (tj, tp):
        assert t2.num_cliques() == ref.num_cliques()
        for cid, c in ref.cliques.items():
            c2 = t2.cliques[cid]
            for k in ("frontals", "separator", "parent", "children",
                      "potentials", "direct_vars", "iter_vars",
                      "msgskip_vars", "is_recycled", "is_marginalized"):
                assert getattr(c2, k) == getattr(c, k), (cid, k)
            assert c2.status.value == c.status.value


def _dfg_zoo(pkg, a):
    """tests/test_dfg_import.py's zoo graph in ``pkg``, beliefs from
    ``a``."""
    port = pkg is it
    arr = (lambda x: torch.tensor(x)) if port else jnp.asarray
    fg = pkg.initfg(device=CPU) if port else pkg.initfg()
    fg.add_variable("x0", pkg.ContinuousScalar, N=32, tags=("POSE",))
    fg.add_variable("x1", pkg.ContinuousScalar, N=32)
    fg.add_variable("l1", pkg.ContinuousEuclid(2), N=32, tags=("LANDMARK",))
    fg.add_variable("theta", pkg.Circular, N=32)
    fg.add_factor(["x0"], pkg.Mixture(pkg.Prior,
                                      [pkg.Normal(-100.0, 3.0),
                                       pkg.Normal(0.0, 3.0),
                                       pkg.Normal(100.0, 3.0)]),
                  graphinit=False)
    fg.add_factor(["x0", "x1"], pkg.LinearRelative(pkg.Normal(50.0, 2.0)),
                  graphinit=False)
    fg.add_factor(["x1"], pkg.Prior(pkg.Uniform(40.0, 60.0)),
                  graphinit=False)
    fg.add_factor(["l1"], pkg.Prior(pkg.MvNormal([3.0, -2.0],
                                                 np.diag([0.25, 0.25]))),
                  graphinit=False)
    fg.add_factor(["l1"], pkg.PartialPrior(pkg.Normal(3.5, 0.4),
                                           partial=(0,)), graphinit=False)
    fg.add_factor(["theta"], pkg.PriorCircular(pkg.Normal(3.0, 0.1)),
                  graphinit=False)
    for v, pts in a.items():
        fg.set_belief(v, arr(pts[0]), bw=arr(pts[1]))
    for x in list(fg.variables.values()) + list(fg.factors.values()):
        x.timestamp = 1.7e9
    return fg


def _dfg_arrays():
    g = rng(11)
    f32 = np.float32
    return {"x0": (g.normal(0, 50, (32, 1)).astype(f32), np.array([3.0], f32)),
            "x1": (g.normal(50, 5, (32, 1)).astype(f32), np.array([2.0], f32)),
            "l1": (g.normal(0, 1, (32, 2)).astype(f32),
                   np.array([0.5, 0.4], f32)),
            "theta": (g.uniform(2.5, 3.5, (32, 1)).astype(f32),
                      np.array([0.1], f32))}


def _read_archive(root):
    out = {}
    for kind in ("variables", "factors"):
        for fn in sorted(os.listdir(os.path.join(root, kind))):
            d = json.load(open(os.path.join(root, kind, fn)))
            for k in ("data",):
                if k in d:
                    d[k] = json.loads(d[k])
            if "solverData" in d:
                d["solverData"] = [json.loads(s) for s in d["solverData"]]
            out[(kind, fn)] = d
    return out


def test_dfg_export_equal_field_for_field(tmp_path):
    """save_dfg_archive of the same graph writes the same node files in
    both packages, field for field."""
    a = _dfg_arrays()
    jser.save_dfg_archive(_dfg_zoo(jl, a), str(tmp_path / "j"))
    ser.save_dfg_archive(_dfg_zoo(it, a), str(tmp_path / "p"))
    dj, dp = _read_archive(tmp_path / "j"), _read_archive(tmp_path / "p")
    assert sorted(dj) == sorted(dp) and len(dj) == 10
    for k in dj:
        assert dj[k] == dp[k], k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dfg_archive_cross_load(tmp_path, writer):
    """A .tar.gz archive written by either package loads in the other:
    models by type and parameters, the point blocks equal."""
    a = _dfg_arrays()
    path = str(tmp_path / "g.tar.gz")
    if writer == "jax":
        jser.save_dfg_archive(_dfg_zoo(jl, a), path)
        g2 = ser.load_dfg_archive(path, device=CPU)
        pts = {v: g2.points(v).numpy() for v in g2.ls()}
        models = {fl: pack_factor_model(g2.factor(fl).model)
                  for fl in g2.lsf()}
        ref = {fl: pack_factor_model(f.model)
               for fl, f in _dfg_zoo(it, a).factors.items()}
    else:
        ser.save_dfg_archive(_dfg_zoo(it, a), path)
        g2 = jser.load_dfg_archive(path)
        pts = {v: np.asarray(g2.points(v)) for v in g2.ls()}
        models = {fl: jser.pack_factor_model(g2.factor(fl).model)
                  for fl in g2.lsf()}
        ref = {fl: jser.pack_factor_model(f.model)
               for fl, f in _dfg_zoo(jl, a).factors.items()}
    assert sorted(pts) == sorted(a)
    for v, (p, _) in a.items():
        np.testing.assert_array_equal(pts[v], p, err_msg=v)
    assert _doc(models) == _doc(ref)


# -- tests/test_serialization.py on the port ----------------------------------

_DISTS = [("Normal", (1.5, 0.3)),
          ("MvNormal", ([1.0, 2.0], [[2.0, 0.5], [0.5, 1.0]])),
          ("Uniform", (-1.0, 4.0)), ("Rayleigh", (2.0,)),
          ("Categorical", ([0.25, 0.75],)),
          ("AliasingScalarSampler", ([0.0, 1.0], [0.4, 0.6]))]


@pytest.mark.parametrize("name,args", _DISTS, ids=[d[0] for d in _DISTS])
def test_distribution_roundtrip(name, args):
    """Round trip in the port, the packed form equal to JAX's, and each
    package unpacking the other's."""
    dp, dj = getattr(it, name)(*args), getattr(jl, name)(*args)
    packed = pack_distribution(dp)
    assert _doc(packed) == _doc(jser.pack_distribution(dj))
    for d2 in (unpack_distribution(packed, device=CPU),
               unpack_distribution(_doc(jser.pack_distribution(dj)),
                                   device=CPU)):
        assert type(d2) is type(dp)
        for a, b in zip(dp.mean_cov(), d2.mean_cov()):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-6)
    mj, cj = jser.unpack_distribution(_doc(packed)).mean_cov()
    np.testing.assert_allclose(np.asarray(mj), dp.mean_cov()[0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(cj), dp.mean_cov()[1], atol=1e-6)


@pytest.mark.parametrize("m", [Euclidean(3), Circle(), it.SE2(),
                               Product(Euclidean(2), Circle())], ids=repr)
def test_manifold_roundtrip(m):
    assert unpack_manifold(pack_manifold(m)) == m
    # the JAX package reads the packed name back to the same name
    assert _doc(jser.pack_manifold(jser.unpack_manifold(
        pack_manifold(m)))) == _doc(pack_manifold(m))


def test_mixture_model_roundtrip():
    mix = it.Mixture(it.Prior, [it.Normal(-10, 1), it.Normal(10, 1)],
                     [0.3, 0.7])
    m2 = unpack_factor_model(pack_factor_model(mix), device=CPU)
    assert isinstance(m2, it.Mixture) and isinstance(m2.mechanics, it.Prior)
    np.testing.assert_allclose(m2.diversity, [0.3, 0.7], atol=1e-6)


def test_graph_roundtrip_solves(tmp_path):
    fg, steps = it.fourdoor_sequence(device=CPU)
    steps[0]()
    steps[1]()
    path = ser.save_graph(fg, str(tmp_path / "fg.json"))
    fg2 = ser.load_graph(path, device=CPU)
    assert fg2.ls() == fg.ls() and fg2.lsf() == fg.lsf()
    assert torch.equal(fg2.points("x1"), fg.points("x1"))
    it.solve_tree(fg2)
    p = fg2.points("x1")[:, 0].numpy()
    assert np.mean(np.abs(p + 100) < 20) + np.mean(np.abs(p) < 20) > 0.7


def test_parch_drops_points(tmp_path):
    fg = it.generate_kaess(graphinit=True, device=CPU)
    path = ser.save_graph(fg, str(tmp_path / "fg.json"), parch=True)
    doc = json.load(open(path))
    assert all("points" not in b
               for v in doc["variables"] for b in v["beliefs"].values())
    fg2 = ser.load_graph(path, device=CPU)
    assert fg2.points("x1").shape[0] == fg.params.N
    # the JAX package reads the hollow file the same way
    assert jser.load_graph(path).points("x1").shape[0] == fg.params.N


def test_tree_roundtrip(tmp_path):
    fg = it.generate_kaess(device=CPU)
    tree = it.build_tree(fg, order=["l1", "l2", "x1", "x2", "x3"])
    t2 = ser.load_tree(ser.save_tree(tree, str(tmp_path / "bt.json")))
    assert t2.num_cliques() == tree.num_cliques()
    for cid, c in tree.cliques.items():
        c2 = t2.cliques[cid]
        assert (c2.frontals, c2.separator, c2.parent) == \
            (c.frontals, c.separator, c.parent)
    assert t2.elimination_order == tree.elimination_order


def test_extension_model_roundtrip():
    xs = np.linspace(0, 10, 8, dtype=np.float32)
    ys = np.linspace(0, 10, 8, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys)
    h = it.HeatmapGridDensity(X + Y, (xs, ys))
    h2 = unpack_distribution(pack_distribution(h), device=CPU)
    np.testing.assert_array_equal(h2.data, h.data)
    ls = it.LevelSetGridNormal(X + Y, (xs, ys), level=10.0, sigma=1.0)
    ls2 = unpack_distribution(pack_distribution(ls), device=CPU)
    np.testing.assert_allclose(ls2.heatmap.weights, ls.heatmap.weights,
                               atol=1e-6)

    def drift(t, x):
        return torch.full_like(x, 2.0)

    ser.register_fn("drift2", drift)
    de = it.DERelative(drift, 0.0, 3.0, dim=1)
    de2 = unpack_factor_model(pack_factor_model(de), device=CPU)
    assert de2.t1 == 3.0 and de2.f is drift


def test_custom_factor_model_roundtrip(tmp_path):
    """A registered model of the package (the hexagon's landmark factor)
    round-trips through the registry path, and the loaded graph solves."""
    se2 = it.SE2()
    fg = it.initfg(it.SolverParams(N=40), device=CPU)
    fg.add_variable("x", it.VariableType("Pose2", se2))
    fg.add_factor(["x"], it.ManifoldPrior(se2, np.zeros(3),
                                          it.MvNormal([0.0] * 3, [0.1] * 3)))
    fg.add_variable("l", it.ContinuousEuclid(2))
    fg.add_factor(["x", "l"], it.canonical._Pose2Point2Bearingless(
        it.MvNormal([3.0, 1.0], [0.2, 0.2])))
    fg2 = ser.load_graph(ser.save_graph(fg, str(tmp_path / "c.json")),
                         device=CPU)
    m = next(f.model for f in fg2.factors.values()
             if type(f.model).__name__ == "_Pose2Point2Bearingless")
    np.testing.assert_allclose(m.Z.mu, [3.0, 1.0], atol=1e-6)
    it.solve_tree(fg2)
    assert torch.isfinite(fg2.points("l")).all()


def test_aux_model_roundtrip_and_solve(tmp_path):
    """register_factor_model's ``aux``: a custom model with a static field
    saves, loads and solves (x2 = x1 + 2.5 z with z ~ N(1, 0.1))."""
    fg = it.initfg(it.SolverParams(N=60), device=CPU)
    for v in ("a", "b"):
        fg.add_variable(v, it.ContinuousScalar)
    fg.add_factor(["a"], it.Prior(it.Normal(0.0, 0.2)))
    fg.add_factor(["a", "b"], _PortScaledRelative(it.Normal(1.0, 0.1), 2.5))
    assert it.models.MODEL_REGISTRY["ScaledRelative"] == \
        (_PortScaledRelative, ("Z",), ("scale",))
    packed = pack_factor_model(fg.factor("abf2").model)
    assert packed["aux"] == {"scale": {"_k": "scalar", "v": 2.5}}
    fg2 = ser.load_graph(ser.save_graph(fg, str(tmp_path / "a.json")),
                         device=CPU)
    assert fg2.factor("abf2").model.scale == 2.5
    it.solve_tree(fg2)
    assert abs(float(fg2.points("b").mean()) - 2.5) < 0.5


def test_metadata_roundtrip(tmp_path):
    fg = it.initfg(it.SolverParams(N=40), device=CPU)
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.5)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 0.5)))
    it.solve_tree(fg)
    it.add_blob_store(fg, it.InMemoryBlobStore())
    entry = it.add_data(fg, "x0", "meta", b'{"sensor": "lidar"}',
                        mime_type="application/json/octet-stream")
    fg2 = ser.load_graph(ser.save_graph(fg, str(tmp_path / "m.json")),
                         device=CPU)
    assert fg2.var("x0").get_solved_count() == \
        fg.var("x0").get_solved_count() > 0
    assert abs(fg2.var("x0").timestamp - fg.var("x0").timestamp) < 1e-6
    fl = fg.lsf()[0]
    assert abs(fg2.factor(fl).timestamp - fg.factor(fl).timestamp) < 1e-6
    torch.testing.assert_close(fg2.var("x1").ppe["default"]["suggested"],
                               fg.var("x1").ppe["default"]["suggested"],
                               atol=1e-6, rtol=0)
    e2 = fg2.var("x0").data["meta"]
    assert e2.blob_id == entry.blob_id and e2.hash == entry.hash


def test_mkd_manifold_type_roundtrip():
    man = it.SE2()
    pts = man.identity()[None].repeat(8, 1) + 0.01 * torch.randn(
        (8, 3), generator=torch.Generator().manual_seed(0))
    m = it.ManifoldKernelDensity(man, pts)
    m2 = unpack_distribution(pack_distribution(m), device=CPU)
    assert isinstance(m2.manifold, it.SE2)
    torch.testing.assert_close(m2.belief.points, m.belief.points,
                               atol=1e-6, rtol=0)
    d = pack_distribution(m)
    del d["manifold"]                    # older files: Euclidean(dim)
    assert unpack_distribution(d, device=CPU).manifold.dof == man.dof


def test_save_graph_keeps_ppe_lazy(tmp_path):
    fg = it.initfg(it.SolverParams(N=40), device=CPU)
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.5)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 0.5)))
    it.solve_tree(fg)
    est = fg.var("x1").ppe["default"]
    assert isinstance(est, LazyPPE) and not est._done
    path = ser.save_graph(fg, str(tmp_path / "lazy.json"))
    assert not est._done
    est2 = ser.load_graph(path, device=CPU).var("x1").ppe["default"]
    assert isinstance(est2, LazyPPE) and not est2._done
    assert abs(float(est2["suggested"][0]) - 10.0) < 3.0
    # the JAX package reads the marker as its own LazyPPE
    from incrementalinference.jl_tpu.beliefs import LazyPPE as JLazy
    assert isinstance(jser.load_graph(path).var("x1").ppe["default"], JLazy)


# -- tests/test_graph_packing_converters.py ------------------------------------

def _doors_graph():
    fg = it.initfg(device=CPU)
    door = it.Mixture(it.Prior, [it.Normal(-100.0, 3.0), it.Normal(0.0, 3.0),
                                 it.Normal(100.0, 3.0), it.Normal(300.0, 3.0)])
    fg.add_variable("x1", it.ContinuousScalar)
    f1 = fg.add_factor(["x1"], door)
    fg.add_variable("x2", it.ContinuousScalar)
    f2 = fg.add_factor(["x1", "x2"], it.LinearRelative(it.Normal(50.0, 2.0)))
    return fg, f1, f2


def test_samplable_belief_round_trip():
    utd = unpack_distribution(pack_distribution(it.Uniform(0.0, 1.0)),
                              device=CPU)
    assert abs(float(utd.a)) < 1e-10 and abs(float(utd.b) - 1.0) < 1e-10


def test_packed_function_node_data_round_trip():
    fg, f1, f2 = _doors_graph()
    m1 = unpack_factor_model(pack_factor_model(f1.model), device=CPU)
    assert type(m1).__name__ == "Mixture"
    mus = sorted(float(c.mean_cov()[0][0]) for c in m1.components)
    assert np.allclose(mus, [-100.0, 0.0, 100.0, 300.0])
    m2 = unpack_factor_model(pack_factor_model(f2.model), device=CPU)
    mu, cov = m2.mean_cov()
    assert type(m2).__name__ == "LinearRelative"
    assert abs(float(mu[0]) - 50.0) < 1e-9 and abs(float(cov[0, 0]) - 4) < 1e-6


def test_packed_variable_node_data_round_trip(tmp_path):
    fg, _, _ = _doors_graph()
    fg2 = ser.load_graph(ser.save_graph(fg, str(tmp_path / "g.json")),
                         device=CPU)
    for lbl in fg.ls():
        va, vb = fg.var(lbl), fg2.var(lbl)
        assert va.vartype.name == vb.vartype.name and va.N == vb.N
        assert va.initialized == vb.initialized
        if va.is_initialized():
            assert compare_variables(va, vb)


def test_manifold_kernel_density_round_trip():
    pts = torch.tensor(rng(7).normal(size=(100, 2)), dtype=torch.float32)
    mkd = make_belief(Euclidean(2), pts)
    upk = unpack_belief(pack_belief(mkd), device=CPU)
    for a, b in zip(upk, mkd):
        assert torch.equal(a, b)
    assert compare_beliefs(mkd, upk)


def test_parch_hollow_belief():
    b = make_belief(Euclidean(2), torch.ones((64, 2)))
    packed = pack_belief(b, parch=True)
    assert "points" not in packed and packed["npts"] == 64
    hollow = unpack_belief(packed, device=CPU)
    assert hollow.points.shape == (64, 2)
    assert float(hollow.points.abs().sum()) == 0.0


# -- tests/test_saveconverter_types.py -----------------------------------------

class ExtendT1(it.PriorModel):
    """A user type living in this test module (reference Extend.T1)."""

    def __init__(self, Z):
        self.Z = Z

    @property
    def zdim(self):
        return 1

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, p):
        return meas - p

    def mean_cov(self):
        return self.Z.mean_cov()


it.register_factor_model(ExtendT1, children=("Z",))


def test_extending_namespace_converter_resolves():
    packed = pack_factor_model(ExtendT1(it.Normal(3.0, 0.5)))
    assert packed["_type"] == "Custom:ExtendT1"
    m2 = unpack_factor_model(packed, device=CPU)
    assert type(m2) is ExtendT1
    assert abs(float(m2.mean_cov()[0][0]) - 3.0) < 1e-9


def test_unregistered_type_raises_clearly():
    with pytest.raises(TypeError, match="not registered"):
        unpack_factor_model({"_type": "Custom:NeverHeardOfIt",
                             "children": {}, "aux": {}}, device=CPU)


def test_registered_function_round_trip():
    def my_dynamics(x, t):
        return x

    ser.register_fn("test_saveconverter.my_dynamics", my_dynamics)
    assert _fn_name(my_dynamics) == "test_saveconverter.my_dynamics"


# -- tests/test_dfg_import.py ---------------------------------------------------

def test_load_directory_structure():
    fg = ser.load_dfg_archive(FIXTURE, device=CPU)
    assert sorted(fg.ls()) == ["l1", "theta", "x0", "x1", "x2"]
    assert len(fg.lsf()) == 7
    assert fg.var("x0").manifold.dof == 1 and fg.var("l1").manifold.dof == 2
    assert fg.var("theta").vartype.name == "Circular"
    assert "LANDMARK" in fg.var("l1").tags


def test_stored_solver_data_restored():
    fg = ser.load_dfg_archive(FIXTURE, device=CPU)
    v = fg.var("x1")
    assert v.is_initialized() and not fg.var("x0").is_initialized()
    pts = fg.points("x1").numpy()
    assert pts.shape == (16, 1) and abs(pts.mean() - 50.0) < 5.0
    assert abs(float(v.beliefs["default"].bw[0]) - 2.5) < 1e-6
    # the same particles as the JAX package reads
    np.testing.assert_array_equal(
        pts, np.asarray(jser.load_dfg_archive(FIXTURE).points("x1")))


def test_packed_factor_models_decoded():
    fg = ser.load_dfg_archive(FIXTURE, device=CPU)
    assert type(fg.factor("x0f1").model).__name__ == "Mixture"
    assert len(fg.factor("x0f1").model.components) == 4
    assert type(fg.factor("x0x1f1").model).__name__ == "LinearRelative"
    _, cov = fg.factor("x1x2f1").model.mean_cov()
    assert abs(float(np.reshape(cov, ())) - 16.0) < 1e-5
    assert fg.factor("l1f2").model.partial == (0,)
    assert type(fg.factor("thetaf1").model).__name__ == "PriorCircular"
    gj = jser.load_dfg_archive(FIXTURE)
    for fl in fg.lsf():
        assert _doc(pack_factor_model(fg.factor(fl).model)) == \
            _doc(jser.pack_factor_model(gj.factor(fl).model)), fl


def test_archive_solves_to_reference_bars():
    fg = ser.load_dfg_archive(FIXTURE, device=CPU)
    it.solve_tree(fg)
    p0 = fg.points("x0")[:, 0].numpy()
    assert np.mean(np.abs(p0 + 100) < 20) + np.mean(np.abs(p0) < 20) > 0.8
    assert np.mean(np.abs(p0 - 300) < 20) < 0.1
    l1 = fg.points("l1").numpy()
    assert abs(l1[:, 0].mean() - 3.2) < 0.5 and abs(l1[:, 1].mean() + 2) < 0.5
    th = fg.points("theta")[:, 0].numpy()
    assert np.mean(np.abs(th - 3.0) < 0.5) > 0.9


def test_load_targz_roundtrip(tmp_path):
    tgz = tmp_path / "graph.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(FIXTURE, arcname="savedfg")
    fg = ser.load_dfg_archive(str(tgz), device=CPU)
    assert sorted(fg.ls()) == ["l1", "theta", "x0", "x1", "x2"]
    assert len(fg.lsf()) == 7


def test_unknown_types_raise_actionably():
    from incrementalinference_torch.serialization.dfg_import import (
        _unpack_dfg_distribution, _unpack_dfg_factor_model)
    with pytest.raises(ValueError, match="unsupported packed factor"):
        _unpack_dfg_factor_model({}, "RoME.PackedPose2Pose2")
    with pytest.raises(ValueError, match="unsupported packed distribution"):
        _unpack_dfg_distribution({"_type": "Whatever.PackedWeird"})


def test_export_reimport_model_equality(tmp_path):
    fg = _dfg_zoo(it, _dfg_arrays())
    ser.save_dfg_archive(fg, str(tmp_path / "exported"))
    fg2 = ser.load_dfg_archive(str(tmp_path / "exported"), device=CPU)
    assert sorted(fg2.ls()) == sorted(fg.ls())
    assert sorted(fg2.lsf()) == sorted(fg.lsf())
    for fl in fg.lsf():
        assert type(fg.factor(fl).model) is type(fg2.factor(fl).model), fl
    for a, b in zip(fg.factor("x0x1f2").model.mean_cov(),
                    fg2.factor("x0x1f2").model.mean_cov()):
        assert np.allclose(a, b)
    partials = [f for f in fg2.factors.values()
                if type(f.model).__name__ == "PartialPrior"]
    assert len(partials) == 1 and partials[0].model.partial == (0,)
    assert len(fg2.factor("x0f1").model.components) == 3
    assert torch.equal(fg.points("x0"), fg2.points("x0"))
    assert "LANDMARK" in fg2.var("l1").tags


def test_export_targz_and_solve_parity(tmp_path):
    fg = it.initfg(device=CPU)
    prev = None
    for i in range(4):
        v = f"x{i}"
        fg.add_variable(v, it.ContinuousScalar, N=64)
        if prev is None:
            fg.add_factor([v], it.Prior(it.Normal(0.0, 1.0)))
        else:
            fg.add_factor([prev, v], it.LinearRelative(it.Normal(10.0, 1.0)))
        prev = v
    fg.add_variable("l1", it.ContinuousEuclid(2), N=64)
    fg.add_factor(["l1"], it.Prior(it.MvNormal([3.0, -2.0],
                                               np.diag([0.25, 0.25]))))
    tgz = str(tmp_path / "exported.tar.gz")
    ser.save_dfg_archive(fg, tgz)
    fg2 = ser.load_dfg_archive(tgz, device=CPU)
    it.solve_tree(fg)
    it.solve_tree(fg2)
    for v in fg.ls():
        a, b = fg.points(v).mean(0), fg2.points(v).mean(0)
        assert torch.allclose(a, b, atol=1.0), (v, a, b)


def test_export_golden_fixture_field_layout(tmp_path):
    out = tmp_path / "layout"
    ser.save_dfg_archive(_dfg_zoo(it, _dfg_arrays()), str(out))
    vd = json.load(open(out / "variables" / "x0.json"))
    assert {"label", "variableType", "tags", "nstime", "timestamp",
            "solvable", "smallData"} <= set(vd)
    assert vd["variableType"] == "IncrementalInference.ContinuousScalar"
    assert vd["tags"][0] == ":VARIABLE"
    fd = json.load(open(out / "factors" / "x0x1f2.json"))
    assert fd["fnctype"] == "IncrementalInference.PackedLinearRelative"
    assert fd["_variableOrderSymbols"] == [":x0", ":x1"]
    data = json.loads(fd["data"])
    assert set(data) >= {"eliminated", "potentialused", "edgeIDs", "fnc",
                         "multihypo", "certainhypo", "nullhypo",
                         "solveInProgress", "inflation"}
    assert data["certainhypo"] == [1, 2]
    assert data["fnc"]["Z"]["_type"] == "IncrementalInference.PackedNormal"
    md = json.loads(json.load(open(out / "factors" / "x0f1.json"))["data"])
    md = md["fnc"]
    assert md["F_"] == "IncrementalInference.PackedPrior"
    assert md["S"] == ["PackedNormal"] * 3
    assert md["diversity"]["_type"] == \
        "IncrementalInference.PackedCategorical"


def test_export_multihypo_certainhypo(tmp_path):
    fg = it.initfg(device=CPU)
    for v in ("x0", "l1", "l2"):
        fg.add_variable(v, it.ContinuousScalar, N=16)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_factor(["x0", "l1", "l2"], it.LinearRelative(it.Normal(5.0, 1.0)),
                  multihypo=[1.0, 0.5, 0.5], graphinit=False)
    out = tmp_path / "mh"
    ser.save_dfg_archive(fg, str(out))
    fl = [f for f in os.listdir(out / "factors") if "l1" in f][0]
    data = json.loads(json.load(open(out / "factors" / fl))["data"])
    assert data["multihypo"] == [1.0, 0.5, 0.5]
    assert data["certainhypo"] == [1]
    fg2 = ser.load_dfg_archive(str(out), device=CPU)
    assert [fg2.factor(l) for l in fg2.lsf() if "l1" in l][0].multihypo == \
        (1.0, 0.5, 0.5)


# -- the save/load halves of tests/test_extensions.py ---------------------------

def _flux_fg(nn, N):
    fg = it.initfg(it.SolverParams(N=N), device=CPU)
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 0.1)))
    fg.add_factor(["x0", "x1"], it.MixtureFluxModels(
        it.LinearRelative, nn, [it.Normal(10.0, 1.0)], [0.5, 0.5]))
    return fg


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_flux_mixture_save_load(tmp_path, net):
    """tests/test_extensions.py:164-175 (an MLP ensemble) and :327-339 (a
    conv SequentialNet): the same predictions after load, and the loaded
    graph solves."""
    gen = torch.Generator().manual_seed(7)
    if net == "mlp":
        params = it.models.mlp_init(gen, [4, 8, 1], n_models=8)
        nn = it.FluxModelsDistribution(it.models.mlp_apply, params,
                                       torch.zeros(4), out_dim=1)
    else:
        spec = (("conv2d", 1, 4, 3), ("relu",), ("maxpool2d", 2),
                ("flatten",), ("dense", 4 * 4 * 4, 1))
        nn = it.FluxModelsDistribution(it.SequentialNet(spec),
                                       it.nn_init(gen, spec, 8),
                                       torch.full((8, 8, 1), 0.1), out_dim=1)
    fg = _flux_fg(nn, 100)
    pred0 = nn.sample(torch.Generator().manual_seed(0), 8)
    fg2 = ser.load_graph(ser.save_graph(fg, str(tmp_path / "f.json")),
                         device=CPU)
    nn2 = next(f.model for f in fg2.factors.values()
               if isinstance(f.model, it.Mixture)).components[0]
    if net == "conv":
        assert nn2.apply_fn.spec == nn.apply_fn.spec
    torch.testing.assert_close(
        nn2.sample(torch.Generator().manual_seed(0), 8), pred0,
        rtol=0, atol=1e-6)
    it.solve_tree(fg2)
    assert torch.isfinite(fg2.points("x1")).all()


def test_derelative_data_roundtrip(tmp_path):
    """tests/test_extensions.py:257-288: a DERelative with a forcing
    array survives save/load, its flow unchanged."""
    def forced(t, x, u):
        return scaled(x, -0.5) + u[1, 0]

    ser.register_fn("forced_decay_port", forced)
    data = np.stack([np.linspace(0.0, 2.0, 5), np.ones(5)]).astype(
        np.float32)
    de = it.DERelative(forced, 0.0, 2.0, it.MvNormal([0.0], [0.01]), dim=1,
                       steps=16, data=data)
    fg = it.initfg(device=CPU)
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(1.0, 0.1)))
    fg.add_factor(["x0", "x1"], de, graphinit=False)
    fg2 = ser.load_graph(ser.save_graph(fg, str(tmp_path / "de.json")),
                         device=CPU)
    de2 = next(f.model for f in fg2.factors.values()
               if isinstance(f.model, it.DERelative))
    np.testing.assert_array_equal(de2.data, data)
    x = torch.tensor([1.0])
    assert float(de2.flow(x)[0]) == float(de.flow(x)[0])


def test_sequentialnet_layer_zoo_roundtrip():
    """tests/test_extensions.py:363-364: every SequentialNet layer kind
    packs and unpacks to the same draws."""
    spec = (("conv2d", 2, 3, 3), ("tanh",), ("avgpool2d", 2),
            ("conv2d", 3, 2, 3), ("sigmoid",), ("maxpool2d", 2),
            ("flatten",), ("dense", 2 * 2 * 2, 4), ("relu",),
            ("dense", 4, 3), ("softmax",))
    params = it.nn_init(torch.Generator().manual_seed(1), spec, 3)
    d = it.FluxModelsDistribution(it.SequentialNet(spec), params,
                                  torch.full((8, 8, 2), 0.3), out_dim=3)
    d2 = unpack_distribution(pack_distribution(d), device=CPU)
    torch.testing.assert_close(
        d2.sample(torch.Generator().manual_seed(3), 12),
        d.sample(torch.Generator().manual_seed(3), 12), rtol=0, atol=1e-6)

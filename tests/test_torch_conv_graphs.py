"""The convolution's LM solve as a CUDA graph (``ops/convolve.py``
``batched_gauss_newton``): the signature a graph is kept under, which
calls may replay one, and, on the card, that a replay gives the eager
solve's result bit for bit.

This file imports no JAX.  The tests marked ``card`` need an NVIDIA card
and skip here; on the card:
``python -m pytest --noconftest tests/test_torch_conv_graphs.py -m card``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import incrementalinference_torch as it
from incrementalinference_torch import config, tracing
from incrementalinference_torch.models import MsgRelativeLikelihood
from incrementalinference_torch.ops import convolve

COUNTERS = ("conv_graph_replays", "conv_graph_captures", "conv_eager_solves")


@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh_cache(monkeypatch):
    """This test's own cache of solves, empty, and the warning about other
    threads not yet given."""
    monkeypatch.setattr(convolve, "_GRAPHS", convolve._SolveGraphs())
    convolve._warn_other_threads.cache_clear()
    return convolve._GRAPHS


def counted(fn):
    """``fn()`` inside a CPU profiler session, and the session's three
    solve counters."""
    with tracing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = tracing.snapshot()["counters"]
    return out, {k: got.get(k, 0) for k in COUNTERS}


def points(M, n, gen, scale=0.7):
    return M.exp(M.identity()[None].expand(n, -1),
                 scale * torch.randn((n, M.dof), generator=gen))


def case(name, n=256, seed=0, device="cpu"):
    """(manifold, model, meas, others, x0, keyword arguments) of one
    solve: a relative factor between two variables."""
    gen = torch.Generator().manual_seed(seed)
    if name == "linear":
        M = it.Euclidean(2)
        model = it.LinearRelative(it.MvNormal([1.0, -0.5], [0.5, 0.5]))
        kw = dict(sf_slot=1, iters=3, linear=True)
    elif name == "partial":
        M = it.Euclidean(3)
        model = it.LinearRelative(it.MvNormal([1.0, 0.0, 2.0], [0.5] * 3))
        kw = dict(sf_slot=1, iters=8, partial_dims=(0, 2))
    elif name == "se3":
        M = it.SE3()
        model = it.ManifoldFactor(M, it.MvNormal(
            [1.0, 0.5, 0.0, 0.1, -0.2, 0.3], [0.3] * 6))
        kw = dict(sf_slot=1, iters=8)
    else:                                       # "se2.0", "se2.1"
        M = it.SE2()
        model = it.ManifoldFactor(M, it.MvNormal(
            [10.0, 0.0, np.pi / 2], [0.5, 0.5, 0.05]))
        kw = dict(sf_slot=int(name[-1]), iters=8)
    meas = model.sample(gen, n)
    other, x0 = points(M, n, gen), points(M, n, gen)
    to = (lambda t: t.to(device))
    return M, model, to(meas), (to(other),), to(x0), kw


def signature(M, model, meas, others, x0, kw, params=()):
    return convolve.solve_signature(
        M, model, kw["sf_slot"], kw["iters"], kw.get("damping", 1e-6),
        kw.get("partial_dims"), kw.get("linear", False), len(params),
        (meas, x0) + tuple(params) + tuple(others))


# ------------------------------------------------------------- the signature

def se2_pair(seed, z):
    """Two SE(2) poses as bench_port/graphs/se2pair.py builds them, with
    the relative measurement ``z``."""
    M = it.SE2()
    vt = it.VariableType("Pose2", M)
    fg = it.initfg(it.SolverParams(N=32, graphinit=True, batch_cliques=False,
                                   seed=seed), device="cpu")
    fg.add_variable("x0", vt)
    fg.add_variable("x1", vt)
    fg.add_factor(["x0"], it.ManifoldPrior(
        M, np.zeros(3, np.float32), it.MvNormal([0.0] * 3, [0.01] * 3)))
    fg.add_factor(["x0", "x1"], it.ManifoldFactor(
        M, it.MvNormal(z, [0.5, 0.5, 0.05])))
    return fg


def test_fresh_graphs_of_one_structure_give_equal_signatures(monkeypatch):
    """Two graphs built apart, with other measurements, seeds and model
    objects, key every solve of theirs alike: a graph captured in one
    step replays in the next."""
    seen = []
    real = convolve.batched_gauss_newton

    def spy(manifold, model, meas, others, x0, sf_slot, iters=25,
            damping=1e-6, partial_dims=None, linear=False, params=(),
            **kw):
        seen.append(convolve.solve_signature(
            manifold, model, sf_slot, iters, damping, partial_dims, linear,
            len(params), (meas, x0) + tuple(params) + tuple(others)))
        return real(manifold, model, meas, others, x0, sf_slot, iters,
                    damping, partial_dims, linear, params, **kw)

    monkeypatch.setattr(convolve, "batched_gauss_newton", spy)
    keys = []
    for seed, z in ((3, [10.0, 0.0, np.pi / 2]), (8, [9.5, 0.4, 1.4])):
        seen.clear()
        it.solve_tree(se2_pair(seed, z))
        keys.append(list(seen))
    assert keys[0] and None not in keys[0]
    assert keys[0] == keys[1]
    # slot 0 and slot 1 of the one factor: two signatures
    assert len(set(keys[0])) == 2


def _changed(part):
    """(base, changed): the arguments of one SE(2) call, and the same with
    one part of its signature changed."""
    M, model, meas, others, x0, kw = case("se2.1", n=64)
    base = [M, model, meas, others, x0, kw, ()]
    new = list(base)
    if part == "manifold":
        new[0] = it.Euclidean(3)
    elif part == "manifold shape":
        base[0], new[0] = it.Euclidean(3), it.Euclidean(2)
    elif part == "registered field":
        new[1] = it.ManifoldFactor(it.Euclidean(3), model.Z)
    elif part == "model class":
        new[1] = MsgRelativeLikelihood(None, M)
    elif part in SETTINGS:
        new[5] = dict(kw, **{part: SETTINGS[part]})
    elif part == "shape":
        new[2:5] = meas[:63], (others[0][:63],), x0[:63]
    elif part == "stride":
        new[4] = x0.t().contiguous().t()
    elif part == "dtype":
        new[4] = x0.double()
    elif part == "device":
        new[4] = x0.to("meta")
    elif part == "params":
        new[6] = (torch.zeros((64, 3)),)
    return base, new


SETTINGS = {"sf_slot": 0, "iters": 9, "damping": 1e-5,
            "partial_dims": (0, 1), "linear": True}


@pytest.mark.parametrize("part", [
    "manifold", "manifold shape", "registered field", "model class",
    *SETTINGS, "shape", "stride", "dtype", "device", "params",
    "matmul precision"])
def test_each_part_of_the_signature_changes_it(part):
    if part == "matmul precision":
        M, model, meas, others, x0, kw = case("se2.1", n=64)
        base = signature(M, model, meas, others, x0, kw)
        with config.full_precision():
            other = signature(M, model, meas, others, x0, kw)
        assert torch.backends.cuda.matmul.fp32_precision != "ieee"
    else:
        base, new = _changed(part)
        other = signature(*new)
        # the base call keys alike when built anew
        assert signature(*base) == signature(*_changed(part)[0])
        base = signature(*base)
    assert base is not None and other is not None
    assert base != other


def test_a_registered_value_field_is_keyed_by_value():
    """PartialPrior's ``partial`` (a tuple of ints) enters by value; its
    measurement distribution does not."""
    M = it.Euclidean(2)
    meas, x0 = torch.zeros((8, 1)), torch.zeros((8, 2))
    kw = dict(sf_slot=0, iters=3)

    def key(model):
        return signature(M, model, meas, (), x0, kw)

    a = it.PartialPrior(it.Normal(0.0, 1.0), (0,))
    assert key(a) == key(it.PartialPrior(it.Normal(5.0, 2.0), (0,)))
    assert key(a) != key(it.PartialPrior(it.Normal(0.0, 1.0), (1,)))


class _Unregistered(it.FactorModel):
    def __init__(self, Z):
        self.Z = Z

    def residual(self, meas, x1, x2):
        return meas - (x2 - x1)


class _Callable(it.FactorModel):
    """Registered with a field that cannot be keyed (a function)."""

    def __init__(self, Z, f):
        self.Z, self.f = Z, f

    def residual_params(self, device):
        return ()

    def residual(self, meas, x1, x2):
        return meas - self.f(x2 - x1)


it.register_factor_model(_Callable, ("Z",), ("f",))


def ode_model():
    from incrementalinference_torch.models.ode import DERelative
    return DERelative(lambda t, x: -x, 0.0, 1.0, dim=2)


@pytest.mark.parametrize("make,zdim", [
    (lambda: _Unregistered(it.MvNormal([0.0] * 2, [1.0] * 2)), 2),
    (lambda: _Callable(it.MvNormal([0.0] * 2, [1.0] * 2), torch.sin), 2),
    (ode_model, 2),
    # its residual would read its own points: no params were given
    (lambda: it.GaussianJoint([it.Euclidean(2), it.Euclidean(2)],
                              [np.zeros(2), np.ones(2)], np.eye(4)), 4),
], ids=["unregistered", "unkeyable field", "unstackable", "own tensors"])
def test_models_a_replay_could_misread_have_no_signature(make, zdim):
    """No key, so the call solves eagerly on any device and counts under
    ``conv_eager_solves``."""
    M, model = it.Euclidean(2), make()
    gen = torch.Generator().manual_seed(1)
    meas, other, x0 = (torch.randn((16, d), generator=gen)
                       for d in (zdim, 2, 2))
    assert signature(M, model, meas, (other,), x0,
                     dict(sf_slot=1, iters=3)) is None
    out, counts = counted(lambda: convolve.batched_gauss_newton(
        M, model, meas, (other,), x0, 1, iters=3))
    assert torch.isfinite(out).all()
    assert counts == {"conv_graph_replays": 0, "conv_graph_captures": 0,
                      "conv_eager_solves": 1}


def test_a_cpu_tensor_is_never_captured(fresh_cache):
    M, model, meas, others, x0, kw = case("se2.1", n=64)
    kw = dict(kw)
    slot = kw.pop("sf_slot")
    outs, counts = counted(lambda: [convolve.batched_gauss_newton(
        M, model, meas, others, x0, slot, **kw) for _ in range(4)])
    assert counts == {"conv_graph_replays": 0, "conv_graph_captures": 0,
                      "conv_eager_solves": 4}
    assert not fresh_cache.entries
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.parametrize("dof", [1, 2, 3, 6, 8])
def test_solve_ex_gives_solve_s_answer_on_the_cpu(dof):
    """The LM step's ``solve_ex`` (no check on the host) is ``solve``'s
    factorisation: the same bits on damped normal equations."""
    gen = torch.Generator().manual_seed(dof)
    J = torch.randn((512, dof + 2, dof), generator=gen)
    r = torch.randn((512, dof + 2, 1), generator=gen)
    lam = torch.rand((512,), generator=gen) * 1e-3 + 1e-6
    Jt = J.transpose(-1, -2)
    A = Jt @ J + lam[:, None, None] * torch.eye(dof)
    got, info = torch.linalg.solve_ex(A, Jt @ r, check_errors=False)
    assert torch.equal(got, torch.linalg.solve(A, Jt @ r))
    assert not info.any()


def test_the_cache_is_bounded_and_per_thread(fresh_cache):
    """First calls only (eager on the CPU): at most GRAPH_CACHE_SIZE
    signatures, the least recently met out first; another thread starts
    with none of them."""
    calls = []

    def solve(free, *inputs):
        calls.append(free)
        return inputs[0]

    x = torch.zeros((2, 1))
    n = convolve.GRAPH_CACHE_SIZE
    for k in range(n + 3):
        fresh_cache.solve(("key", k), solve, lambda: k, (x, x))
    assert list(fresh_cache.entries) == [("key", k) for k in range(3, n + 3)]
    assert calls == list(range(n + 3))
    other = []
    th = threading.Thread(target=lambda: other.append(
        dict(convolve._GRAPHS.entries)))
    th.start()
    th.join(30)
    assert not th.is_alive() and other == [{}]


def test_a_capture_waits_for_a_lone_thread(fresh_cache):
    """While another Python thread runs, a key's second call solves
    eagerly and stays due for capture (no CUDA is touched here); the
    process is told so once."""
    calls = []

    def solve(free, *inputs):
        calls.append(free)
        return inputs[0]

    x = torch.zeros((2, 1))
    release = threading.Event()
    th = threading.Thread(target=release.wait, args=(30,))
    th.start()
    try:
        with pytest.warns(UserWarning, match="lone thread") as caught:
            _, counts = counted(lambda: [fresh_cache.solve(
                "key", solve, lambda: k, (x, x)) for k in range(4)])
    finally:
        release.set()
        th.join(30)
    assert not th.is_alive()
    assert len(caught) == 1
    assert calls == [0, 1, 2, 3]
    assert counts == {"conv_graph_replays": 0, "conv_graph_captures": 0,
                      "conv_eager_solves": 4}
    assert fresh_cache.entries == {"key": None}


def test_a_linear_step_that_is_not_finite_keeps_x0():
    """A rank-deficient J (a range: one residual over two dims) with no
    damping makes JtJ singular.  ``solve_ex`` checks nothing on the host,
    so the closed-form step is not finite; each such particle keeps x0, as
    the LM loop keeps one, where a damped step moves it."""
    M = it.Euclidean(2)
    model = it.EuclidDistance(it.Normal(3.0, 0.1))
    gen = torch.Generator().manual_seed(0)
    meas = model.sample(gen, 64)
    other = torch.randn((64, 2), generator=gen)
    x0 = other + torch.tensor([1.0, 0.0])       # J's second column is 0
    out = convolve.batched_gauss_newton(M, model, meas, (other,), x0, 1,
                                        linear=True, damping=0.0)
    assert torch.equal(out, x0)
    damped = convolve.batched_gauss_newton(M, model, meas, (other,), x0, 1,
                                           linear=True)
    assert torch.isfinite(damped).all()
    assert (damped != x0).any(-1).all()


# ------------------------------------------------------------------ the card

def solve_n(times, M, model, meas, others, x0, kw, params=()):
    kw = dict(kw)
    slot = kw.pop("sf_slot")
    return [convolve.batched_gauss_newton(M, model, meas, others, x0, slot,
                                          params=params, **kw)
            for _ in range(times)]


def eager(M, model, meas, others, x0, kw, params=()):
    """The solve's eager loop, as the mesh split calls it."""
    free = convolve._free_mask(M.dof, kw.get("partial_dims"), x0.device)
    return convolve._lm_solve(M, model, kw["sf_slot"], kw["iters"],
                              kw.get("damping", 1e-6),
                              kw.get("linear", False), len(params), free,
                              meas, x0, *params, *others)


@pytest.mark.card
@pytest.mark.parametrize("name", ["se2.0", "se2.1", "se3", "linear",
                                  "partial"])
def test_replay_is_bit_equal_to_the_eager_solve(card, fresh_cache, name):
    """The key's first call (eager), second (captured, then replayed) and
    later calls (replayed) give the eager solve's bits; a replay on other
    inputs gives their eager solve's."""
    M, model, meas, others, x0, kw = case(name, n=4096, device=card)
    with config.full_precision():
        want = eager(M, model, meas, others, x0, kw)
        outs, counts = counted(lambda: solve_n(4, M, model, meas, others,
                                               x0, kw))
        _, _, meas2, others2, x02, _ = case(name, n=4096, seed=9,
                                            device=card)
        want2 = eager(M, model, meas2, others2, x02, kw)
        got2 = solve_n(1, M, model, meas2, others2, x02, kw)[0]
    torch.cuda.synchronize()
    assert counts == {"conv_graph_replays": 2, "conv_graph_captures": 1,
                      "conv_eager_solves": 1}
    for o in outs:
        assert torch.equal(o, want)
    assert torch.equal(got2, want2) and not torch.equal(want2, want)


@pytest.mark.card
def test_a_batched_level_with_stacked_params_replays_bit_equal(
        card, fresh_cache):
    """B = 3 members of a batched level whose models carry residual
    tensors (GaussianJoint's points): ``_solve_particles`` stacks them per
    particle as ``params``, and the replay reads each member's."""
    E = it.Euclidean(2)
    models = tuple(it.GaussianJoint([E, E], [np.full(2, b), np.full(2, -b)],
                                    np.eye(4)) for b in (0.0, 1.0, 2.5))
    n, B = 2048, len(models)
    gen = torch.Generator().manual_seed(4)
    meas = (0.1 * torch.randn((B * n, 4), generator=gen)).to(card)
    other = torch.randn((B * n, 2), generator=gen).to(card)
    x0 = torch.randn((B * n, 2), generator=gen).to(card)
    spec = convolve.ConvSpec(is_prior=False, sfidx=1, nvars=2,
                             partial_dims=None, multihypo=None, nullhypo=0.0,
                             iters=8, cycles=1, inflation=0.0, spread_nh=1.0,
                             damping=1e-6)
    model, params = convolve._member_residuals(models, n, card)
    assert len(params) == 2 and params[0].shape == (B * n, 2)
    kw = dict(sf_slot=1, iters=8)
    want = eager(E, model, meas, (other,), x0, kw, params)
    outs, counts = counted(lambda: [convolve._solve_particles(
        E, models, meas, (other,), x0, 1, spec, None) for _ in range(3)])
    assert counts["conv_graph_replays"] == 1
    assert counts["conv_graph_captures"] == 1
    for o in outs:
        assert torch.equal(o, want)
    # each member moved to its own points: x1 ≈ p0 of the second variable
    for b in range(B):
        mean = want[b * n:(b + 1) * n].mean(0).cpu()
        assert torch.allclose(mean, torch.full((2,), -(0.0, 1.0, 2.5)[b]),
                              atol=0.05)


@pytest.mark.card
def test_models_that_differ_in_a_registered_field_never_share_a_graph(
        card, fresh_cache):
    """A ManifoldFactor on SE(2) and one on R³ solving the same SE(2)
    tensors: the second's first call is its own eager solve, not the
    first's replay."""
    M, model, meas, others, x0, kw = case("se2.1", n=2048, device=card)
    flat = it.ManifoldFactor(it.Euclidean(3), model.Z)
    with config.full_precision():
        solve_n(3, M, model, meas, others, x0, kw)
        want = eager(M, flat, meas, others, x0, kw)
        outs, counts = counted(lambda: solve_n(3, M, flat, meas, others,
                                               x0, kw))
        again = solve_n(1, M, model, meas, others, x0, kw)[0]
    assert counts == {"conv_graph_replays": 1, "conv_graph_captures": 1,
                      "conv_eager_solves": 1}
    for o in outs:
        assert torch.equal(o, want)
    assert torch.equal(again, eager(M, model, meas, others, x0, kw))
    assert not torch.equal(want, again)


@pytest.mark.card
def test_two_threads_solving_at_once_each_get_their_eager_result(card):
    """Two threads solve one signature at once, each on its own inputs,
    and synchronize the device when done: neither captures (a capture
    waits for a lone thread), and each gets its eager result."""
    runs = []
    for seed in (1, 2):
        M, model, meas, others, x0, kw = case("se2.1", n=8192, seed=seed,
                                              device=card)
        runs.append((M, model, meas, others, x0, kw,
                     eager(M, model, meas, others, x0, kw)))
    barrier = threading.Barrier(2, timeout=30)
    out, errors = [None, None], []

    def run(i):
        try:
            M, model, meas, others, x0, kw, _ = runs[i]
            barrier.wait()
            out[i] = solve_n(5, M, model, meas, others, x0, kw)
            torch.cuda.synchronize()
            assert not any(convolve._GRAPHS.entries.values())
        except BaseException as e:              # noqa: BLE001 - re-raised
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(240)
    assert not any(th.is_alive() for th in threads), "a thread hung"
    if errors:
        raise errors[0]
    for i in range(2):
        for o in out[i]:
            assert torch.equal(o, runs[i][-1])


@pytest.mark.card
def test_a_replay_does_not_wait_for_the_device(card, fresh_cache):
    M, model, meas, others, x0, kw = case("se2.1", n=4096, device=card)
    want = solve_n(2, M, model, meas, others, x0, kw)[-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = solve_n(2, M, model, meas, others, x0, kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(g, want) for g in got)


class _Waits(it.FactorModel):
    """A residual that waits for its stream: it cannot be captured."""

    def __init__(self, Z):
        self.Z = Z

    def residual(self, meas, x1, x2):
        torch.cuda.current_stream().synchronize()
        return meas - (x2 - x1)


it.register_factor_model(_Waits, ("Z",))


@pytest.mark.card
def test_a_solve_that_cannot_be_captured_runs_eagerly(card, fresh_cache):
    M = it.Euclidean(2)
    model = _Waits(it.MvNormal([1.0, 0.0], [0.5, 0.5]))
    gen = torch.Generator().manual_seed(2)
    meas, other, x0 = (torch.randn((512, 2), generator=gen).to(card)
                       for _ in range(3))
    kw = dict(sf_slot=1, iters=4)
    want = eager(M, model, meas, (other,), x0, kw)
    with pytest.warns(UserWarning, match="runs eagerly"):
        outs, counts = counted(lambda: solve_n(3, M, model, meas, (other,),
                                               x0, kw))
    assert counts == {"conv_graph_replays": 0, "conv_graph_captures": 0,
                      "conv_eager_solves": 3}
    for o in outs:
        assert torch.equal(o, want)
    # the card still works after the failed capture
    M2, m2, meas2, others2, x02, kw2 = case("se2.1", n=512, device=card)
    assert torch.equal(solve_n(3, M2, m2, meas2, others2, x02, kw2)[-1],
                       eager(M2, m2, meas2, others2, x02, kw2))

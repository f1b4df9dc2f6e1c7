"""Full float32 precision on the port's own terms (config.full_precision).

The JAX package asks for ``Precision.HIGHEST`` on each small-K product
(jl_tpu/ops/product.py, jl_tpu/beliefs.py), so no global setting reaches
its solves.  The port pins float32 matmul and cuDNN convolutions to IEEE
for the span of each device entry point and gives the caller's setting
back on exit.  A caller can ask for TF32 three ways: the legacy flag,
``torch.set_float32_matmul_precision("high")`` and the per-backend
``fp32_precision``; reading the legacy flag after the last raises, so the
pin must never read it.
"""

import threading

import numpy as np
import pytest
import torch

import incrementalinference_torch as it
from incrementalinference_torch import config
from incrementalinference_torch.ops import convolve, fused, product
from incrementalinference_torch.parametric import solver as psolver

torch.set_num_threads(2)

MM = torch.backends.cuda.matmul
_LEAVES = (torch.backends, MM, torch.backends.cudnn.conv,
           torch.backends.cudnn.rnn, torch.backends.mkldnn.matmul,
           torch.backends.mkldnn.conv, torch.backends.mkldnn.rnn)


def _snapshot():
    return tuple(m.fp32_precision for m in _LEAVES)


def _set_tf32(how):
    if how == "legacy":
        MM.allow_tf32 = True
    elif how == "high":
        torch.set_float32_matmul_precision("high")
    else:
        MM.fp32_precision = "tf32"


@pytest.fixture(autouse=True)
def caller_precision():
    """Every test leaves the process's precision as it found it."""
    saved = _snapshot()
    yield
    torch.set_float32_matmul_precision("highest")
    for m, v in zip(_LEAVES, saved):
        m.fp32_precision = v


class _Spy:
    """Records the matmul precision each time one of ``names`` (module
    attributes) is entered."""

    def __init__(self, monkeypatch, targets):
        self.seen = {name: [] for _, name in targets}
        for mod, name in targets:
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, self._wrap(name, orig))

    def _wrap(self, name, orig):
        def spy(*a, **k):
            self.seen[name].append(MM.fp32_precision)
            return orig(*a, **k)
        return spy


def _two_var(N):
    return it.initfg(it.SolverParams(N=N), device="cpu")


def _grow_two_var(fg):
    fg.add_variable("x0", it.ContinuousScalar)
    fg.add_factor(["x0"], it.Prior(it.Normal(0.0, 1.0)))
    fg.add_variable("x1", it.ContinuousScalar)
    fg.add_factor(["x0", "x1"], it.LinearRelative(it.Normal(10.0, 1.0)))
    fg.add_factor(["x1"], it.Prior(it.Normal(10.0, 1.0)))


@pytest.mark.parametrize("how", ["legacy", "high", "new"])
@pytest.mark.parametrize("N", [100, 1024])
def test_solve_tree_runs_in_ieee_and_gives_the_callers_setting_back(
        monkeypatch, how, N):
    """TF32 set after initfg: graphinit, _pair_logW, condense_mixture (at
    N = 1024 the stages condense) and the LOO bandwidth all see IEEE, and
    the caller's setting is back after the solve."""
    fg = _two_var(N)
    _set_tf32(how)
    before = _snapshot()
    spy = _Spy(monkeypatch, [(product, "_pair_logW"),
                             (product, "condense_mixture"),
                             (fused, "loo_bandwidth"),
                             (convolve, "loo_bandwidth")])
    _grow_two_var(fg)
    it.solve_tree(fg)
    assert _snapshot() == before
    assert MM.fp32_precision == "tf32"
    if how != "new":
        assert MM.allow_tf32 is True
    if how == "high":
        assert torch.get_float32_matmul_precision() == "high"
    seen = spy.seen
    assert seen["loo_bandwidth"]
    assert seen["condense_mixture" if N >= product.CONDENSE_MIN_NB
                else "_pair_logW"]
    assert {p for calls in seen.values() for p in calls} == {"ieee"}, seen
    assert abs(float(fg.points("x1").mean()) - 10.0) < 0.4


@pytest.mark.parametrize("how", ["legacy", "high", "new"])
def test_parametric_entry_points_run_in_ieee(monkeypatch, how):
    fg = it.generate_line_step(5, graphinit=False, device="cpu")
    _set_tf32(how)
    before = _snapshot()
    seen = []
    orig_solve = psolver.ParametricProblem.solve
    orig_batched = psolver.solve_problems_batched

    def solve(self, *a, **k):
        seen.append(("solve", MM.fp32_precision))
        return orig_solve(self, *a, **k)

    def batched(*a, **k):
        seen.append(("batched", MM.fp32_precision))
        return orig_batched(*a, **k)

    monkeypatch.setattr(psolver.ParametricProblem, "solve", solve)
    monkeypatch.setattr(psolver, "solve_problems_batched", batched)
    it.autoinit_parametric(fg)
    assert _snapshot() == before
    it.solve_graph_parametric(fg)
    assert _snapshot() == before
    assert {w for w, _ in seen} == {"solve", "batched"}, seen
    assert {p for _, p in seen} == {"ieee"}, seen
    assert abs(float(fg.var("x4").parametric_point[0]) - 4.0) < 1e-2


@pytest.mark.parametrize("how", ["legacy", "high", "new"])
def test_manifold_product_runs_in_ieee(monkeypatch, how):
    r = np.random.default_rng(0)
    props = [product.Proposal(
        torch.as_tensor(r.normal(m, 1.0, size=(200, 2)), dtype=torch.float32),
        torch.tensor([0.3, 0.3])) for m in (0.0, 1.0)]
    _set_tf32(how)
    before = _snapshot()
    spy = _Spy(monkeypatch, [(product, "_pair_logW")])
    out = product.manifold_product(it.Euclidean(2), props, 3, 200)
    assert _snapshot() == before
    assert spy.seen["_pair_logW"] and set(spy.seen["_pair_logW"]) == {"ieee"}
    assert out.shape == (200, 2) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("how", ["legacy", "high", "new"])
def test_local_product_and_propagate_belief_run_in_ieee(monkeypatch, how):
    fg = _two_var(100)
    _grow_two_var(fg)
    _set_tf32(how)
    before = _snapshot()
    spy = _Spy(monkeypatch, [(product, "_pair_logW")])
    it.local_product(fg, "x1")
    it.propagate_belief(fg, "x1", fg.factors_of("x1"))
    assert _snapshot() == before
    assert spy.seen["_pair_logW"] and set(spy.seen["_pair_logW"]) == {"ieee"}


def test_spans_nest_and_survive_exceptions():
    torch.set_float32_matmul_precision("high")
    before = _snapshot()
    with config.full_precision():
        assert MM.fp32_precision == "ieee"
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"
        with config.full_precision():
            assert MM.fp32_precision == "ieee"
        assert MM.fp32_precision == "ieee"       # the outer pin, given back
    assert _snapshot() == before

    @config.full_precision()
    def fails():
        assert MM.fp32_precision == "ieee"
        raise ValueError("inside the span")

    with pytest.raises(ValueError):
        fails()
    assert _snapshot() == before
    assert torch.get_float32_matmul_precision() == "high"


def test_threads_share_one_span():
    """Thread A enters, thread B enters, A leaves while B is still inside:
    B stays pinned, and the caller's setting comes back when B leaves (a
    span that saved and restored on its own would give B TF32 halfway and
    leave the caller with IEEE for good)."""
    torch.set_float32_matmul_precision("high")
    before = _snapshot()
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with config.full_precision():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with config.full_precision():
            b_in.set()
            a_out.wait(10)
            seen["b after a left"] = MM.fp32_precision
        seen["b left"] = _snapshot()

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert seen == {"b after a left": "ieee", "b left": before}
    assert torch.get_float32_matmul_precision() == "high"


def test_two_threads_in_products_at_once_both_run_in_ieee(monkeypatch):
    """Two threads each run manifold_product (a pinned entry point) 20
    times under a caller's "high": every _pair_logW of either sees IEEE,
    and "high" is back once both are done."""
    r = np.random.default_rng(1)
    props = [product.Proposal(
        torch.as_tensor(r.normal(m, 1.0, size=(200, 2)), dtype=torch.float32),
        torch.tensor([0.3, 0.3])) for m in (0.0, 1.0)]
    torch.set_float32_matmul_precision("high")
    before = _snapshot()
    spy = _Spy(monkeypatch, [(product, "_pair_logW")])
    start = threading.Barrier(2)
    outs, errors = [], []

    def run(seed):
        try:
            start.wait(10)
            for k in range(20):
                outs.append(product.manifold_product(
                    it.Euclidean(2), props, seed * 100 + k, 200))
        except Exception as e:                   # noqa: BLE001 (re-raised)
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert _snapshot() == before
    assert len(spy.seen["_pair_logW"]) >= 40
    assert set(spy.seen["_pair_logW"]) == {"ieee"}
    assert len(outs) == 40 and all(bool(torch.isfinite(o).all())
                                   for o in outs)


def test_the_default_setting_is_given_back_unchanged():
    before = _snapshot()
    with config.full_precision():
        pass
    assert _snapshot() == before
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("how", ["default", "legacy", "high", "new"])
def test_building_a_graph_leaves_the_callers_setting(monkeypatch, how):
    """resolve_device("cuda") used to turn TF32 off for the whole process;
    a graph built on a card (is_available patched here) changes nothing."""
    if how != "default":
        _set_tf32(how)
    before = _snapshot()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.resolve_device("cuda").type == "cuda"
    assert config.resolve_device(None).type == "cuda"
    assert _snapshot() == before
    monkeypatch.undo()
    fg = it.initfg(device="cpu")
    _grow_two_var(fg)                            # graphinit runs
    assert _snapshot() == before
    if how in ("legacy", "high"):
        assert MM.allow_tf32 is True

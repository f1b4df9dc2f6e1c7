"""The two-pose SE(3) cell, ``se3pair-n33k.mmisam-ppe``: added as new
files and entries only, its checks giving the numbers of their SE(2)
siblings for the program and for the control, and the arithmetic of
``kde_se3_roofline_pct`` at its bound."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port.checks import (bandwidth, bandwidth_se3, beliefs,
                               beliefs_se3, estimates, estimates_se3)
from bench_port.graphs import se2pair, se3pair
from bench_port.lib import registry
from bench_port.metrics import kde_se3_roofline_pct as R
from bench_port.reference import se3
from bench_port.reference.manifolds import SE2

CELL = "se3pair-n33k.mmisam-ppe"
NEW_FILES = ["configs/se3pair-n33k.json", "graphs/se3pair.py",
             "traffic/mmisam-ppe-se3.json", f"limits/{CELL}.json",
             "reference/se3.py", "checks/beliefs_se3.py",
             "checks/bandwidth_se3.py", "checks/estimates_se3.py",
             "metrics/kde_se3_roofline_pct.py"]
NEW_ENTRIES = {"configs": ["se3pair-n33k"], "workloads": [CELL],
               "end_to_end": [], "per_layer": ["kde_se3_roofline_pct"]}
#: the entries the benchmark had before this cell, in their order
BEFORE = {
    "configs": ["se2pair-n50k", "line2-n50k"],
    "workloads": ["se2pair-n50k.mmisam", "se2pair-n50k.mmisam-ppe",
                  "line2-n50k.mmisam-exact"],
    "end_to_end": ["step_s", "setup_s"],
    "per_layer": ["first_build_s", "build_ms", "solve_ms", "ppe_ms",
                  "device_ops_per_step", "pair_lse_roofline_pct",
                  "device_idle_pct", "convolve_ms", "product_ms",
                  "bandwidth_ms", "graphinit_ms", "sweep_self_ms",
                  "jacobian_passes_per_step", "convolve_ops_per_step",
                  "convolve_idle_pct", "convolve_graph_replay_pct",
                  "draw_device_ms", "draw_roofline_pct", "kde_roofline_pct"]}


def _subsequence(short, long):
    it = iter(long)
    return all(any(x == y for y in it) for x in short)


def test_the_cell_comes_after_what_was_there_and_edits_none_of_it():
    """Every entry of the benchmark before the cell is still there, in its
    order, and the cell's entries follow them all; entries added later
    may follow anywhere after theirs.  Of the metrics that list their
    cells, none but the new one names this cell."""
    bench = registry.benchmark()
    for key, before in BEFORE.items():
        names = [x["name"] for x in bench[key]]
        assert _subsequence(before, names), key
        last = max(names.index(n) for n in before)
        for n in NEW_ENTRIES[key]:
            assert names.index(n) > last, (key, n)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    assert per_layer["kde_se3_roofline_pct"]["workloads"] == [CELL]
    for name in ("ppe_ms", "pair_lse_roofline_pct", "kde_roofline_pct"):
        assert CELL not in per_layer[name]["workloads"]
    conf, = [c for c in bench["configs"] if c["name"] == "se3pair-n33k"]
    assert conf["reduced"] == ["N"]
    assert conf["file"] == "bench_port/configs/se3pair-n33k.json"
    cell = registry.cell(bench, CELL)
    assert cell["entry"]["chips"] == 1
    assert (cell["cfg"]["manifold"], cell["cfg"]["dof"],
            cell["cfg"]["point_dim"], cell["cfg"]["N"]) == ("SE3", 6, 7,
                                                             33_000)
    assert cell["traffic"]["phases"] == ["build", "solve", "ppe"]
    assert cell["traffic"]["checks"] == {"beliefs_se3": 4,
                                         "bandwidth_se3": 4,
                                         "estimates_se3": 2}


def test_the_cell_runs_from_its_new_files_alone(tmp_path):
    """A copy of the benchmark without the cell's files and entries, then
    with them added back as they are: the files there before are
    untouched, and the cell runs through ``run.execute`` at N=24 on the
    CPU and reports every check its limits name."""
    root = registry.ROOT
    shutil.copytree(os.path.join(root, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in NEW_FILES:
        os.remove(tmp_path / "bench_port" / f)
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*")
              if p.is_file()}
    bench = registry.benchmark()
    stripped = {k: ([x for x in v if x["name"] not in NEW_ENTRIES[k]]
                    if k in NEW_ENTRIES else v) for k, v in bench.items()}
    for f in NEW_FILES:
        shutil.copy(os.path.join(root, "bench_port", f),
                    tmp_path / "bench_port" / f)
    added = json.loads(json.dumps(stripped))
    for key, names in NEW_ENTRIES.items():
        added[key] += [x for x in bench[key] if x["name"] in names]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    script = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from bench_port import run\n"
        "from bench_port.lib import registry\n"
        "b = registry.benchmark()\n"
        f"cell = registry.cell(b, {CELL!r})\n"
        "cell['cfg']['N'] = 24\n"
        f"a = run.parse(['--workload', {CELL!r}, '--seed', '5',"
        " '--seconds', '0.01', '--trace', '0'])\n"
        "sys.exit(run.execute(a, b, cell, torch.device('cpu')))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": root})
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    with open(os.path.join(root, "bench_port", "limits", f"{CELL}.json")) as f:
        assert set(line["checks"]) == set(json.load(f))
    assert all(c["value"] is not None for c in line["checks"].values())
    after = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())


# -- the checks against their SE(2) siblings -----------------------------------

def _records(graph, M, n, workload, seed=3):
    """Two steps' records of a cell's two poses: ``n`` particles drawn
    around x0 at the prior's point and x1 at x0 o Exp(z), with each
    factor's sigmas (no solve)."""
    cfg = {**registry.cell(registry.benchmark(), workload)["cfg"], "N": n}
    g = torch.Generator().manual_seed(seed)
    out = []
    for k in range(2):
        meas = graph.measurements(cfg, seed, k)
        (_, p0, s0), (_, z, s1) = meas["factors"]
        x0 = torch.tensor(p0, dtype=torch.float64)
        x1 = M.exp(x0, torch.tensor(z, dtype=torch.float64))
        bel = {}
        for lbl, x, sig in (("x0", x0, s0), ("x1", x1, s1)):
            sig = torch.tensor(sig, dtype=torch.float64)
            X = torch.randn(n, M.dof, generator=g, dtype=torch.float64) * sig
            bel[lbl] = (M.exp(x.expand(n, -1), X).float(),
                        (0.3 * sig).float())
        ppe = {lbl: {"mean": M.mean(b[0].double()).float(), "max": b[0][0]}
               for lbl, b in bel.items()}
        out.append({"meas": meas, "beliefs": bel, "ppe": ppe,
                    "replaced": {"x0": True, "x1": True},
                    "init": {"x0": None, "x1": None}})
    return cfg, out


@pytest.mark.parametrize("source", ["program", "bfloat16"])
def test_the_se3_checks_give_their_siblings_numbers(source):
    """The same numbers, each finite, from the same kind of records, for
    the program and for the control in bfloat16."""
    cfg3, rec3 = _records(se3pair, se3.SE3(), 300, CELL)
    cfg2, rec2 = _records(se2pair, SE2(), 300, "se2pair-n50k.mmisam-ppe")
    for new, old in ((beliefs_se3, beliefs), (bandwidth_se3, bandwidth),
                     (estimates_se3, estimates)):
        got, _ = new.judge(rec3, {"cfg": cfg3}, source)
        want, _ = old.judge(rec2, {"cfg": cfg2}, source)
        assert set(got) == set(want), new.__name__
        assert all(math.isfinite(v) for v in got.values()), got


def test_the_bfloat16_control_is_that_precision():
    M = se3.SE3()
    g = torch.Generator().manual_seed(4)
    pts = M.exp(M.identity()[None].expand(64, -1),
                0.3 * torch.randn(64, 6, generator=g, dtype=torch.float64))
    low = M.log(pts[:1].bfloat16(), pts.bfloat16())
    assert low.dtype == torch.bfloat16
    exact = M.log(pts[:1], pts)
    gap = float((low.double() - exact).abs().max())
    assert 1e-4 < gap < 0.1


# -- kde_se3_roofline_pct -------------------------------------------------------

RATE = 132 * 1.98e9


def _span(n, q, pairs, manifold="SE3"):
    attrs = {"N": n, "Q": q}
    if manifold is not None:
        attrs["manifold"] = manifold
    return {"name": "kde_logpdf", "attrs": attrs,
            "counts": {"kde_pairs": pairs} if pairs else {}}


def _ctx(events):
    return {"trace": {"events": events, "steps": 1},
            "cfg": {"point_dim": 7, "dof": 6}}


def test_the_least_time_of_two_33k_reads_by_hand():
    """102 FP32 operations a pair (the quaternion product 28, the
    difference and its rotation 3 + 15, the rotation vector 8, V^-1 30,
    the scaled square 18) over 67 TFLOP/s: 3.32 ms for two 33,000^2 reads,
    against 0.17 ms of transcendentals (three a pair over 132 SMs x (128
    lanes + 16 SFUs) x 1.98 GHz) and 0.6 us of bytes."""
    assert R.FLOPS_PER_PAIR == 102
    pairs = 2 * 33_000 ** 2
    nbytes = 2 * R.read_bytes(1, 33_000, 33_000, 7, 6)
    assert R.read_bytes(1, 33_000, 33_000, 7, 6) == 4 * (7 * 66_000 + 6
                                                         + 33_000)
    b = R.least_seconds(pairs, nbytes)
    assert b["fp32"] == pytest.approx(pairs * 102 / 6.7e13)
    assert b["fp32"] == pytest.approx(3.317e-3, rel=1e-3)
    assert b["transcendental"] == pytest.approx(3 * pairs / (RATE * 144))
    assert b["bytes"] == pytest.approx(nbytes / 3.35e12)
    assert b["fp32"] == max(b.values())


def test_the_share_reads_the_se3_kernels_and_spans_alone():
    """Two SE(3) reads of 33k x 33k, 8 ms each in the SE(3) prep and
    partial kernels; the shared combine kernel, an SE(2) read's kernels
    and spans, and a span without ``manifold`` count for nothing."""
    pairs = 33_000 ** 2
    events = [("spin_kernel", 0.0, 10.0)]
    t = 10.0
    for _ in range(2):
        for name, d in (("kde_lse_prep<(anonymous namespace)::SE3>", 20.0),
                        ("kde_lse_partial<(anonymous namespace)::SE3>",
                         7_980.0),
                        ("kde_lse_combine", 30.0),
                        ("kde_lse_partial<(anonymous namespace)::SE2>",
                         4_000.0)):
            events.append((f"void (anonymous namespace)::{name}(...)", t,
                           t + d))
            t += d
    snap = {"counters": {"kde_pairs": 2 * pairs + 50_000 ** 2},
            "spans": [_span(33_000, 33_000, pairs),
                      _span(33_000, 33_000, pairs),
                      _span(50_000, 50_000, 50_000 ** 2, "SE2"),
                      _span(10, 10, 100, None)]}
    assert R.kernel_seconds(events) == pytest.approx(16e-3)
    want = 100 * (2 * pairs * 102 / 6.7e13) / 16e-3
    assert R.compute(_ctx(events), snap) == pytest.approx(want)
    assert R.compute(_ctx(events), snap) == pytest.approx(20.73, rel=1e-3)


def test_nothing_to_read_without_an_se3_read_or_its_kernels():
    events = [("kde_lse_partial<SE3>", 0.0, 10.0)]
    # a checkout from before the SE(3) kernel: eager pairs, or spans with
    # no manifold
    eager = {"counters": {"kde_eager_pairs": 5e9},
             "spans": [_span(33_000, 33_000, 0)]}
    assert R.compute(_ctx(events), eager) is None
    old = {"counters": {"kde_pairs": 100}, "spans": [_span(10, 10, 100,
                                                           None)]}
    assert R.compute(_ctx(events), old) is None
    counted = {"counters": {"kde_pairs": 100}, "spans": [_span(10, 10, 100)]}
    assert R.compute({"trace": None, "cfg": {}}, counted) is None
    assert R.compute(_ctx([("kde_lse_partial<SE2>", 0.0, 5.0),
                           ("kde_lse_combine", 5.0, 6.0)]), counted) is None


@pytest.mark.parametrize("members,n,q", [
    (1, 33_000, 33_000), (2, 33_000, 33_000), (1, 33_000, 1),
    (8, 4096, 4096), (1, 300, 997), (64, 100, 100)])
def test_never_above_100_for_a_time_the_kernel_could_give(members, n, q):
    """The kernel does at least the 102 counted operations a pair on the
    FP32 lanes, so it takes at least pairs x 102 over the FP32 rate, and
    at least the bytes' time: at that least time, and above it, the share
    is at most 100 %."""
    pairs = members * n * q
    nbytes = R.read_bytes(members, n, q, 7, 6)
    fastest = max(pairs * 102 / 6.7e13, nbytes / 3.35e12)
    snap = {"counters": {"kde_pairs": pairs},
            "spans": [_span(n, q, pairs)]}
    for t in (fastest, 1.5 * fastest, 10 * fastest):
        events = [("kde_lse_partial<SE3>", 0.0, t * 1e6)]
        got = R.compute(_ctx(events), snap)
        assert 0 < got <= 100.0 * (1 + 1e-9), (t, got)

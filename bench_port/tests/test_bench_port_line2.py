"""The two-variable line cell, ``line2-n50k.mmisam-exact``: its exact
reference against the Laplace one, the marginal check's arithmetic, the
draw metrics' arithmetic, a CPU run with each planted fault, and the cell
added to a copy of the benchmark as new files only."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port import faults
from bench_port.checks import marginals
from bench_port.graphs import line
from bench_port.lib import draw_trace, registry
from bench_port.metrics import draw_device_ms, draw_roofline_pct as R
from bench_port.reference import gaussian, linear_gaussian
from bench_port.reference.manifolds import Rn

from .helpers import cpu_run

CELL = "line2-n50k.mmisam-exact"
#: the marginal limits at a test's particle count: the cell's hold at
#: N=50,000; at 500 particles sound runs on the CPU read up to 0.093,
#: 0.12 and 0.06 (seeds 11, 12 and 3,000,000,017), negated row weights
#: 4.9, 1.2 and 1.0, a dropped factor 0.95, 3.5 and 0.48
TEST_MARG_LIMITS = {"marg_mean_z": 0.3, "marg_log_sd": 0.3, "marg_ks": 0.15}
NEW_FILES = ["configs/line2-n50k.json", "graphs/line.py",
             "traffic/mmisam-exact.json", f"limits/{CELL}.json",
             "checks/marginals.py", "reference/linear_gaussian.py",
             "reference/pair_product.py", "lib/draw_trace.py",
             "metrics/draw_device_ms.py", "metrics/draw_roofline_pct.py"]


def _cfg():
    return registry.cell(registry.benchmark(), CELL)["cfg"]


@pytest.mark.parametrize("seed,step", [(1, 1), (3_000_000_017, 4)])
def test_information_form_agrees_with_the_laplace_reference(seed, step):
    """Two references written apart: the hand-written Cholesky of the
    information form, and Gauss-Newton with central differences on R^1.
    The means agree to 1e-9; the covariances to 5e-9, the rounding of the
    Laplace reference's central differences (step 1e-6, residuals near
    10: 10 x 2.2e-16 / 1e-6 = 2.2e-9 an entry of its Jacobian)."""
    meas = line.measurements(_cfg(), seed, step)
    mean, cov = linear_gaussian.posterior(meas["labels"], meas["factors"])
    M = Rn(1)
    x, S = gaussian.posterior(M, meas["labels"], meas["factors"],
                              gaussian.chain_start(M, meas["labels"],
                                                   meas["factors"]))
    torch.testing.assert_close(mean, x[:, 0], atol=1e-9, rtol=0)
    torch.testing.assert_close(cov, S, atol=5e-9, rtol=0)
    # by hand, priors of sigma 1 and a relative of sigma 10: precision
    # [[1.01, -0.01], [-0.01, 1.01]], determinant 1.02
    torch.testing.assert_close(cov, torch.tensor(
        [[1.01, 0.01], [0.01, 1.01]], dtype=torch.float64) / 1.02)


def test_a_lower_precision_reference_is_that_precision():
    meas = line.measurements(_cfg(), 5, 1)
    mean, _ = linear_gaussian.posterior(meas["labels"], meas["factors"],
                                        "bfloat16")
    assert mean.dtype == torch.bfloat16
    exact, _ = linear_gaussian.posterior(meas["labels"], meas["factors"])
    assert 0 < float((mean.double() - exact).abs().max()) < 0.1
    x = linear_gaussian.marginal_samples(10.0, 2 / 3, 1000, 3, "bfloat16")
    # bfloat16 holds 8 significant bits: near 10 the values lie 1/16 apart
    assert x.dtype == torch.bfloat16
    assert float(((x.double() * 16) - torch.round(x.double() * 16))
                 .abs().max()) == 0.0


def test_the_marginal_gaps_of_known_samples():
    g = torch.Generator().manual_seed(4)
    e = torch.randn(200_000, generator=g, dtype=torch.float64)
    z, sd, ks = marginals.gaps(3.0 + 2.0 * e, 3.0, 4.0)
    assert z < 0.01 and sd < 0.01 and ks < 0.005
    # half an sd off: the KS distance is Phi(0.25) - Phi(-0.25)
    z, sd, ks = marginals.gaps(3.0 + 2.0 * e, 2.0, 4.0)
    assert z == pytest.approx(0.5, abs=0.01)
    assert ks == pytest.approx(0.1974, abs=0.005)
    # twice as wide: ½ log 4
    _, sd, _ = marginals.gaps(3.0 + 4.0 * e, 3.0, 4.0)
    assert sd == pytest.approx(math.log(2), abs=0.01)
    # four particles by hand: the empirical steps against the Gaussian's
    # CDF at 0, 0, 0, 0 are 0.5 below and 0.5 above
    z, sd, ks = marginals.gaps(torch.zeros(4), 0.0, 1.0)
    assert z == 0 and sd == math.inf and ks == pytest.approx(0.5)


def test_the_draw_roofline_by_hand():
    """2.5e9 pairs over 132 SMs x (128 lanes + 16 SFUs) x 1.98 GHz; the
    bytes of one 50k x 50k call at dof 1: 4 x (2 x 50k + 50k + 2 x 50k)
    read and 16 x 50k written, 1.8 MB at 3.35 TB/s."""
    b = R.least_seconds(2.5e9, R.draw_bytes(1, 50_000, 50_000, 50_000, 1))
    assert b["transcendental"] == pytest.approx(2.5e9 / (132 * 144 * 1.98e9))
    assert b["transcendental"] == pytest.approx(66.4e-6, rel=1e-3)
    assert R.draw_bytes(1, 50_000, 50_000, 50_000, 1) == 1.8e6
    assert b["bytes"] == pytest.approx(1.8e6 / 3.35e12)
    # a batch of 2 members is twice the bytes
    assert R.draw_bytes(2, 10, 20, 30, 3) == 2 * (4 * (60 + 10 + 120) + 480)


def _ctx(events, spans, pairs):
    snap = {"spans": spans, "counters": {"draw_pairs": pairs}}
    return {"trace": {"events": events, "steps": 2}}, snap


def test_operations_belong_to_the_draw_by_their_stream_marks():
    """The program's marker ends at 100 us; the draw's marks at 50 and
    250 us after it.  An operation whose middle lies between them is the
    draw's, wherever its start is on the host's clock; the marker is
    not."""
    spans = [{"name": "product.draw", "device_us": (50.0, 250.0),
              "attrs": {"members": 1, "na": 50_000, "nb": 50_000,
                        "rows": 50_000, "dof": 1}},
             {"name": "product", "device_us": None, "attrs": {}}]
    events = [("spin_kernel", 10.0, 100.0), ("before", 101.0, 150.0),
              ("a", 150.0, 250.0), ("b", 250.0, 349.0),
              ("edge", 345.0, 360.0), ("after", 360.0, 500.0)]
    ctx, snap = _ctx(events, spans, 5e9)
    d = draw_trace.read(ctx, snap)
    assert d["ops"] == 2 and d["busy_us"] == pytest.approx(199.0)
    ctx["draw_trace"] = d
    assert draw_device_ms.read(ctx) == pytest.approx(199.0 / 1e3 / 2)
    t = max(R.least_seconds(5e9, R.draw_bytes(1, 50_000, 50_000, 50_000,
                                               1)).values())
    assert R.read(ctx) == pytest.approx(100 * t / 199e-6)
    # a checkout whose spans have no marks gives nothing to read
    for s in spans:
        s["device_us"] = None
    ctx, snap = _ctx(events, spans, 5e9)
    assert draw_trace.read(ctx, snap) is None
    assert draw_trace.read({"trace": None}, snap) is None


def _small(n=500):
    cell = registry.cell(registry.benchmark(), CELL)
    cell["cfg"]["N"] = n
    cell["limits"].update(TEST_MARG_LIMITS)
    return cell


FAULTS = [("unsolved", "unsolved"), ("half_stale", "stale_share"),
          ("dropped_factor", "marg_log_sd"), ("inverted_rows", "marg_ks"),
          ("wide_bw", "bw_base_gap")]


@pytest.mark.parametrize("fault,number", FAULTS, ids=[f[0] for f in FAULTS])
def test_a_broken_step_of_the_line_is_not_correct(fault, number,
                                                  kernel_path, monkeypatch):
    cell = _small()
    rc, line, err = cpu_run(cell)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["checks"]) == {"unsolved", "bad_particles",
                                   "stale_share", "bw_base_gap",
                                   *TEST_MARG_LIMITS}
    monkeypatch.setattr(*faults.patch(fault))
    rc, line, err = cpu_run(cell)
    assert rc == 0 and line["correct"] is False, err
    c = line["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"]


def test_the_cell_is_added_as_new_files_only(tmp_path):
    """A copy of the benchmark without the cell's files and entries; the
    files and entries added back, nothing else edited, and the cell runs
    through ``registry.cell``."""
    root = registry.ROOT
    shutil.copytree(os.path.join(root, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in NEW_FILES:
        os.remove(tmp_path / "bench_port" / f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    stripped = json.loads(json.dumps(bench))
    stripped["configs"] = [c for c in bench["configs"]
                           if c["name"] != "line2-n50k"]
    stripped["workloads"] = [w for w in bench["workloads"]
                             if w["name"] != CELL]
    stripped["per_layer"] = [m for m in bench["per_layer"]
                             if not m["name"].startswith("draw_")]
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*")
              if p.is_file()}
    for f in NEW_FILES:
        shutil.copy(os.path.join(root, "bench_port", f),
                    tmp_path / "bench_port" / f)
    added = json.loads(json.dumps(stripped))
    for key in ("configs", "workloads", "per_layer"):
        added[key] += [x for x in bench[key] if x not in stripped[key]]
    assert added == bench
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    script = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from bench_port import run\n"
        "from bench_port.lib import registry\n"
        "from incrementalinference_torch.ops import product\n"
        "product.LARGE_PAIR_THRESHOLD = 1\n"
        "b = registry.benchmark()\n"
        f"cell = registry.cell(b, {CELL!r})\n"
        "cell['cfg']['N'] = 400\n"
        f"cell['limits'].update({TEST_MARG_LIMITS!r})\n"
        f"a = run.parse(['--workload', {CELL!r}, '--seed', '5',"
        " '--seconds', '0.05', '--trace', '0'])\n"
        "run.execute(a, b, cell, torch.device('cpu'))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": root})
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, p.stderr[-3000:]
    after = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())

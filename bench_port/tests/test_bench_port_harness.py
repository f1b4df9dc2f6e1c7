"""The harness: everything found by name, the contract's shapes, a cell
added as new files only, the result line, no run without a card."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_port import run
from bench_port.lib import registry

from .helpers import TEST_POSE_LIMITS, cpu_run

ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names(kind, ext):
    d = os.path.join(ROOT, "bench_port", kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def test_every_piece_is_found_by_its_name():
    bench = registry.benchmark()
    cells = [registry.cell(bench, w["name"]) for w in bench["workloads"]]
    for cell in cells:
        assert registry.module("graphs", cell["cfg"]["graph"]).build
        for phase in cell["traffic"]["phases"]:
            assert registry.module("phases", phase).run
        for check in cell["traffic"]["checks"]:
            assert registry.module("checks", check).judge
        assert cell["limits"]
    assert {c["entry"]["name"] for c in cells} == set(
        _names("limits", ".json"))
    assert {c["cfg"]["name"] for c in cells} == set(
        _names("configs", ".json"))
    assert {c["entry"]["traffic"] for c in cells} == set(
        _names("traffic", ".json"))
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert registry.module("metrics", m["name"]).read
    assert {m["name"] for m in metrics} == set(_names("metrics", ".py"))


def test_benchmark_json_keeps_the_contract():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_port"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in bench["configs"]:
        assert c["file"].startswith("bench_port/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_the_result_line_carries_the_contracts_keys(small_cell):
    rc, line, err = cpu_run(small_cell("se2pair-n50k.mmisam", n=200))
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, err
    assert set(line["metrics"]) == {"step_s", "setup_s"}
    assert all(m["unit"] == "s" for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # the compared numbers beside their limits, last on standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_a_run_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    rc = run.main(["--workload", "se2pair-n50k.mmisam", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_a_checkout_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "se2pair-n50k.mmisam", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""


DUMMY_METRIC = '''
def read(ctx):
    return float(len(ctx["spans"]["pause"]))
'''

DUMMY_PHASE = '''
def run(runner, state):
    state["out"]["paused"] = True
'''


def test_a_cell_metric_and_mix_are_added_as_new_files_only(tmp_path):
    """A configuration, a traffic mix with a phase of its own, a per-layer
    metric and a cell added in a copy, with new files and entries and no
    edit of a file's text."""
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*")
              if p.is_file()}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = json.loads((tmp_path / "bench_port/configs/se2pair-n50k.json")
                     .read_text())
    cfg.update(name="se2pair-n64", N=64)
    (tmp_path / "bench_port/configs/se2pair-n64.json").write_text(
        json.dumps(cfg))
    (tmp_path / "bench_port/phases/pause.py").write_text(DUMMY_PHASE)
    (tmp_path / "bench_port/traffic/mmisam-pause.json").write_text(json.dumps(
        {"phases": ["build", "solve", "pause"], "algorithm": "default",
         "graphinit": True, "checks": {"beliefs": 0}}))
    (tmp_path / "bench_port/limits/se2pair-n64.mmisam-pause.json"
     ).write_text(json.dumps({"unsolved": 0, "bad_particles": 0,
                              "stale_share": 0.01, **TEST_POSE_LIMITS}))
    (tmp_path / "bench_port/metrics/pauses_counted.py").write_text(
        DUMMY_METRIC)
    bench["configs"].append({"name": "se2pair-n64", "source": "test",
                             "file": "bench_port/configs/se2pair-n64.json",
                             "reduced": ["N"], "why": "test"})
    bench["workloads"].append({"name": "se2pair-n64.mmisam-pause",
                               "config": "se2pair-n64",
                               "traffic": "mmisam-pause", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "pauses_counted", "unit": "pauses",
                               "better": "higher", "source": "program_span",
                               "layer": "API solve (api.solve_tree)",
                               "moves": "step_s",
                               "workloads": ["se2pair-n64.mmisam-pause"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from bench_port import run\n"
        "from bench_port.lib import registry\n"
        "run.TRACE_STEPS = 0  # no profiler without a card\n"
        "b = registry.benchmark()\n"
        "for t in ('0', '1'):\n"
        "    a = run.parse(['--workload', 'se2pair-n64.mmisam-pause',"
        " '--seed', '5', '--seconds', '0.05', '--trace', t])\n"
        "    run.execute(a, b, registry.cell(b, a.workload),"
        " torch.device('cpu'))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.splitlines()
             if x.startswith("{")]
    assert lines[0]["correct"] is True, p.stderr[-3000:]
    assert set(lines[0]["checks"]) == {"unsolved", "bad_particles",
                                       "stale_share", *TEST_POSE_LIMITS}
    assert lines[1]["metrics"]["pauses_counted"]["value"] >= 1
    after = {p: p.read_bytes() for p in (tmp_path / "bench_port").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())

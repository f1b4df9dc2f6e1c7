"""Everything a cell needs is found by the names in BENCHMARK.json: a
configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json``, a phase of a step ``phases/<phase>.py``, a
per-layer metric's reader ``metrics/<metric>.py``, a check
``checks/<check>.py``, a cell's limits ``limits/<workload>.json`` and a
graph maker ``graphs/<graph>.py``."""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def data(kind: str, name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "bench_port", kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    return importlib.import_module(f"bench_port.{kind}.{name}")


def cell(bench: dict, workload: str, root: str = ROOT) -> dict:
    """The cell ``workload`` with everything it names: its entry, its
    configuration's entry and file, its traffic and its limits."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    return {"entry": entry, "config": conf, "cfg": cfg,
            "traffic": data("traffic", entry["traffic"], root),
            "limits": data("limits", workload, root)}


def metrics_for(bench: dict, section: str, workload: str) -> list:
    """The metrics of ``section`` that the cell reports: those without a
    ``workloads`` key, and those whose key lists it."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]

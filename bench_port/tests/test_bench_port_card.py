"""Every cell as the benchmark's command runs it, on the card, with a short
window: a result line, `correct` true, the cell's metrics."""

import json
import os
import subprocess
import sys

import pytest

from bench_port.lib import registry


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      registry.benchmark()["workloads"]])
def test_the_cell_runs_and_is_correct_on_the_card(workload, card):
    for trace in ("0", "1"):
        p = subprocess.run(
            [sys.executable, "bench_port/run.py", "--workload", workload,
             "--seed", "3000000123", "--seconds", "2", "--trace", trace],
            cwd=registry.ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ))
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, p.stderr[-3000:]
        assert line["device"]["platform"] == "gpu"
        assert line["metrics"]

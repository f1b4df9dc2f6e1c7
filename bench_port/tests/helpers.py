"""Driving a run's pieces on the CPU."""

import contextlib
import io
import json

import torch

#: the pose limits at a test's particle count: the cells' hold at
#: N=50,000, and at a few hundred particles the Monte Carlo error and the
#: bandwidth are larger (sound runs read up to 0.2 and 0.3 at N=500 on
#: the CPU; inverted row weights 0.72 and more, a dropped factor 4.6)
TEST_POSE_LIMITS = {"pose_mean_z": 0.5, "pose_log_sd": 0.6}


def cpu_run(cell, seed=3_000_000_017, seconds=0.05, trace=0):
    """Runs ``run.execute`` on the CPU; returns (exit code, parsed last
    line or None, standard error)."""
    from bench_port import run
    from bench_port.lib import registry

    args = run.parse(["--workload", cell["entry"]["name"], "--seed",
                      str(seed), "--seconds", str(seconds), "--trace",
                      str(trace)])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.execute(args, registry.benchmark(), cell,
                         torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

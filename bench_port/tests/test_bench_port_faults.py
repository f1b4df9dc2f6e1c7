"""A run with its timed path broken underneath comes out not correct, once
for each fault the cells can have (``bench_port/faults.py``): a solve that
leaves the state as it was, half of the particles left as they were, a
product that drops a factor, the kernel's row weights wrong, a bandwidth
or an estimate altered where it is produced.  (No cell spans chips, so
none can leave out an exchange.)  Driven on the CPU at a test's size, past
the harness's look for a card, every product on the kernel's path."""

import pytest

from bench_port import faults

from .helpers import cpu_run

CASES = [
    ("se2pair-n50k.mmisam", "unsolved", "unsolved"),
    ("se2pair-n50k.mmisam", "half_stale", "stale_share"),
    ("se2pair-n50k.mmisam", "dropped_factor", "pose_log_sd"),
    ("se2pair-n50k.mmisam", "inverted_rows", "pose_mean_z"),
    ("se2pair-n50k.mmisam", "wide_bw", "bw_base_gap"),
    ("se2pair-n50k.mmisam-ppe", "shifted_mean", "ppe_mean_gap"),
]


@pytest.mark.parametrize("workload,fault,number", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_a_broken_step_is_not_correct(workload, fault, number, small_cell,
                                      kernel_path, monkeypatch):
    cell = small_cell(workload)
    rc, line, err = cpu_run(cell)
    assert rc == 0 and line["correct"] is True, err
    monkeypatch.setattr(*faults.patch(fault))
    rc, line, err = cpu_run(cell)
    assert rc == 0 and line["correct"] is False, err
    c = line["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"]

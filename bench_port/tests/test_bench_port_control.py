"""The control, at a test's size on the CPU: the program's readings keep
each cell's limits, and the reference in bfloat16, put in the program's
place, fails at least one.  (On the card, at the cells' sizes:
``bench_port/control.py``.)"""

import pytest
import torch

from bench_port import control


@pytest.mark.parametrize("workload", ["se2pair-n50k.mmisam",
                                      "se2pair-n50k.mmisam-ppe"])
def test_the_control_fails_where_the_program_passes(workload, small_cell,
                                                    kernel_path):
    cell = small_cell(workload)
    got = control.readings(cell, 3_000_000_101, 2, ["bfloat16"],
                           torch.device("cpu"), lambda: None)
    limits = cell["limits"]
    assert all(got["program"][k] <= lim for k, lim in limits.items()), got
    assert any(got["bfloat16"][k] > lim for k, lim in limits.items()), got

"""The checks that decide `correct`, one file each.  ``judge(records, ctx,
source)`` returns (numbers, diagnostics): the numbers are held to the
cell's limits, the diagnostics are printed only.  ``source`` is
``"program"`` for the port's outputs, or a precision (``"bfloat16"``,
``"tf32"``) for the control: the reference in that precision put in the
port's place for the stages it recomputes."""

from __future__ import annotations

import math


def worst(a, b):
    """The larger of two readings, NaN winning."""
    if a is None:
        return b
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return max(a, b)

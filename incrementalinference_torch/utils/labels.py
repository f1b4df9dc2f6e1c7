"""Label utilities (reference incrSuffix); counterpart of
``incrementalinference/jl_tpu/utils/labels.py``."""

from __future__ import annotations

import re

__all__ = ["incr_suffix"]


def incr_suffix(label: str, val: int = 1, pattern: str = r"\d+") -> str:
    """Increment the last numeric run in a label: ``incr_suffix("x45_4") ==
    "x45_5"``, ``incr_suffix("x45", 3) == "x48"``, ``incr_suffix("x45_4",
    -1) == "x45_3"`` (reference incrSuffix semantics + test
    testBasicGraphs.jl:11-15)."""
    matches = list(re.finditer(pattern, label))
    if not matches:
        raise ValueError(f"no suffix matching {pattern!r} in {label!r}")
    m = matches[-1]
    return label[:m.start()] + str(int(m.group()) + val) + label[m.end():]

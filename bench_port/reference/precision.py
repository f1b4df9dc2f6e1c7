"""How a reference runs in a given precision.

``"float64"`` is the reference.  ``"bfloat16"`` casts every input to
bfloat16 and computes there.  ``"tf32"`` computes in float32 with matrix
products on TF32 (the card's tensor-core float32 mode); on a CPU it is
plain float32, since a CPU has no TF32.
"""

from __future__ import annotations

import contextlib

import torch

DTYPES = {"float64": torch.float64, "tf32": torch.float32,
          "bfloat16": torch.bfloat16}


def dtype_of(precision: str) -> torch.dtype:
    return DTYPES[precision]


@contextlib.contextmanager
def matmul_mode(precision: str):
    """TF32 products for ``"tf32"``, IEEE float32 for everything else; the
    caller's settings come back afterwards."""
    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        saved = mm.fp32_precision
        mm.fp32_precision = "tf32" if precision == "tf32" else "ieee"
    else:
        saved = mm.allow_tf32
        mm.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        if hasattr(mm, "fp32_precision"):
            mm.fp32_precision = saved
        else:
            mm.allow_tf32 = saved

"""Native (C++) constrained min-degree ordering.

The port's own copy of ``incrementalinference/jl_tpu/native``: builds
``build/libiitpu_torch_ordering-<digests>.so`` from ``ordering.cpp`` with
g++ at first use and binds it with ctypes.  The digests name the source, the
flags and the compiler (``libcache``), so a library built from anything else
is never loaded.  When the build is unavailable, tree/ordering.py falls back
to its Python heuristic and logs a warning.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..libcache import Library

__all__ = ["native_ccolamd", "native_available"]

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
LIBRARY = Library(stem="libiitpu_torch_ordering",
                  src=os.path.join(_HERE, "ordering.cpp"),
                  build_dir=os.path.join(_HERE, "build"),
                  compiler=lambda: "g++",
                  flags=("-O2", "-shared", "-fPIC", "-std=c++17"))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED = False
#: seconds the g++ build took (None: loaded an existing build)
build_seconds: Optional[float] = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _FAILED, build_seconds
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        try:
            lib, build_seconds = LIBRARY.load()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native ordering did not build or load: %s", e)
            _FAILED = True
            return None
        lib.iitpu_ccolamd.restype = ctypes.c_int32
        lib.iitpu_ccolamd.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def native_ccolamd(n_vars: int, factor_vars: Sequence[Sequence[int]],
                   cmember: Optional[Sequence[int]] = None
                   ) -> Optional[List[int]]:
    """Constrained min-degree order from the C++ library; None when the
    native path is unavailable.  ``cmember``: 0 = free, 1 = last."""
    lib = _load()
    if lib is None:
        return None
    fptr = np.zeros(len(factor_vars) + 1, np.int32)
    for i, vs in enumerate(factor_vars):
        fptr[i + 1] = fptr[i] + len(vs)
    fv = np.asarray([v for vs in factor_vars for v in vs], np.int32)
    if fv.size == 0:
        fv = np.zeros(1, np.int32)
    cm = (np.zeros(n_vars, np.int32) if cmember is None
          else np.asarray(cmember, np.int32))
    out = np.zeros(n_vars, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.iitpu_ccolamd(np.int32(n_vars), np.int32(len(factor_vars)),
                           ptr(fptr), ptr(fv), ptr(cm), ptr(out))
    if rc != 0:
        return None
    return out.tolist()

"""Content-addressed builds of the port's compiled libraries.

The port compiles four libraries at first use: the row-logsumexp kernel
(``ops/kernels/csrc/row_lse.cu``, with nvcc), the column draw's kernel
(``ops/kernels/csrc/pair_draw.cu``, with nvcc), the KDE read's kernel
(``ops/kernels/csrc/kde_lse.cu``, with nvcc) and the native elimination
ordering (``native/ordering.cpp``, with g++).  A library's file name carries
what it was built from: a digest of the source file's bytes and the
compiler flags, then a digest of the compiler's ``--version`` output, as in
``build/librow_lse-<sha256[:16]>-<sha256[:8]>.so``.  A loader looks up only
the name its own source, flags and compiler give, so a library built from
anything else (an edited source, other flags, another compiler, a stale
copy from a warm-start pack) is never loaded: a mismatch is a miss and a
build, as an entry of JAX's persistent compilation cache is a miss and not
an error.  A process without the compiler cannot ask its version: it loads
a build of the same source and flags by whichever compiler made it (a
seeded pack's), and raises the compiler's error when there is none.

A build writes ``<name>.<pid>.tmp`` and renames it into place, so processes
that build at once never load a half-written file.  Each load counts one
event into every dict that :func:`warmstart.install_hit_counter` handed
out: ``hits`` when the library was loaded from an existing file,
``misses`` when the compiler ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import subprocess
import threading
import time
from typing import Callable, Optional, Sequence

__all__ = ["Library", "compiler_version", "add_listener"]

_listeners: list[dict] = []
# ``counts[event] += 1`` is a read and a write: threads loading at once
# would lose counts without it
_listeners_lock = threading.Lock()


def add_listener(counts: dict) -> None:
    """Count every later load into ``counts`` (keys ``hits``, ``misses``)."""
    with _listeners_lock:
        _listeners.append(counts)


def _count(event: str) -> None:
    with _listeners_lock:
        for counts in _listeners:
            counts[event] += 1


@functools.lru_cache(maxsize=None)
def compiler_version(exe: str) -> str:
    """What ``exe --version`` prints, asked once per process."""
    return subprocess.run([exe, "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def digest(src: str, flags: Sequence[str]) -> str:
    """sha256[:16] of the source's bytes and the flags."""
    h = hashlib.sha256()
    with open(src, "rb") as fp:
        h.update(fp.read())
    h.update(b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Library:
    """One compiled library: ``<build_dir>/<stem>-<digest>-<compiler>.so``
    built from ``src`` by ``compiler()`` (a path to the executable) with
    ``flags``."""

    stem: str
    src: str
    build_dir: str
    compiler: Callable[[], str]
    flags: tuple[str, ...]

    def prefix(self) -> str:
        """``<stem>-<digest of source and flags>``: the part of the name
        that needs no compiler."""
        return f"{self.stem}-{digest(self.src, self.flags)}"

    def path(self, build_dir: Optional[str] = None) -> str:
        """The name this library's loader looks up.  Without the compiler,
        an existing build of this source and flags by any compiler; with
        none either, the compiler's error."""
        build_dir = build_dir or self.build_dir
        prefix = self.prefix()
        try:
            version = compiler_version(self.compiler())
        except (OSError, RuntimeError, subprocess.SubprocessError):
            pattern = re.compile(re.escape(prefix) + r"-[0-9a-f]{8}\.so")
            found = sorted(n for n in (os.listdir(build_dir)
                                       if os.path.isdir(build_dir) else ())
                           if pattern.fullmatch(n))
            if found:
                return os.path.join(build_dir, found[0])
            raise
        tag = hashlib.sha256(version.encode()).hexdigest()[:8]
        return os.path.join(build_dir, f"{prefix}-{tag}.so")

    def ensure(self, build_dir: Optional[str] = None,
               extra_flags: Sequence[str] = (), verbose: bool = False
               ) -> tuple[str, Optional[float]]:
        """(path, compiler seconds): compile when the path does not exist
        yet; the seconds are None when it did.  ``extra_flags`` change what
        the compiler prints, not what it builds, and are not in the name."""
        path = self.path(build_dir)
        if os.path.exists(path):
            return path, None
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        try:
            r = subprocess.run([self.compiler(), *self.flags, *extra_flags,
                                "-o", tmp, self.src], capture_output=True,
                               text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"{os.path.basename(self.compiler())} "
                                   f"failed on {self.src}:\n{r.stderr}")
            if verbose and r.stderr:
                print(r.stderr.strip())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path, time.perf_counter() - t0

    def load(self, extra_flags: Sequence[str] = (), verbose: bool = False
             ) -> tuple[ctypes.CDLL, Optional[float]]:
        """(library, compiler seconds or None), counting the load."""
        path, seconds = self.ensure(extra_flags=extra_flags, verbose=verbose)
        if seconds is not None:
            _count("misses")
        lib = ctypes.CDLL(path)
        if seconds is None:
            _count("hits")
        return lib, seconds

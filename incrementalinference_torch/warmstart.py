"""Warm start: the port's compiled libraries, seeded before the first solve.

Counterpart of ``incrementalinference/jl_tpu/warmstart.py``.  The JAX
package's cold start is XLA compiling its solver programs, and its pack
ships them compiled.  The port runs eagerly and compiles no program for
each structure: its cold start is the compiler runs at first use, nvcc of
the row-logsumexp kernel (``ops/kernels/row_lse.py``), of the large pair
product's column draw (``ops/kernels/pair_draw.py``) and of the KDE read's
kernel (``ops/kernels/kde_lse.py``, at the first estimate read on the card)
and g++ of the native ordering (``native/``).  A pack
(``aotcache/cuda-sm90a/`` beside this file, listed in ``.gitignore``: the
repository holds sources only) holds those libraries under the names their
loaders look up, with a ``MANIFEST.json``.
:func:`seed_cache` copies them into the loaders' build directories, so a
fresh process's first solve loads them instead of compiling them.  Write a
pack on a machine with the card and nvcc::

    python -m incrementalinference_torch.warmstart [--dest DIR]

Safety: a library's file name is a digest of its source and its compiler
flags, then one of its compiler's ``--version`` output (``libcache``), so an
entry built from anything else is never looked up: a MISS, not an error,
and seeding is harmless on other toolchains.  A process without the
compiler loads a pack's build of the same source and flags, whichever
compiler made it: no compiler is needed to use a pack, only to write one.
:func:`seed_cache` compares the manifest's versions with this process's and
logs ONE line when they differ.  :func:`install_hit_counter` counts the loaders' hits (a library
loaded from an existing file) and misses (a compiler ran).

The JAX module's caveat that XLA:CPU AOT executables can abort on a
machine-feature mismatch has no counterpart: the ordering is built without
``-march`` flags, and a kernel built for ``sm_90a`` on another card fails
its launch with a CUDA error, which the wrapper raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import platform
import shutil
import subprocess
import sys
import tempfile

from . import libcache

__all__ = ["seed_cache", "write_manifest", "install_hit_counter"]

logger = logging.getLogger("iitpu.warmstart")

_PACKS = {"cuda": "cuda-sm90a"}
_MANIFEST = "MANIFEST.json"


def _pack_dir(backend: str) -> str | None:
    pack = _PACKS.get(backend)
    if pack is None:
        return None
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "aotcache", pack)
    return src if os.path.isdir(src) else None


def _libraries() -> tuple:
    """The port's compiled libraries, each beside the name of its
    compiler."""
    from .native import LIBRARY as ordering
    from .ops.kernels.kde_lse import LIBRARY as kde
    from .ops.kernels.pair_draw import LIBRARY as draw
    from .ops.kernels.row_lse import LIBRARY as kernel

    return (("nvcc", kernel), ("nvcc", draw), ("nvcc", kde),
            ("g++", ordering))


def _library_of(entry: str):
    for _, lib in _libraries():
        if entry.startswith(f"{lib.stem}-") and entry.endswith(".so"):
            return lib
    return None


def _versions() -> dict:
    """What a pack's entries were built with, as this process sees it."""
    import torch

    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    for name, lib in _libraries():
        try:
            out[name] = libcache.compiler_version(lib.compiler())
        except (OSError, RuntimeError, subprocess.SubprocessError):
            out[name] = None
    return out


def write_manifest(pack_dir: str) -> None:
    """Record the building environment and each entry's source digest in
    the pack (called by :func:`write_pack`)."""
    import torch

    entries = {}
    for name in sorted(os.listdir(pack_dir)):
        lib = _library_of(name)
        if lib is None:
            continue
        with open(lib.src, "rb") as fp:
            entries[name] = {"source": os.path.basename(lib.src),
                             "source_sha256":
                                 hashlib.sha256(fp.read()).hexdigest()}
    device = capability = None
    if torch.cuda.is_available():
        device = torch.cuda.get_device_name(0)
        capability = list(torch.cuda.get_device_capability(0))
    with open(os.path.join(pack_dir, _MANIFEST), "w") as fp:
        json.dump({**_versions(), "device": device,
                   "capability": capability,
                   "platform": platform.platform(),
                   "n_entries": len(entries), "entries": entries}, fp,
                  indent=1)


def write_pack(pack_dir: str, libraries) -> None:
    """Make ``pack_dir`` hold exactly the built ``libraries`` (paths under
    their content-addressed names) and a manifest."""
    os.makedirs(pack_dir, exist_ok=True)
    for name in os.listdir(pack_dir):
        if name == _MANIFEST or _library_of(name) is not None:
            os.remove(os.path.join(pack_dir, name))
    for path in libraries:
        shutil.copyfile(path, os.path.join(pack_dir, os.path.basename(path)))
    write_manifest(pack_dir)


def seed_cache(dest: str | None = None, backend: str = "cuda",
               report: dict | None = None) -> int:
    """Copy the pack's libraries into their loaders' build directories (or
    all into ``dest``).  Existing entries are kept.  Returns the number of
    entries copied; 0 when there is nothing applicable (unknown backend,
    no pack, or all present).

    ``report``, when given, is filled with ``copied`` / ``present`` /
    ``pack_entries`` / ``version_match`` for caller-side assertions."""
    rep = report if report is not None else {}
    rep.update({"copied": 0, "present": 0, "pack_entries": 0,
                "version_match": None})
    src = _pack_dir(backend)
    if src is None:
        return 0

    manifest_path = os.path.join(src, _MANIFEST)
    if os.path.exists(manifest_path):
        with open(manifest_path) as fp:
            man = json.load(fp)
        mine = _versions()
        differ = {k: (man.get(k), v) for k, v in mine.items()
                  if man.get(k) != v}
        rep["version_match"] = not differ
        if differ:
            # the names embed the compilers' versions: where this process
            # has a compiler, another toolchain's entries are never looked up
            logger.warning(
                "warm-start pack was built with other versions (pack, this "
                "process): %s; entries built by another compiler will MISS "
                "(harmless, but no cold-start win)",
                "; ".join(f"{k} {a!r}, {b!r}" for k, (a, b) in
                          differ.items()))

    n = present = total = 0
    for name in sorted(os.listdir(src)):
        lib = _library_of(name)
        if lib is None:
            continue
        total += 1
        d = os.path.join(dest or lib.build_dir, name)
        if os.path.exists(d):
            present += 1
            continue
        os.makedirs(os.path.dirname(d), exist_ok=True)
        # copy, then rename into place: a loader never finds half a file
        tmp = f"{d}.{os.getpid()}.tmp"
        shutil.copyfile(os.path.join(src, name), tmp)
        os.replace(tmp, d)
        n += 1
    rep.update({"copied": n, "present": present, "pack_entries": total})
    return n


def install_hit_counter() -> dict:
    """Count the loaders' loads from now on; returns the live counter dict
    (keys ``hits``: loaded from an existing content-addressed file,
    ``misses``: a compiler ran).  A seeded pack that serves the first
    solve shows hits and no misses."""
    counts = {"hits": 0, "misses": 0}
    libcache.add_listener(counts)
    return counts


def main(argv=None) -> int:
    """Build the libraries from this checkout's sources into a fresh
    temporary directory and write them, with a manifest, as the pack."""
    ap = argparse.ArgumentParser(
        prog="python -m incrementalinference_torch.warmstart",
        description=main.__doc__)
    ap.add_argument("--dest", default=None,
                    help="pack directory (default: this package's "
                         f"aotcache/{_PACKS['cuda']})")
    args = ap.parse_args(argv)
    dest = args.dest or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "aotcache",
        _PACKS["cuda"])
    with tempfile.TemporaryDirectory() as tmp:
        built = []
        for name, lib in _libraries():
            try:
                path, seconds = lib.ensure(build_dir=tmp)
            except (OSError, RuntimeError,
                    subprocess.SubprocessError) as e:
                print(f"warmstart: cannot build {os.path.basename(lib.src)} "
                      f"with {name}: {e}; no pack written", file=sys.stderr)
                return 1
            print(f"built {os.path.basename(path)} with {name} in "
                  f"{seconds:.2f} s")
            built.append(path)
        write_pack(dest, built)
    print(f"wrote {len(built)} entries and {_MANIFEST} to {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

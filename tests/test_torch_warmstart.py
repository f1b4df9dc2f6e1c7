"""The port's warm start (warmstart.py) and the content-addressed builds
of its two compiled libraries (libcache.py), against the JAX package's
jl_tpu/warmstart.py.

On the CPU only the ordering library can be built (g++); the kernel's name
and its lookup without nvcc are tested here, and its pack and build run on
the card in chip_smoke.py's phase_warmstart."""

import dataclasses
import inspect
import json
import logging
import os
import re
import shutil
import subprocess

import pytest

import torch_port_helpers  # noqa: F401 — two torch threads a worker

from incrementalinference.jl_tpu import warmstart as jws
from incrementalinference_torch import libcache, native
from incrementalinference_torch import warmstart as ws
from incrementalinference_torch.ops.kernels import row_lse as K

_PROBE = '\nextern "C" int iitpu_probe(void) { return 7; }\n'


@pytest.fixture
def ordering(tmp_path, monkeypatch):
    """The port's ordering loader on a copy of its source, building into
    ``tmp_path/build``, with nothing loaded yet in this process."""
    src = tmp_path / "src" / "ordering.cpp"
    src.parent.mkdir()
    shutil.copyfile(native.LIBRARY.src, src)
    lib = dataclasses.replace(native.LIBRARY, src=str(src),
                              build_dir=str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIBRARY", lib)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_FAILED", False)
    monkeypatch.setattr(native, "build_seconds", None)
    return lib


def _pack(tmp_path, monkeypatch, lib):
    """A pack holding the g++-built ordering library, where seed_cache
    looks for the "cuda" pack."""
    path, seconds = lib.ensure(build_dir=str(tmp_path / "built"))
    assert seconds is not None
    pack = tmp_path / "pack"
    ws.write_pack(str(pack), [path])
    monkeypatch.setattr(ws, "_pack_dir", lambda backend: (
        str(pack) if backend == "cuda" else None))
    return pack, os.path.basename(path)


def _compiler_runs(monkeypatch):
    """The argv of every compiler run from now on (``--version`` queries
    are not builds)."""
    runs = []
    real = subprocess.run

    def run(cmd, *a, **k):
        if "--version" not in cmd:
            runs.append(cmd)
        return real(cmd, *a, **k)

    monkeypatch.setattr(subprocess, "run", run)
    return runs


def test_surface_matches_jax():
    assert ws.__all__ == jws.__all__
    for name in jws.__all__:
        assert (list(inspect.signature(getattr(ws, name)).parameters)
                == list(inspect.signature(getattr(jws, name)).parameters)
                ), name
    assert ws._PACKS == {"cuda": "cuda-sm90a"}


def test_no_pack_seeds_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(ws, "_PACKS", {"cuda": "no-such-pack"})
    rep = {}
    assert ws.seed_cache(dest=str(tmp_path), report=rep) == 0
    assert rep == {"copied": 0, "present": 0, "pack_entries": 0,
                   "version_match": None}
    assert ws.seed_cache(dest=str(tmp_path), backend="tpu") == 0
    assert os.listdir(tmp_path) == []


def test_seed_is_idempotent_and_reports_like_jax(tmp_path, monkeypatch,
                                                 ordering):
    pack, name = _pack(tmp_path, monkeypatch, ordering)
    man = json.loads((pack / "MANIFEST.json").read_text())
    assert man["n_entries"] == 1
    assert set(man["entries"]) == {name}
    assert man["entries"][name]["source"] == "ordering.cpp"
    assert re.fullmatch(r"[0-9a-f]{64}",
                        man["entries"][name]["source_sha256"])
    for key in ("torch", "cuda", "nvcc", "g++", "device", "capability",
                "platform"):
        assert key in man, key
    dest = tmp_path / "cache"
    rep = {}
    assert ws.seed_cache(dest=str(dest), report=rep) == 1
    assert os.listdir(dest) == [name]
    assert rep == {"copied": 1, "present": 0, "pack_entries": 1,
                   "version_match": True}
    assert ws.seed_cache(dest=str(dest), report=rep) == 0
    assert rep["present"] == 1 and rep["copied"] == 0
    jrep = {}
    jws.seed_cache(dest=str(tmp_path / "jax-cache"), report=jrep)
    assert set(rep) == set(jrep)


def test_version_mismatch_warns_once(tmp_path, monkeypatch, ordering,
                                     caplog):
    pack, _ = _pack(tmp_path, monkeypatch, ordering)
    man_path = pack / "MANIFEST.json"
    man = json.loads(man_path.read_text())
    man["torch"] = "0.0.1"
    man_path.write_text(json.dumps(man))
    rep = {}
    with caplog.at_level(logging.WARNING, logger="iitpu.warmstart"):
        assert ws.seed_cache(dest=str(tmp_path / "cache"), report=rep) == 1
    warnings = [r for r in caplog.records if r.name == "iitpu.warmstart"]
    assert len(warnings) == 1, warnings
    assert "0.0.1" in warnings[0].getMessage()
    assert rep["version_match"] is False


def test_seeded_ordering_loads_without_a_build(tmp_path, monkeypatch,
                                                ordering):
    _, name = _pack(tmp_path, monkeypatch, ordering)
    monkeypatch.setattr(native, "LIBRARY", dataclasses.replace(
        ordering, build_dir=str(tmp_path / "fresh")))
    rep = {}
    assert ws.seed_cache(report=rep) == 1        # into the loader's dir
    assert os.listdir(tmp_path / "fresh") == [name]
    counts = ws.install_hit_counter()
    runs = _compiler_runs(monkeypatch)
    assert native.native_available()
    assert counts == {"hits": 1, "misses": 0}
    assert runs == [] and native.build_seconds is None


def test_edited_source_misses_the_seeded_library(tmp_path, monkeypatch,
                                                 ordering):
    _, name = _pack(tmp_path, monkeypatch, ordering)
    assert ws.seed_cache() == 1
    with open(ordering.src, "a") as fp:
        fp.write(_PROBE)
    counts = ws.install_hit_counter()
    runs = _compiler_runs(monkeypatch)
    assert native.native_available()
    assert counts == {"hits": 0, "misses": 1}
    assert len(runs) == 1 and runs[0][0] == "g++"
    assert native.build_seconds is not None
    built = sorted(os.listdir(ordering.build_dir))
    assert name in built and len(built) == 2     # the seeded one unread
    assert native._LIB.iitpu_probe() == 7


def test_stale_library_newer_than_its_source_is_not_loaded(ordering):
    """The rule this replaces rebuilt only when the library was older than
    the source, so a library copied into place after an edit loaded."""
    stale, seconds = ordering.ensure()
    assert seconds is not None
    with open(ordering.src, "a") as fp:
        fp.write(_PROBE)
    later = os.path.getmtime(ordering.src) + 3600
    os.utime(stale, (later, later))
    assert native.native_available()
    assert ordering.path() != stale
    assert native._LIB.iitpu_probe() == 7


def _no_compiler():
    raise RuntimeError("nvcc not found")


def test_kernel_name_by_source_flags_and_nvcc(tmp_path, monkeypatch):
    v = "Cuda compilation tools, release 12.8, V12.8.93"
    monkeypatch.setattr(libcache, "compiler_version", lambda exe: v)
    lib = dataclasses.replace(K.LIBRARY, compiler=lambda: "nvcc")
    path = lib.path()
    assert os.path.dirname(path) == K.LIBRARY.build_dir
    assert re.fullmatch(r"librow_lse-[0-9a-f]{16}-[0-9a-f]{8}\.so",
                        os.path.basename(path))
    assert os.path.basename(path).startswith(lib.prefix() + "-")
    assert "arch=compute_90a,code=sm_90a" in K.LIBRARY.flags
    assert lib.path() == path
    src = tmp_path / "row_lse.cu"
    shutil.copyfile(K.LIBRARY.src, src)
    copy = dataclasses.replace(lib, src=str(src))
    assert copy.path() == path
    with open(src, "a") as fp:
        fp.write("// edited\n")
    assert copy.path() != path
    assert dataclasses.replace(lib, flags=lib.flags[2:]).path() != path
    monkeypatch.setattr(libcache, "compiler_version", lambda exe: v + "x")
    other = lib.path()
    assert other != path and other.startswith(path[:-len("-12345678.so")])


def test_kernel_found_without_nvcc(tmp_path):
    """A seeded build of the kernel's source and flags is found where nvcc
    is missing; a build of another source is not; with none, nvcc's error
    stands (no fallback)."""
    lib = dataclasses.replace(K.LIBRARY, compiler=_no_compiler,
                              build_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.path()
    src = tmp_path / "other.cu"
    shutil.copyfile(K.LIBRARY.src, src)
    with open(src, "a") as fp:
        fp.write("// another source\n")
    other = dataclasses.replace(lib, src=str(src)).prefix()
    (tmp_path / f"{other}-0123abcd.so").write_bytes(b"")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.path()
    seeded = tmp_path / f"{lib.prefix()}-89abcdef.so"
    seeded.write_bytes(b"")
    assert lib.path() == str(seeded)
    assert lib.ensure() == (str(seeded), None)


def test_seeded_ordering_loads_without_gxx(tmp_path, monkeypatch, ordering):
    """A pack serves a machine without g++: the seeded ordering library is
    found by its source and flags and loaded, a hit."""
    _, name = _pack(tmp_path, monkeypatch, ordering)
    monkeypatch.setattr(native, "LIBRARY", dataclasses.replace(
        ordering, build_dir=str(tmp_path / "fresh"),
        compiler=lambda: str(tmp_path / "no-such-g++")))
    with pytest.raises(OSError):
        native.LIBRARY.path()
    assert ws.seed_cache() == 1
    counts = ws.install_hit_counter()
    runs = _compiler_runs(monkeypatch)
    assert native.native_available()
    assert counts == {"hits": 1, "misses": 0}
    assert runs == [] and native.build_seconds is None
    assert native.LIBRARY.path() == str(tmp_path / "fresh" / name)
    order = native.native_ccolamd(4, [[0, 1], [1, 2], [2, 3]], [0, 0, 0, 1])
    assert sorted(order) == [0, 1, 2, 3] and order[-1] == 3


def test_pack_script_refuses_without_nvcc(tmp_path, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(K, "LIBRARY", dataclasses.replace(
        K.LIBRARY, compiler=no_nvcc))
    dest = tmp_path / "pack"
    assert ws.main(["--dest", str(dest)]) == 1
    assert not dest.exists()

"""Row-logsumexp of the pair-product weight matrix: CUDA kernel and plain
version.

Counterpart of ``incrementalinference/jl_tpu/ops/kernels/pallas_product.py``.
The belief-product cascade needs, for every kernel i of mixture A, the
log-partition ``log Σ_j exp(logW_ij)`` over mixture B's kernels, with

    logW_ij = -0.5 (a2_i + Σ_d iva_id·μB_jd² − 2 Σ_d ivmuA_id·μB_jd).

At N = 50k the (Na, Nb) matrix would be 10 GB, so the kernel
(``csrc/row_lse.cu``, CUDA C++ for ``sm_90a``) streams B through shared
memory with an online (reference, sum-exp2) and never builds it.

- :func:`row_logsumexp` is the wrapper.  For a CUDA tensor it launches the
  kernel or raises; for a CPU tensor it takes :func:`row_logsumexp_plain`.
  There is no fallback from one to the other.
- The kernel is built with ``nvcc`` at first use into ``build/`` beside this
  file (listed in ``.gitignore``), under a content-addressed name, and bound
  with ctypes.  ``warmstart.seed_cache`` can put it there beforehand.
- Every function takes an optional leading member axis: B independent
  problems of one shape (a batched level of same-structure cliques) are
  one launch, the kernel taking its member from ``blockIdx.z``.  This is
  what ``jax.vmap`` of the Pallas call does in the JAX package.
- ``counts["launches"]`` counts kernel launches and nothing else,
  ``counts["problems"]`` the members those launches solved;
  ``counts["calls"]`` counts every call of the wrapper, on any device.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading

import torch

from ...libcache import Library

__all__ = ["row_logsumexp", "row_logsumexp_plain", "pair_row_logsumexp",
           "pair_row_terms", "split_plan", "build", "counts", "reset_counts",
           "MAX_DOF", "LIBRARY"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")

#: the kernel holds dof in registers, instantiated for 1..MAX_DOF
MAX_DOF = 8

counts = {"launches": 0, "problems": 0, "calls": 0}
#: solves on several threads count into ``counts`` at once, and ``+=`` on a
#: dict entry is a read and a write
_COUNTS_LOCK = threading.Lock()
_LOCK = threading.Lock()
_LIB = None
#: seconds the last nvcc build took (None: loaded an existing build)
build_seconds = None


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the row_logsumexp CUDA kernel is "
                       "built from csrc/row_lse.cu at first use")


#: ``build/librow_lse-<source and flags>-<nvcc>.so`` (``libcache``), so no
#: library built from anything else loads
LIBRARY = Library(stem="librow_lse",
                  src=os.path.join(_HERE, "csrc", "row_lse.cu"),
                  build_dir=os.path.join(_HERE, "build"),
                  compiler=_nvcc, flags=_NVCC_FLAGS)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Load the library its content-addressed name gives, compiling
    ``csrc/row_lse.cu`` first when no such file exists."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib, build_seconds = LIBRARY.load(
            extra_flags=("-Xptxas=-v",) if verbose else (), verbose=verbose)
        lib.row_lse_launch.restype = ctypes.c_int
        lib.row_lse_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        for fn in (lib.row_lse_rows_per_block, lib.row_lse_chunk_cols,
                   lib.row_lse_resident_blocks):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib


def _check(a2, iva, ivmuA, muB):
    """(batch, na, nb, dof); ``batch`` is None for unbatched inputs."""
    for name, t in (("a2", a2), ("iva", iva), ("ivmuA", ivmuA),
                    ("muB", muB)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != a2.device:
            raise ValueError(f"{name} is on {t.device}, a2 on {a2.device}")
    if a2.dim() not in (1, 2) or muB.dim() != a2.dim() + 1:
        raise ValueError("a2 must be ([B,] Na) and muB ([B,] Nb, dof)")
    lead = tuple(a2.shape[:-1])
    if tuple(muB.shape[:-2]) != lead:
        raise ValueError(f"member axes differ: a2 {tuple(a2.shape)}, muB "
                         f"{tuple(muB.shape)}")
    na, nb, dof = a2.shape[-1], muB.shape[-2], muB.shape[-1]
    if iva.shape != lead + (na, dof) or ivmuA.shape != lead + (na, dof):
        raise ValueError(f"iva/ivmuA must be {lead + (na, dof)}; got "
                         f"{tuple(iva.shape)}, {tuple(ivmuA.shape)}")
    if na == 0 or nb == 0 or 0 in lead:
        raise ValueError("empty mixture")
    return (lead[0] if lead else None), na, nb, dof


def row_logsumexp_plain(a2, iva, ivmuA, muB,
                        max_elems: int = 1 << 26) -> torch.Tensor:
    """The same function in plain PyTorch: a logsumexp over column blocks
    of the expanded logW, combined with the kernel's (max, sum) rule and
    the same 1e-30 floor on the sum.  A leading member axis is a batch
    dimension of the same expressions."""
    batch, na, nb, _ = _check(a2, iva, ivmuA, muB)
    cb = max(1, min(nb, max_elems // max(na * (batch or 1), 1)))
    ms, ss = [], []
    for j in range(0, nb, cb):
        b = muB[..., j:j + cb, :]
        bt = b.transpose(-1, -2)
        logw = -0.5 * (a2[..., None] + iva @ (bt * bt) - 2.0 * (ivmuA @ bt))
        m = torch.max(logw, dim=-1).values
        ms.append(m)
        ss.append(torch.sum(torch.exp(logw - m[..., None]), dim=-1))
    m_all = torch.stack(ms)                              # (blocks, [B,] Na)
    mx = torch.max(m_all, dim=0).values
    s = torch.sum(torch.stack(ss) * torch.exp(m_all - mx), dim=0)
    return mx + torch.log(torch.clamp(s, min=1e-30))


#: per-block work that does not shrink with the split (row terms, the lane
#: merge), in columns' worth of the inner loop
_SPLIT_OVERHEAD_COLS = 128
#: a split narrower than this is mostly that overhead
_MIN_SPLIT_COLS = 2048


@functools.lru_cache(maxsize=1024)
def split_plan(na: int, nb: int, rows_per_block: int, chunk_cols: int,
               resident_blocks: int, batch: int = 1) -> tuple[int, int]:
    """(splits, cols_per_split) of the kernel's grid.  Blocks run in waves
    of ``resident_blocks``; the plan takes the split count whose last wave
    is fullest, discounted by what each extra block costs.  Splits are
    whole chunks, so only the matrix's last chunk is masked.  A batch of
    ``batch`` members has ``batch`` times the row blocks."""
    def ceil_div(a, b):
        return -(-a // b)

    row_blocks = batch * ceil_div(na, rows_per_block)
    best = None
    for want in range(1, max(1, nb // _MIN_SPLIT_COLS) + 1):
        cols = ceil_div(ceil_div(nb, want), chunk_cols) * chunk_cols
        splits = ceil_div(nb, cols)
        blocks = row_blocks * splits
        waves = ceil_div(blocks, resident_blocks)
        score = (blocks / (waves * resident_blocks)
                 * cols / (cols + _SPLIT_OVERHEAD_COLS))
        if best is None or score > best[0] + 1e-9:
            best = (score, splits, cols)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _grid_constants(device_index: int, dof: int) -> tuple[int, int, int]:
    """(rows per block, columns per chunk, resident blocks) of the built
    kernel on this device; asked once, they never change."""
    lib = build()
    with torch.cuda.device(device_index):
        consts = (lib.row_lse_rows_per_block(dof),
                  lib.row_lse_chunk_cols(dof),
                  lib.row_lse_resident_blocks(dof))
    if min(consts) <= 0:
        raise RuntimeError(f"row_logsumexp kernel: no grid constants for "
                           f"dof {dof} on cuda:{device_index}: {consts}")
    return consts


def _row_logsumexp_cuda(a2, iva, ivmuA, muB) -> torch.Tensor:
    batch, na, nb, dof = _check(a2, iva, ivmuA, muB)
    if dof > MAX_DOF:
        raise ValueError(f"row_logsumexp kernel supports dof <= {MAX_DOF}, "
                         f"got {dof}")
    for name, t in (("a2", a2), ("iva", iva), ("ivmuA", ivmuA),
                    ("muB", muB)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = build()
    index = a2.device.index
    if index is None:
        index = torch.cuda.current_device()
    b = batch or 1
    if b > 65535:
        raise ValueError(f"row_logsumexp kernel: a batch of {b} members "
                         "exceeds the grid's z limit of 65535")
    splits, cols_per_split = split_plan(na, nb, *_grid_constants(index, dof),
                                        b)
    part = torch.empty((2, b, splits, na), dtype=torch.float32,
                       device=a2.device)
    out = torch.empty(a2.shape, dtype=torch.float32, device=a2.device)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    rc = lib.row_lse_launch(a2.data_ptr(), iva.data_ptr(), ivmuA.data_ptr(),
                            muB.data_ptr(), part[0].data_ptr(),
                            part[1].data_ptr(), out.data_ptr(), na, nb, dof,
                            splits, cols_per_split, b, stream)
    if rc != 0:
        raise RuntimeError(f"row_logsumexp kernel launch failed: CUDA error "
                           f"{rc}")
    with _COUNTS_LOCK:
        counts["launches"] += 1
        counts["problems"] += b
    return out


def row_logsumexp(a2, iva, ivmuA, muB) -> torch.Tensor:
    """Row-logsumexp of logW = -0.5(a2 + iva·muB²ᵀ − 2 ivmuA·muBᵀ).

    a2 (Na,), iva and ivmuA (Na, dof), muB (Nb, dof), float32 on one
    device, each with an optional leading member axis B (one launch for
    all members; the result is then (B, Na)).  A CUDA input runs the
    kernel (or raises); a CPU input the plain version."""
    with _COUNTS_LOCK:
        counts["calls"] += 1
    if a2.device.type == "cuda":
        return _row_logsumexp_cuda(a2, iva, ivmuA, muB)
    if a2.device.type != "cpu":
        raise ValueError(f"row_logsumexp: unsupported device {a2.device}")
    return row_logsumexp_plain(a2, iva, ivmuA, muB)


def pair_row_terms(muA, precA, muB, precB):
    """(a2, ivar, ivar⊙muA) of the pair-product weights.  Like the
    reference, only B's first precision row (of each member) is read: in
    the cascade B's precisions are one row broadcast over its kernels."""
    pB0 = precB[..., :1, :]
    both = (precA > 0) & (pB0 > 0)
    ivar = torch.where(both, precA * pB0 / torch.clamp(precA + pB0,
                                                      min=1e-30),
                       torch.zeros((), dtype=precA.dtype,
                                   device=precA.device))
    a2 = torch.sum(ivar * muA * muA, dim=-1)
    return a2, ivar, ivar * muA


def pair_row_logsumexp(muA, precA, muB, precB) -> torch.Tensor:
    """Row log-partitions of the pair-product weights (inputs as in
    ops/product.pair_product_tangent, with an optional leading member
    axis: ``muA (B, Na, d)`` ... give ``(B, Na)`` in one launch)."""
    a2, ivar, ivmuA = pair_row_terms(muA, precA, muB, precB)
    return row_logsumexp(a2.contiguous(), ivar.contiguous(),
                         ivmuA.contiguous(), muB.contiguous())

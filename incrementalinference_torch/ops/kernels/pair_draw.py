"""The large pair product's column draw by inverse CDF: CUDA kernel and plain
version.

For every selected row r of mixture A (its terms gathered at the drawn row
index) the column j of mixture B is drawn with probability proportional to
``exp(logW_rj)``, with row_lse's expanded form

    logW_rj = -0.5 (a2_r + sum_d iva_rd muB_jd^2 - 2 sum_d ivmuA_rd muB_jd),

the weights whose row log-partitions drew the row.  Two uniforms a row,
``u`` (..., rows, 2), come from the caller's key: the kernel draws no random
number, so the kernel and :func:`pair_column_draw_plain` given the same
uniforms pick the same column except where a float32 rounding moves a
running sum across the target.  ``csrc/pair_draw.cu`` says what the draw
does, step by step, and what bounds it; in short: per (row, split of
``SPLIT_COLS`` columns) a sum of exponentials, the split by ``u[..., 0]``
against the splits' running sum, then the chosen split alone scanned again
in ``CHUNKS`` chunks of 32 columns, the column by ``u[..., 1]`` against the
scan's own running sum.  No atomics and a fixed order: a member's columns
do not depend on the other members of a batch, and two calls give the same
bits.  The JAX package draws these columns with ``jax.random.categorical``
(Gumbel noise and an argmax, fused by XLA); no TPU kernel is replaced.

- :func:`pair_column_draw` is the wrapper.  A CUDA tensor launches the
  kernel or raises; a CPU tensor takes :func:`pair_column_draw_plain`.
  There is no fallback from one to the other.
- Built like ``row_lse``: nvcc into ``build/`` under a content-addressed
  name (``libcache``), bound with ctypes, in ``warmstart``'s pack.
- Every function takes an optional leading member axis; a batch is one
  launch of each of the two kernels, the member from ``blockIdx.z``.
- ``counts["launches"]`` counts launch sets, ``counts["problems"]`` the
  members they drew, ``counts["calls"]`` every call of the wrapper.  A
  launch also counts ``draw_kernel_pairs`` (members × rows × Nb) into the
  recorder's innermost span (``tracing.count``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ... import tracing
from ...libcache import Library
from .row_lse import _NVCC_FLAGS, _nvcc
from .row_lse import _check as _check_terms

__all__ = ["pair_column_draw", "pair_column_draw_plain", "build", "counts",
           "reset_counts", "MAX_DOF", "SPLIT_COLS", "CHUNKS", "LIBRARY"]

_HERE = os.path.dirname(os.path.abspath(__file__))

#: the kernel holds dof in registers, instantiated for 1..MAX_DOF
MAX_DOF = 8
#: columns a split covers (``kSplitCols``): the split count is a function
#: of Nb alone
SPLIT_COLS = 2048
#: chunks of 32 columns a split holds when the chosen split is scanned
#: again
CHUNKS = SPLIT_COLS // 32

_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
_NEG_HALF_LOG2E = -0.5 * _LOG2E            # exact: a power of two
#: the smallest normal float32: ex2.approx.ftz gives 0 below it
_TINY = torch.finfo(torch.float32).tiny

counts = {"launches": 0, "problems": 0, "calls": 0}
_COUNTS_LOCK = threading.Lock()
_LOCK = threading.Lock()
_LIB = None
#: seconds the last nvcc build took (None: loaded an existing build)
build_seconds = None


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for k in counts:
            counts[k] = 0


#: ``build/libpair_draw-<source and flags>-<nvcc>.so`` (``libcache``)
LIBRARY = Library(stem="libpair_draw",
                  src=os.path.join(_HERE, "csrc", "pair_draw.cu"),
                  build_dir=os.path.join(_HERE, "build"),
                  compiler=_nvcc, flags=_NVCC_FLAGS)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Load the library its content-addressed name gives, compiling
    ``csrc/pair_draw.cu`` first when no such file exists."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib, build_seconds = LIBRARY.load(
            extra_flags=("-Xptxas=-v",) if verbose else (), verbose=verbose)
        lib.pair_draw_launch.restype = ctypes.c_int
        lib.pair_draw_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        for fn in (lib.pair_draw_split_cols, lib.pair_draw_chunks):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        if (lib.pair_draw_split_cols(), lib.pair_draw_chunks()) != (
                SPLIT_COLS, CHUNKS):
            raise RuntimeError(
                f"pair_draw kernel: the library splits by "
                f"{lib.pair_draw_split_cols()} columns in "
                f"{lib.pair_draw_chunks()} chunks, the plain version by "
                f"{SPLIT_COLS} in {CHUNKS}")
        _LIB = lib
        return lib


def _check(a2, iva, ivmuA, muB, u):
    """(batch, rows, nb, dof) as ``row_lse`` checks its inputs, with ``u``
    ([B,] rows, 2) float32 beside them."""
    batch, rows, nb, dof = _check_terms(a2, iva, ivmuA, muB)
    if not isinstance(u, torch.Tensor) or u.dtype != torch.float32:
        raise TypeError("u must be a float32 tensor")
    if u.device != a2.device or u.shape != a2.shape + (2,):
        raise ValueError(f"u must be {tuple(a2.shape) + (2,)} on "
                         f"{a2.device}; got {tuple(u.shape)} on {u.device}")
    return batch, rows, nb, dof


def _fma(a, b, c):
    """float32 fused multiply-add: the product of two float32 numbers is
    exact in float64, and the sum is rounded to float32 from there."""
    return (a.double() * b.double() + c.double()).float()


def _log2_weights(c, p, q, muB):
    """l2 (rows, cols) = c + sum_d b_d (q_d + p_d b_d) by the kernel's two
    FMAs a dimension, in its order."""
    acc = c[:, None].expand(-1, muB.shape[0])
    for d in range(muB.shape[1]):
        x = muB[None, :, d]
        acc = _fma(_fma(p[:, None, d], x, q[:, None, d]), x, acc)
    return acc


def _first_past(values, goal, start=None):
    """The index of the first running sum past ``goal`` along dim 1 of
    ``values`` (rows, n), added in order from ``start`` (0), whether there
    was one, and the running sums before each entry."""
    acc = torch.zeros_like(values[:, 0]) if start is None else start
    before, past = torch.empty_like(values), torch.empty_like(values,
                                                              dtype=bool)
    for i in range(values.shape[1]):
        before[:, i] = acc
        acc = acc + values[:, i]
        past[:, i] = acc > goal
    return torch.argmax(past.to(torch.int8), dim=1), past.any(dim=1), before


def _last_positive(values):
    """The index of the last positive entry along dim 1 (0 where none)."""
    idx = torch.arange(values.shape[1], device=values.device).expand_as(
        values)
    return torch.where(values > 0, idx, torch.zeros_like(idx)).amax(dim=1)


def _draw_block(c, p, q, muB, u):
    """The draw of one block of rows against one member's columns."""
    rows, nb = c.shape[0], muB.shape[0]
    splits = -(-nb // SPLIT_COLS)
    l2 = _log2_weights(c, p, q, muB)                      # (rows, nb)
    pad = torch.full((rows, splits * SPLIT_COLS - nb), -torch.inf,
                     device=c.device)
    l2 = torch.cat([l2, pad], dim=1).view(rows, splits, SPLIT_COLS)

    # 1. the split: each split's sum against its own largest l2, rescaled
    #    to the row's largest, folded in split order
    m = l2.amax(dim=2)                                    # (rows, splits)
    s = torch.sum(torch.exp2(l2 - m[..., None]), dim=2)
    big = m.amax(dim=1, keepdim=True)
    scaled = s * torch.exp2(m - big)
    total = torch.zeros_like(c)
    for k in range(splits):
        total = total + scaled[:, k]
    k_past, any_past, _ = _first_past(scaled, u[:, 0] * total)
    split = torch.where(any_past, k_past, _last_positive(scaled))

    # 2. that split again: its largest l2, then chunks of 32 columns, each
    #    summed by the kernel's xor butterfly and folded in chunk order
    at = torch.arange(rows, device=c.device)
    sel = l2[at, split]                                   # (rows, SPLIT)
    top = sel.amax(dim=1, keepdim=True)
    w = torch.exp2(sel - top)
    w = torch.where(w < _TINY, torch.zeros_like(w), w)    # ftz, as ex2
    chunks = w.view(rows, CHUNKS, 32)
    sums, lanes = chunks, torch.arange(32, device=c.device)
    for off in (16, 8, 4, 2, 1):
        sums = sums + sums[..., lanes ^ off]
    sums = sums[..., 0]                                   # (rows, CHUNKS)
    tot = torch.zeros_like(c)
    for k in range(CHUNKS):
        tot = tot + sums[:, k]
    goal = u[:, 1] * tot
    k_past, chunk_found, before = _first_past(sums, goal)
    chunk = torch.where(chunk_found, k_past, _last_positive(sums))

    # 3. in that chunk, from the running sum before it: the first column
    #    past the goal, else its last of positive weight
    cw = chunks[at, chunk]                                # (rows, 32)
    col_past, col_found, _ = _first_past(cw, goal, start=before[at, chunk])
    found = chunk_found & col_found
    col = torch.where(found, col_past, _last_positive(cw))
    return split * SPLIT_COLS + chunk * 32 + col


def pair_column_draw_plain(a2, iva, ivmuA, muB, u,
                           max_elems: int = 1 << 23) -> torch.Tensor:
    """The kernel's draw in plain PyTorch: the same splits, runs, folds and
    float32 sums, the FMAs rounded once (through float64), in blocks of
    rows of at most ``max_elems`` padded pairs.  The splits' sums are
    summed in another order than the kernel's and ``torch.exp2`` rounds
    otherwise than ex2.approx: the two agree where no running sum lies
    within that rounding of its target.  The wrapper takes it for CPU
    tensors; it runs on any device (the card tests hold the kernel to it
    there)."""
    batch, rows, nb, dof = _check(a2, iva, ivmuA, muB, u)
    if batch is None:
        return pair_column_draw_plain(a2[None], iva[None], ivmuA[None],
                                      muB[None], u[None], max_elems)[0]
    splits = -(-nb // SPLIT_COLS)
    blk = max(1, max_elems // (splits * SPLIT_COLS))
    out = torch.empty((batch, rows), dtype=torch.int64, device=a2.device)
    for b in range(batch):
        c = a2[b] * _NEG_HALF_LOG2E
        p, q = iva[b] * _NEG_HALF_LOG2E, ivmuA[b] * _LOG2E
        for r in range(0, rows, blk):
            sl = slice(r, r + blk)
            out[b, sl] = _draw_block(c[sl], p[sl], q[sl], muB[b], u[b, sl])
    return out


def _pair_column_draw_cuda(a2, iva, ivmuA, muB, u) -> torch.Tensor:
    batch, rows, nb, dof = _check(a2, iva, ivmuA, muB, u)
    if dof > MAX_DOF:
        raise ValueError(f"pair_column_draw kernel supports dof <= "
                         f"{MAX_DOF}, got {dof}")
    for name, t in (("a2", a2), ("iva", iva), ("ivmuA", ivmuA),
                    ("muB", muB), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b = batch or 1
    if b > 65535:
        raise ValueError(f"pair_column_draw kernel: a batch of {b} members "
                         "exceeds the grid's z limit of 65535")
    out = torch.empty(a2.shape, dtype=torch.int64, device=a2.device)
    lib = build()
    splits = -(-nb // SPLIT_COLS)
    part = torch.empty((2, b, rows, splits), dtype=torch.float32,
                       device=a2.device)
    with torch.cuda.device(a2.device):
        stream = torch.cuda.current_stream(a2.device).cuda_stream
        rc = lib.pair_draw_launch(a2.data_ptr(), iva.data_ptr(),
                                  ivmuA.data_ptr(), muB.data_ptr(),
                                  u.data_ptr(), part[0].data_ptr(),
                                  part[1].data_ptr(), out.data_ptr(), rows,
                                  nb, dof, b, stream)
    if rc != 0:
        raise RuntimeError(f"pair_column_draw kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNTS_LOCK:
        counts["launches"] += 1
        counts["problems"] += b
    tracing.count("draw_kernel_pairs", b * rows * nb)
    return out


def pair_column_draw(a2, iva, ivmuA, muB, u) -> torch.Tensor:
    """One column of B a row, int64 ([B,] rows): a2 ([B,] rows), iva and
    ivmuA ([B,] rows, dof) the selected rows' terms (``row_lse``'s
    ``pair_row_terms`` at the drawn rows), muB ([B,] Nb, dof), u ([B,]
    rows, 2) uniforms in [0, 1), float32 on one device.  A CUDA input runs
    the kernel (or raises); a CPU input the plain version."""
    with _COUNTS_LOCK:
        counts["calls"] += 1
    if a2.device.type == "cuda":
        return _pair_column_draw_cuda(a2, iva, ivmuA, muB, u)
    if a2.device.type != "cpu":
        raise ValueError(f"pair_column_draw: unsupported device "
                         f"{a2.device}")
    return pair_column_draw_plain(a2, iva, ivmuA, muB, u)

"""The KDE read's row-logsumexp (``beliefs.kde_logpdf``) as one CUDA kernel.

For every member b of a batch and every query row i,

    out[b, i] = logsumexp_j ( -1/2 sum_d ( log_{p_bj}(q_bi)_d / bw_bd )^2 ),

the Gaussian kernels' log-sum at the query on ``Euclidean(d)`` (d up to
``MAX_DOF``), on ``SE2`` and on ``SE3``.  ``csrc/kde_lse.cu`` (CUDA C++ for
``sm_90a``) streams the kernel particles through shared memory and keeps each
pair's log map, scaled square and online logsumexp in registers: no (Q, N,
dof) tensor, no chunks.  It replaces no TPU kernel (the JAX ``kde_logpdf`` reaches no
``pl.pallas_call``); its source says what bounds it.

- :func:`manifold_code` says which manifolds the kernel computes;
  :func:`takes` whether a call goes to it: a CUDA float32 read on such a
  manifold that needs no gradient.  ``beliefs.kde_logpdf`` keeps its
  chunked eager route for everything else, the CPU included.
- :func:`kde_row_logsumexp` launches the kernel or raises; it never falls
  back.  It checks device, dtype, shape and contiguity.
- :func:`se3_log` and :func:`se3_row_logsumexp` are the SE(3) kernel's
  plain version: its expressions in PyTorch, on any device and dtype, for
  the tests (``beliefs.kde_logpdf`` reads CPU tensors by its eager chunks,
  the port's ``SE3.log``).
- The column split is ``ceil(N / split_cols)`` whatever the query, and the
  splits merge in a second, fixed-order pass: a row gives the same bits
  read alone as in a read of many rows, and two reads give the same bits.
- Built like ``row_lse``: nvcc into ``build/`` under a content-addressed
  name (``libcache``), bound with ctypes, in ``warmstart``'s pack.
- ``counts["launches"]`` counts launches, ``counts["problems"]`` the members
  they read, ``counts["calls"]`` every call of :func:`kde_row_logsumexp`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import threading

import torch

from ...libcache import Library
from .row_lse import _NVCC_FLAGS, _nvcc

__all__ = ["kde_row_logsumexp", "manifold_code", "takes", "build", "counts",
           "reset_counts", "se3_log", "se3_row_logsumexp", "MAX_DOF",
           "LIBRARY"]

_HERE = os.path.dirname(os.path.abspath(__file__))

#: Euclidean(d) up to this d is a kernel instance
MAX_DOF = 8
_EUCLIDEAN, _SE2, _SE3 = 0, 1, 2
#: lie.py's guard of its small-angle forms and clamps
_EPS = 1e-8

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


#: ``build/libkde_lse-<source and flags>-<nvcc>.so`` (``libcache``)
LIBRARY = Library(stem="libkde_lse",
                  src=os.path.join(_HERE, "csrc", "kde_lse.cu"),
                  build_dir=os.path.join(_HERE, "build"),
                  compiler=_nvcc, flags=_NVCC_FLAGS)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Load the library its content-addressed name gives, compiling
    ``csrc/kde_lse.cu`` first when no such file exists."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib, build_seconds = LIBRARY.load(
            extra_flags=("-Xptxas=-v",) if verbose else (), verbose=verbose)
        lib.kde_lse_launch.restype = ctypes.c_int
        lib.kde_lse_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.kde_lse_terms.restype = ctypes.c_int
        lib.kde_lse_terms.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.kde_lse_split_cols.restype = ctypes.c_int
        lib.kde_lse_split_cols.argtypes = []
        _LIB = lib
        return lib


def manifold_code(manifold):
    """(code, dof) of a manifold the kernel computes, else None: its class,
    not a subclass, since a subclass may redefine ``log``."""
    from ...manifolds import SE2, SE3, Euclidean

    if type(manifold) is Euclidean and 1 <= manifold.dof <= MAX_DOF:
        return _EUCLIDEAN, manifold.dof
    if type(manifold) is SE2:
        return _SE2, 3
    if type(manifold) is SE3:
        return _SE3, 6
    return None


def takes(manifold, points, query, bw) -> bool:
    """Whether ``kde_logpdf`` reads by the kernel: the manifold's class, the
    tensors' device (CUDA) and dtype (float32), and no gradient asked of
    them (the kernel has no backward)."""
    ts = (points, query, bw)
    if not all(t.device.type == "cuda" and t.dtype == torch.float32
               for t in ts):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return False
    return manifold_code(manifold) is not None


@functools.lru_cache(maxsize=None)
def _layout(code: int, dof: int) -> tuple[int, int]:
    """(floats of a particle's terms, columns a split) of the built
    kernel."""
    lib = build()
    return lib.kde_lse_terms(code, dof), lib.kde_lse_split_cols()


def _members(t: torch.Tensor, lead: tuple, tail: int, name: str):
    """``t`` (contiguous) as (members, *its last ``tail`` dims) and its
    member count: 1 where every member shares it, else prod(lead), copied
    only where its leading dimensions broadcast against the others'."""
    if not t.is_contiguous():
        raise ValueError(f"kde_row_logsumexp: {name} must be contiguous "
                         f"(shape {tuple(t.shape)}, strides {t.stride()})")
    own, shape = t.shape[:t.dim() - tail], t.shape[t.dim() - tail:]
    if math.prod(own) == 1:
        return t.reshape((1,) + shape), 1
    if (1,) * (len(lead) - len(own)) + tuple(own) != tuple(lead):
        t = t.expand(tuple(lead) + shape).contiguous()
    return t.reshape((-1,) + shape), math.prod(lead)


def kde_row_logsumexp(manifold, points: torch.Tensor, query: torch.Tensor,
                      bw: torch.Tensor) -> torch.Tensor:
    """The kernels' log-sum at every query row: ``points`` (..., N,
    point_dim), ``query`` (..., Q, point_dim), ``bw`` (..., dof), float32
    on one CUDA device, contiguous, their leading dimensions broadcast to
    one batch; returns (batch..., Q).  Launches the kernel or raises."""
    with _COUNTS_LOCK:
        counts["calls"] += 1
    code = manifold_code(manifold)
    if code is None:
        raise ValueError(f"kde_row_logsumexp: no kernel for {manifold!r}")
    code, dof = code
    pd = manifold.point_dim
    for name, t in (("points", points), ("query", query), ("bw", bw)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device.type != "cuda" or t.device != points.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"all three on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if (points.dim() < 2 or query.dim() < 2 or bw.dim() < 1
            or points.shape[-1] != pd or query.shape[-1] != pd
            or bw.shape[-1] != dof):
        raise ValueError(f"points (..., N, {pd}), query (..., Q, {pd}) and "
                         f"bw (..., {dof}) expected; got {tuple(points.shape)}"
                         f", {tuple(query.shape)}, {tuple(bw.shape)}")
    lead = torch.broadcast_shapes(points.shape[:-2], query.shape[:-2],
                                  bw.shape[:-1])
    n, q_rows, members = points.shape[-2], query.shape[-2], math.prod(lead)
    if n == 0:
        raise ValueError("kde_row_logsumexp: a belief of no particles")
    out = torch.empty((members, q_rows), dtype=torch.float32,
                      device=points.device)
    if q_rows == 0 or members == 0:
        return out.reshape(tuple(lead) + (q_rows,))
    p, pm = _members(points, lead, 2, "points")
    q, qm = _members(query, lead, 2, "query")
    b, bm = _members(bw, lead, 1, "bw")
    lib = build()
    terms, split_cols = _layout(code, dof)
    scratch = torch.empty((pm * terms * n,), dtype=torch.float32,
                          device=points.device)
    part = torch.empty((2, members, -(-n // split_cols), q_rows),
                       dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.kde_lse_launch(code, dof, p.data_ptr(), q.data_ptr(),
                                b.data_ptr(), scratch.data_ptr(),
                                part[0].data_ptr(), part[1].data_ptr(),
                                out.data_ptr(), q_rows, n, members, pm, qm,
                                bm, stream)
    if rc != 0:
        raise RuntimeError(f"kde_row_logsumexp kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNTS_LOCK:
        counts["launches"] += 1
        counts["problems"] += members
    return out.reshape(tuple(lead) + (q_rows,))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def se3_log(points: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """``log_p(q) = Log(p^-1 o q)`` on SE(3) by the kernel's expressions
    (``csrc/kde_lse.cu``, ``struct SE3``): the rotation of the translations'
    difference, the relative quaternion with w >= 0, and V^-1's coefficient
    from the quaternion's half angle, with ``SE3.log``'s small-angle forms
    and clamps.  ``points`` and ``query`` (..., 7) broadcast; returns (...,
    6) in their dtype."""
    a = torch.cat([points[..., 3:4], -points[..., 4:]], dim=-1)
    v, b = a[..., 1:], query[..., 3:]
    d = query[..., :3] - points[..., :3]
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    r = torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], dim=-1)
    r = torch.where(r[..., :1] < 0, -r, r)
    qw, q = r[..., :1], r[..., 1:]
    c1 = _cross(v, d)
    t = d + 2.0 * (aw[..., None] * c1 + _cross(v, c1))
    u2 = (q * q).sum(-1, keepdim=True) + 1e-24
    u = torch.sqrt(u2)
    theta = 2.0 * torch.atan2(u, qw)
    scale = torch.where(u > _EPS, theta / u, 2.0 / torch.clamp(qw, min=_EPS))
    phi = scale * q
    s2 = (phi * phi).sum(-1, keepdim=True) + 1e-24
    s = torch.sqrt(s2)
    m = torch.clamp(2.0 * u2, min=_EPS)
    c = torch.where(s > _EPS, (m - s * qw * u) / (m * s2),
                    1.0 / 12.0 + s2 / 720.0)
    e1 = _cross(phi, t)
    rho = t - 0.5 * e1 + c * _cross(phi, e1)
    return torch.cat([rho, phi], dim=-1)


def se3_row_logsumexp(points: torch.Tensor, query: torch.Tensor,
                      bw: torch.Tensor, chunk_pairs: int = 1 << 22
                      ) -> torch.Tensor:
    """The kernel's function on SE(3) in plain PyTorch: ``points`` (...,
    N, 7), ``query`` (..., Q, 7) and ``bw`` (..., 6), leading dimensions
    broadcast, give (..., Q) logsumexp_j of -1/2 |log_{p_j}(q_i) / bw|^2,
    in query rows of at most ``chunk_pairs`` pairs of every member."""
    lead = torch.broadcast_shapes(points.shape[:-2], query.shape[:-2],
                                  bw.shape[:-1])
    P, B = points[..., None, :, :], bw[..., None, None, :]
    step = max(1, chunk_pairs // max(math.prod(lead) * points.shape[-2], 1))
    out = [torch.logsumexp(-0.5 * ((se3_log(P, query[..., i:i + step, None,
                                                      :]) / B) ** 2).sum(-1),
                           dim=-1)
           for i in range(0, query.shape[-2], step)]
    return (torch.cat(out, dim=-1) if out
            else query.new_empty(tuple(lead) + (0,)))

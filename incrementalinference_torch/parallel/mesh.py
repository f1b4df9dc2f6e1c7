"""A device mesh for the solver's data-parallel axes, in one process.

Counterpart of ``incrementalinference/jl_tpu/parallel/mesh.py``.  The JAX
package places arrays with ``NamedSharding`` on a ``jax.sharding.Mesh`` and
lets GSPMD partition the programs.  PyTorch has no GSPMD, so here a
:class:`Mesh` is a list of ``torch.device``s with an axis name, and the
code that uses it splits its work explicitly, one contiguous chunk per
device, and gathers the results back:

- **particles**: a clique's per-particle solves (ops/convolve.py), drawn on
  the full N first, then split; bandwidths and products run on the graph's
  device;
- **factors**: a parametric factor group, padded to a multiple of the mesh
  with zero whitening and zero null probability, forms JᵀJ and Jᵀr chunk
  by chunk, summed on the first device (:func:`sharded_normal_equations`,
  the psum);
- **cliques**: the members of a batched level's class, padded with copies
  of the last member, one batched update per device
  (parallel/scheduler.py ``_lockstep_gibbs_stacked``), and parametric
  batches (parametric/solver.py ``solve_problems_batched``).

A list may repeat a device: ``Mesh([torch.device("cpu")] * 8)`` stands in,
in the CPU tests, for the JAX package's eight virtual host devices, and
``Mesh([torch.device("cuda:0")] * 4)`` drives the split paths on one card.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch.func import jacfwd

__all__ = ["Mesh", "make_mesh", "shard_particles", "replicate",
           "shard_group_arrays", "sharded_normal_equations"]


class Mesh:
    """A one-axis device mesh: ``devices`` (a list of ``torch.device``,
    repeats allowed) and ``axis_names``."""

    def __init__(self, devices: Sequence, axis_names=("shard",)):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = ((axis_names,) if isinstance(axis_names, str)
                           else tuple(axis_names))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "shard") -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them by
    default).  Raises when there are fewer: nothing falls back to the
    CPU; build ``Mesh([torch.device("cpu")] * n)`` for that."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass an explicit "
                           "Mesh of devices to run elsewhere")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise ValueError(f"make_mesh({n_devices}): {have} CUDA device(s)")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))


def _pad_rows(x: torch.Tensor, per: int, zero: bool = False) -> torch.Tensor:
    pad = (-x.shape[0]) % per
    if not pad:
        return x
    tail = torch.zeros_like(x[-1:]) if zero else x[-1:]
    return torch.cat([x, tail.expand((pad,) + tuple(x.shape[1:]))])


def shard_particles(mesh: Mesh, arr: torch.Tensor,
                    axis_name: str = "shard") -> tuple:
    """A particle-batched tensor (N, ...) as one contiguous chunk per mesh
    device, N padded up to a multiple of the mesh with copies of the last
    row."""
    del axis_name
    arr = _pad_rows(arr, len(mesh))
    per = arr.shape[0] // len(mesh)
    return tuple(arr[i * per:(i + 1) * per].to(d)
                 for i, d in enumerate(mesh.devices))


def replicate(mesh: Mesh, arr: torch.Tensor) -> tuple:
    """A copy of ``arr`` on every mesh device."""
    return tuple(arr.to(d) for d in mesh.devices)


def _rows(x, fn):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_rows(e, fn) for e in x)
    return fn(x)


def shard_group_arrays(mesh: Mesh, group, axis_name: str = "shard"):
    """Pad a parametric factor group's stacked tensors along the factor
    axis to a multiple of the mesh, in place, and mark the group for
    chunk-wise evaluation over the mesh (:func:`sharded_normal_equations`).
    Padded rows repeat the last factor with zero whitening (and zero null
    probability), so they contribute nothing."""
    del axis_name
    per = len(mesh)
    pad = lambda x: _pad_rows(x, per)                      # noqa: E731
    group.params = _rows(group.params, pad)
    group.meas = pad(group.meas)
    group.sqrt_inv = _pad_rows(group.sqrt_inv, per, zero=True)
    group.slots = pad(group.slots)
    group.brow = pad(group.brow)
    if group.null_p is not None:
        group.null_p = _pad_rows(group.null_p, per, zero=True)
    if group.hyp is not None:
        w, slots, upos = group.hyp
        group.hyp = (pad(w), pad(slots), upos)
    if group.mix is not None:
        w, mus, sqis = group.mix
        group.mix = (pad(w), pad(mus), _pad_rows(sqis, per, zero=True))
    group.mesh = mesh
    return group


def _group_chunk(group, c: int, n_chunks: int, device):
    """Rows of chunk ``c`` of a padded group, on ``device``."""
    per = group.meas.shape[0] // n_chunks
    take = lambda x: x[c * per:(c + 1) * per].to(device)  # noqa: E731
    g = copy.copy(group)
    g.params = _rows(group.params, take)
    g.meas, g.sqrt_inv = take(group.meas), take(group.sqrt_inv)
    g.slots, g.brow = take(group.slots), take(group.brow)
    g.null_p = _rows(group.null_p, take)
    g.mix = _rows(group.mix, take)
    if group.hyp is not None:
        w, slots, upos = group.hyp
        g.hyp = (take(w), take(slots), upos)
    return g


def sharded_normal_equations(mesh: Mesh, residual_fn, x: torch.Tensor,
                             axis_name: str = "shard"):
    """One Gauss-Newton normal-equation build, (JᵀJ, Jᵀr), on the mesh's
    first device.

    For ``residual_fn`` a problem's ``residuals`` (parametric/solver.py
    ``ParametricProblem``) whose groups went through
    :func:`shard_group_arrays`, each device evaluates its chunk of every
    group's factors, forms its JᵀJ and Jᵀr, and the chunks' sums are added
    on the first device (the JAX package's GSPMD psum).  Any other
    residual function is evaluated whole on the first device."""
    del axis_name
    home = mesh.devices[0]
    prob = getattr(residual_fn, "__self__", None)
    groups = getattr(prob, "groups", None)
    if not groups or any(getattr(g, "mesh", None) is not mesh
                         for g in groups):
        r = residual_fn(x.to(home))
        J = jacfwd(residual_fn)(x.to(home))
        return J.T @ J, J.T @ r
    H = g_vec = None
    for c, dev in enumerate(mesh.devices):
        part = copy.copy(prob)
        part.groups = [_group_chunk(g, c, len(mesh), dev) for g in groups]
        part.p0 = [p.to(dev) for p in prob.p0]
        part.free_mask = prob.free_mask.to(dev)
        xc = x.to(dev)
        r = part.residuals(xc)
        J = jacfwd(part.residuals)(xc)
        Hc, gc = (J.T @ J).to(home), (J.T @ r).to(home)
        H = Hc if H is None else H + Hc
        g_vec = gc if g_vec is None else g_vec + gc
    return H, g_vec

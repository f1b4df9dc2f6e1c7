"""Entry points of the port's flagship step and of a dry run over a mesh.

Counterpart of the repository's ``__graft_entry__.py`` for the JAX package:

- :func:`entry` returns ``(fn, example_args)``: one batched Gauss-Newton
  convolution step (the MM-iSAM hot loop) followed by the exact pair
  product of its proposal with the start points.
- :func:`dryrun_multichip` runs one distributed solver step of each kind
  over a :class:`~.parallel.mesh.Mesh`: a particle-split convolution,
  factor-split parametric normal equations, one damped update, and a
  clique-split parametric tree solve.

Both run on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import torch

from . import keys as _keys
from .config import resolve_device

__all__ = ["entry", "dryrun_multichip"]


def _flagship():
    from .distributions import Normal
    from .manifolds import Euclidean
    from .models import LinearRelative
    from .ops.convolve import batched_gauss_newton
    from .ops.product import pair_product_tangent

    manifold = Euclidean(2)
    model = LinearRelative(Normal(0.0, 1.0))

    def convolve(meas, other, x0):
        return batched_gauss_newton(manifold, model, meas, (other,), x0,
                                    sf_slot=1, iters=3)

    def product(solved, x0, key: int):
        prec = torch.ones_like(solved)
        return pair_product_tangent(solved, prec, x0, prec, key,
                                    n_out=solved.shape[0])

    def forward(meas, other, x0, key: int):
        return product(convolve(meas, other, x0), x0, key)

    return forward, convolve, product


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` runs the flagship step
    on 128 particles in the plane and returns the product's (mu, prec),
    each (128, 2)."""
    dev = resolve_device(device)
    forward, _, _ = _flagship()
    n = 128
    meas = torch.zeros((n, 2), device=dev)
    other = torch.zeros((n, 2), device=dev)
    x0 = torch.ones((n, 2), device=dev)
    return forward, (meas, other, x0, _keys.make_key(0))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One distributed step of each kind over ``n_devices`` shards: the
    first ``n_devices`` CUDA devices (``make_mesh``), or on the CPU (with
    ``device="cpu"``) one CPU device repeated ``n_devices`` times.  Raises
    when a result is wrong."""
    from . import (ContinuousScalar, LinearRelative, Normal, Prior, initfg,
                   solve_tree)
    from .canonical import generate_line_step
    from .parallel.mesh import (Mesh, make_mesh, shard_group_arrays,
                                shard_particles, sharded_normal_equations)
    from .parametric.solver import ParametricProblem

    dev = resolve_device(device)
    mesh = (make_mesh(n_devices) if dev.type == "cuda"
            else Mesh([dev] * n_devices))
    _, convolve, product = _flagship()

    # particle-split convolution: each shard solves its particles, the
    # product runs on the gathered proposal
    n = 8 * max(1, n_devices)
    meas, other, x0 = (torch.zeros((n, 2), device=dev),
                       torch.zeros((n, 2), device=dev),
                       torch.ones((n, 2), device=dev))
    solved = torch.cat([convolve(m, o, x).to(dev) for m, o, x in zip(
        shard_particles(mesh, meas), shard_particles(mesh, other),
        shard_particles(mesh, x0))])
    mu, prec = product(solved, x0, _keys.make_key(0))
    if mu.shape != (n, 2) or not bool(torch.isfinite(mu).all()):
        raise RuntimeError(f"particle-split step: {tuple(mu.shape)}")

    # factor-split parametric normal equations, summed on the first device
    fg = generate_line_step(8, graphinit=False, device=dev)
    prob = ParametricProblem(fg)
    for g in prob.groups:
        shard_group_arrays(mesh, g)
    x = torch.zeros((prob.total_dof,), device=dev)
    H, g_vec = sharded_normal_equations(mesh, prob.residuals, x)
    if H.shape != (prob.total_dof, prob.total_dof) \
            or not bool(torch.isfinite(H).all()):
        raise RuntimeError(f"normal equations: {tuple(H.shape)}")

    # one damped Gauss-Newton update
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    step = torch.linalg.solve(H + 1e-6 * eye, g_vec)
    if not bool(torch.isfinite(step).all()):
        raise RuntimeError("damped update is not finite")

    # clique-split parametric tree solve: each level's batch over the mesh
    fgw = initfg(device=dev)
    width = 2 * max(1, n_devices)
    for b in range(width):
        fgw.add_variable(f"b{b}x0", ContinuousScalar)
        fgw.add_factor([f"b{b}x0"], Prior(Normal(float(b), 0.5)),
                       graphinit=False)
        fgw.add_variable(f"b{b}x1", ContinuousScalar)
        fgw.add_factor([f"b{b}x0", f"b{b}x1"],
                       LinearRelative(Normal(1.0, 0.5)), graphinit=False)
    solve_tree(fgw, algorithm="parametric", mesh=mesh)
    errs = [abs(float(fgw.var(f"b{b}x1").parametric_point[0]) - (b + 1))
            for b in range(width)]
    if max(errs) >= 1e-3:
        raise RuntimeError(f"clique-split parametric tree solve: {errs}")
    print(f"dryrun_multichip({n_devices}): convolution split over "
          f"{len(mesh)} shards, parametric H {tuple(H.shape)} ok, "
          f"clique-split parametric tree err {max(errs):.1e}")

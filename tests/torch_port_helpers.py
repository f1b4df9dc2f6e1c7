"""Shared helpers of the tests/test_torch_*.py files (not collected).

The port's tests run the JAX package and the PyTorch port on the same
numpy-made inputs; six pytest workers share the CPU, so each file keeps
torch to two threads.
"""

import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def jax_native_ordering_available(wait_s: float = 60.0) -> bool:
    """The JAX package's native ordering, loaded into this process.

    That package compiles straight into its ``build/`` library file, so a
    second pytest worker can find the file half-written, fail to load it
    and remember the failure for good.  Forget the failure and try again
    until the other worker's compiler has finished."""
    import incrementalinference.jl_tpu.native as jn

    deadline = time.monotonic() + wait_s
    while not jn.native_available():
        if time.monotonic() >= deadline:
            return False
        jn._FAILED = False
        jn._LIB = None
        time.sleep(1.0)
    return True


@pytest.fixture(scope="module", autouse=True)
def jax_native_ordering():
    """Imported into each test file that builds a JAX tree, ordering or
    partition: without the JAX package's native ordering its trees are the
    Python heuristic's, and the comparisons with the port's would fail for
    that alone (or pass against the wrong tree)."""
    assert jax_native_ordering_available(), (
        "the JAX package's native ordering did not load in this worker")


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def t(a) -> torch.Tensor:
    """float32 CPU tensor holding a copy of an array (a JAX array's numpy
    view is read-only, which torch warns about)."""
    return torch.as_tensor(np.array(a, np.float32))


def interp_uniform(t: float, u: torch.Tensor, t0: float, dt: float):
    """``jnp.interp(t, u[0], u[1])`` for a grid u[0] = t0 + dt·i, as the
    port's ODE tests write it: ``t`` arrives as a Python float, so the cell
    is found on the host and only the lerp of two grid values is a tensor
    op (inside ``vmap(jacrev)`` every op costs host time)."""
    n = u.shape[1]
    s = min(max((t - t0) / dt, 0.0), n - 1.0)
    i = min(int(s), n - 2)
    return torch.lerp(u[1, i], u[1, i + 1], s - i)


def scaled(x: torch.Tensor, a: float) -> torch.Tensor:
    """a·x as an alpha-add: under torch.func's transforms a product with
    a constant costs more host time than an alpha-add (about a third of a
    DERelative's Jacobian pass on a CPU)."""
    return torch.add(torch.zeros_like(x), x, alpha=a)


def _net(fn) -> object:
    """The ``net`` entry of a JAX-package network function."""
    return ("mlp" if type(fn).__name__ == "function"
            else [list(layer) for layer in fn.spec])


def _dist(z) -> dict:
    """A JAX-package distribution as convert.py's distribution dict."""
    from incrementalinference_torch.convert import _DIST_FIELDS

    name = type(z).__name__
    if name == "ManifoldKernelDensity":
        return {"type": name, "dof": z.manifold.dof,
                "points": np.asarray(z.belief.points),
                "bw": np.asarray(z.belief.bw)}
    if name == "HeatmapGridDensity":
        return {"type": name, "data": np.asarray(z.data),
                "xs": np.asarray(z.xs), "ys": np.asarray(z.ys), "N": z.N}
    if name == "LevelSetGridNormal":
        return {"type": name, "data": np.asarray(z.data),
                "xs": np.asarray(z.heatmap.xs),
                "ys": np.asarray(z.heatmap.ys), "level": z.level,
                "sigma": z.sigma}
    if name == "FluxModelsDistribution":
        return {"type": name, "net": _net(z.apply_fn),
                "params": [[np.asarray(W), np.asarray(b)]
                           for W, b in z.params],
                "data": np.asarray(z.data), "out_dim": z.out_dim,
                "shuffle": bool(z.shuffle)}
    return {"type": name,
            **{f: np.asarray(getattr(z, f)) for f in _DIST_FIELDS[name]}}


def _fields(model, skip=()) -> dict:
    """The parameter fields the port registers for this factor type, read
    off the JAX-package model (the two use the same attribute names)."""
    from incrementalinference_torch.convert import manifold_to
    from incrementalinference_torch.models import MODEL_REGISTRY

    to = {"Z": _dist, "manifold": manifold_to,
          "p0": lambda a: np.asarray(a, np.float32), "partial": list,
          "manifolds": lambda ms: [manifold_to(m) for m in ms],
          "p0s": lambda ps: [np.asarray(p, np.float32) for p in ps],
          "cov": lambda a: np.asarray(a, np.float32),
          "t0": float, "t1": float, "steps": int, "data": _array}
    _, children, aux = MODEL_REGISTRY[type(model).__name__]
    return {k: to[k](getattr(model, k)) for k in children + aux
            if k not in skip}


def _model(model) -> dict:
    if type(model).__name__ == "Mixture":
        return {"mechanics": type(model.mechanics).__name__,
                "mechanics_fields": _fields(model.mechanics, skip=("Z",)),
                "components": [_dist(c) for c in model.components],
                "diversity": np.asarray(model.diversity)}
    return _fields(model)


def _array(a):
    return None if a is None else np.asarray(a, np.float32)


def jax_graph_to_arrays(fg, solve_key: str = "default") -> dict:
    """The spec dict of incrementalinference_torch.convert, built from a
    JAX-package FactorGraph (its beliefs and parametric state as numpy
    arrays)."""
    import dataclasses

    from incrementalinference_torch.convert import manifold_to

    variables = []
    for v in fg.variables.values():
        b = v.beliefs.get(solve_key)
        variables.append({
            "label": v.label, "type": v.vartype.name,
            "manifold": manifold_to(v.manifold), "N": v.N,
            "solvable": v.solvable, "tags": sorted(v.tags),
            "points": None if b is None else np.asarray(b.points),
            "bw": None if b is None else np.asarray(b.bw),
            "ipc": None if b is None else np.asarray(b.ipc),
            "parametric_point": _array(v.parametric_point),
            "parametric_cov": _array(v.parametric_cov)})
    factors = []
    for f in fg.factors.values():
        d = {"label": f.label, "type": type(f.model).__name__,
             "variables": list(f.variables),
             "multihypo": None if f.multihypo is None else list(f.multihypo),
             "nullhypo": f.nullhypo, "solvable": f.solvable,
             "tags": sorted(f.tags), **_model(f.model)}
        factors.append(d)
    params = {k: v for k, v in dataclasses.asdict(fg.params).items()}
    return {"params": params, "variables": variables, "factors": factors}

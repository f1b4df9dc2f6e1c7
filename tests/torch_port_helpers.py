"""Shared helpers of the tests/test_torch_*.py files (not collected).

The port's tests run the JAX package and the PyTorch port on the same
numpy-made inputs; six pytest workers share the CPU, so each file keeps
torch to two threads.
"""

import time

import numpy as np
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


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def t(a) -> torch.Tensor:
    """float32 CPU tensor from a numpy array."""
    return torch.as_tensor(np.asarray(a, np.float32))


def _dist(z) -> dict:
    mu = np.asarray(z.mu)
    if type(z).__name__ == "Normal":
        return {"type": "Normal", "mu": float(mu), "sigma": float(z.sigma)}
    return {"type": "MvNormal", "mu": mu, "cov": np.asarray(z.cov)}


def jax_graph_to_arrays(fg, solve_key: str = "default") -> dict:
    """The spec dict of incrementalinference_torch.convert, built from a
    JAX-package FactorGraph (its beliefs as numpy arrays)."""
    import dataclasses

    variables = []
    for v in fg.variables.values():
        b = v.beliefs.get(solve_key)
        variables.append({
            "label": v.label, "type": v.vartype.name, "N": v.N,
            "solvable": v.solvable, "tags": sorted(v.tags),
            "points": None if b is None else np.asarray(b.points),
            "bw": None if b is None else np.asarray(b.bw),
            "ipc": None if b is None else np.asarray(b.ipc)})
    factors = []
    for f in fg.factors.values():
        d = {"label": f.label, "type": type(f.model).__name__,
             "variables": list(f.variables),
             "multihypo": None if f.multihypo is None else list(f.multihypo),
             "nullhypo": f.nullhypo, "solvable": f.solvable,
             "tags": sorted(f.tags)}
        if hasattr(f.model, "Z"):
            d["Z"] = _dist(f.model.Z)
        factors.append(d)
    params = {k: v for k, v in dataclasses.asdict(fg.params).items()}
    return {"params": params, "variables": variables, "factors": factors}

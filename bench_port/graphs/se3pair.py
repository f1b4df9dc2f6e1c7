"""Two SE(3) poses, upstream's test/testSpecialEuclidean2Mani.jl two-pose
graph lifted to SpecialEuclidean(3) (RoME's ``Pose3``): a ``ManifoldPrior``
on x0 and a ``ManifoldFactor`` from x0 to x1.  The truth is x0 at the
identity and x1 at Exp(step); each step draws the prior's point (a
translation and a quaternion) and the relative measurement from the truth
and the sigmas, from the seed and the step's index."""

from __future__ import annotations

import numpy as np
import torch

from ..reference.se3 import SE3


def measurements(cfg: dict, seed: int, step: int) -> dict:
    """The step's factors as (variables, value, sigma): a prior's value is
    its point, a relative factor's the measured tangent."""
    g = cfg["graph_params"]
    rng = np.random.default_rng([seed % (1 << 64), step])
    M = SE3()
    sp = np.asarray(g["prior_sigma"], np.float64)
    sig = np.asarray(g["sigma"], np.float64)
    p0 = M.exp(M.identity(), torch.tensor(sp * rng.standard_normal(6)))
    z = np.asarray(g["step"], np.float64) + sig * rng.standard_normal(6)
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64).tolist()
    return {"labels": ["x0", "x1"],
            "factors": [(["x0"], f32(p0.numpy()), sp.tolist()),
                        (["x0", "x1"], f32(z), sig.tolist())]}


def build(cfg: dict, seed: int, step: int, device, graphinit: bool):
    import incrementalinference_torch as it

    meas = measurements(cfg, seed, step)
    M = it.SE3()
    vt = it.VariableType("Pose3", M)
    params = it.SolverParams(N=cfg["N"], graphinit=graphinit,
                             batch_cliques=False,
                             seed=(seed * 1_000_003 + step) % (1 << 62))
    fg = it.initfg(params, device=device)
    for lbl in meas["labels"]:
        fg.add_variable(lbl, vt)
    for vs, value, sigma in meas["factors"]:
        if len(vs) == 1:
            fg.add_factor(vs, it.ManifoldPrior(
                M, np.asarray(value, np.float32),
                it.MvNormal([0.0] * 6, sigma)))
        else:
            fg.add_factor(vs, it.ManifoldFactor(M, it.MvNormal(value, sigma)))
    return fg, meas

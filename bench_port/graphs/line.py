"""A 1-D line of ``ContinuousScalar`` variables x0, x1, ... as upstream's
test/testBasicGraphs.jl chains them: a ``LinearRelative`` from each
variable to the next, and a ``Prior`` on the variables ``priors`` names.
Each step draws every factor's value from the source's value and its
sigma, from the seed and the step's index: a prior's mean, a relative's
measured x_{i+1} - x_i."""

from __future__ import annotations

import numpy as np


def measurements(cfg: dict, seed: int, step: int) -> dict:
    """The step's factors as (variables, value, sigma), each value and
    sigma a list of one: the priors in the order ``priors`` lists them,
    then the relatives along the line."""
    g = cfg["graph_params"]
    rng = np.random.default_rng([seed % (1 << 64), step])
    labels = [f"x{i}" for i in range(g["variables"])]
    f32 = lambda a: [float(np.float32(a))]
    factors = [([labels[i]], f32(m + s * rng.standard_normal()), [float(s)])
               for i, m, s in g["priors"]]
    z, s = g["relative"]
    factors += [([a, b], f32(z + s * rng.standard_normal()), [float(s)])
                for a, b in zip(labels, labels[1:])]
    return {"labels": labels, "factors": factors}


def build(cfg: dict, seed: int, step: int, device, graphinit: bool):
    import incrementalinference_torch as it

    meas = measurements(cfg, seed, step)
    params = it.SolverParams(N=cfg["N"], graphinit=graphinit,
                             batch_cliques=False,
                             seed=(seed * 1_000_003 + step) % (1 << 62))
    fg = it.initfg(params, device=device)
    for lbl in meas["labels"]:
        fg.add_variable(lbl, it.ContinuousScalar)
    for vs, value, sigma in meas["factors"]:
        dist = it.Normal(value[0], sigma[0])
        fg.add_factor(vs, it.Prior(dist) if len(vs) == 1
                      else it.LinearRelative(dist))
    return fg, meas

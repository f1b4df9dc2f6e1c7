"""Dead-reckon tether: parametric means accumulated along factor chains.

Counterpart of ``incrementalinference/jl_tpu/tether.py`` (reference
src/services/TetherUtils.jl accumulateFactorMeans :119-158,
rebaseFactorVariable! :59, and ConsolidateParametricRelatives.jl
solveFactorParametric): real-time prediction outside tree solves.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .ops.convolve import batched_gauss_newton

__all__ = ["solve_factor_parametric", "accumulate_factor_means",
           "rebase_factor_variable"]


def solve_factor_parametric(fg, factor_label: str, target: str,
                            values: dict | None = None) -> torch.Tensor:
    """Point-solve one factor for ``target`` given the means of its other
    variables: ``values[label]`` where given, else the parametric point,
    else the belief's mean (reference solveFactorParametric)."""
    f = fg.factor(factor_label)
    model = f.model
    manifold = fg.var(target).manifold
    dev = fg.device

    def mean_of(v):
        if values is not None and v in values:
            return torch.as_tensor(values[v], dtype=torch.float32,
                                   device=dev)
        var = fg.var(v)
        if var.parametric_point is not None:
            return torch.as_tensor(var.parametric_point, device=dev)
        return var.manifold.mean(fg.points(v))

    mu = torch.as_tensor(model.mean_cov()[0], dtype=torch.float32,
                         device=dev)
    if f.is_prior:
        if hasattr(model, "meas_to_points"):
            return model.meas_to_points(mu[None, :], manifold)[0]
        return mu
    others = tuple(mean_of(v)[None, :] for v in f.variables if v != target)
    solved = batched_gauss_newton(manifold, model, mu[None, :], others,
                                  mean_of(target)[None, :],
                                  sf_slot=f.variables.index(target),
                                  iters=25)
    return solved[0]


def accumulate_factor_means(fg, factor_labels: Sequence[str]) -> torch.Tensor:
    """Walk a chain of relative factors from the first factor's first
    variable, solving each factor for the next variable (reference
    accumulateFactorMeans, TetherUtils.jl:119-158)."""
    values: dict = {}
    current = None
    for fl in factor_labels:
        f = fg.factor(fl)
        if current is None:
            current = f.variables[0]
            var = fg.var(current)
            values[current] = (var.parametric_point
                               if var.parametric_point is not None
                               else var.manifold.mean(fg.points(current)))
        nxt = [v for v in f.variables if v != current]
        if len(nxt) != 1:
            raise ValueError(f"factor {fl} does not continue the chain "
                             f"from {current}")
        values[nxt[0]] = solve_factor_parametric(fg, fl, nxt[0],
                                                 values=values)
        current = nxt[0]
    return values[current]


def rebase_factor_variable(fg, factor_label: str, old_var: str,
                           new_var: str) -> None:
    """Re-point a factor at another variable (reference
    rebaseFactorVariable!, used when re-anchoring the tether)."""
    f = fg.factor(factor_label)
    if old_var not in f.variables:
        raise ValueError(f"{old_var} not in factor {factor_label}")
    if new_var not in fg.variables:
        raise ValueError(f"unknown variable {new_var}")
    f.variables = tuple(new_var if v == old_var else v for v in f.variables)
    fg._var_factors[old_var].remove(factor_label)
    fg._var_factors[new_var].append(factor_label)

"""Factor Jacobians and information propagation.

Counterpart of ``incrementalinference/jl_tpu/ops/gradients.py`` (reference
factorJacobian, FactorGradientsCached!, calcPerturbationFromVariable).  The
Jacobians are exact reverse-mode ``torch.func.jacrev`` derivatives in
tangent coordinates.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch.func import jacrev

__all__ = ["factor_jacobian", "FactorGradientsCached",
           "calc_perturbation_from_variable"]


def _on(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def factor_jacobian(fg, factor_label: str, meas=None,
                    at_points: Sequence | None = None) -> torch.Tensor:
    """Full block Jacobian ∂residual/∂(tangent of each variable), at the
    variables' current mean points unless ``at_points`` is given, and at
    the measurement mean unless ``meas`` is (reference factorJacobian).
    Returns (resdim, Σ dof)."""
    f = fg.factor(factor_label)
    model = f.model
    manifolds = [fg.var(v).manifold for v in f.variables]
    if at_points is None:
        at_points = [m.mean(fg.points(v)) for m, v in
                     zip(manifolds, f.variables)]
    at_points = [_on(p, fg.device) for p in at_points]
    if meas is None:
        meas, _ = model.mean_cov()
    meas = _on(meas, fg.device)

    def res_of_tangents(*Xs):
        pts = [m.exp(p, X) for m, p, X in zip(manifolds, at_points, Xs)]
        return model.residual(meas, *pts)

    zeros = [torch.zeros((m.dof,), device=fg.device) for m in manifolds]
    blocks = [jacrev(res_of_tangents, argnums=i)(*zeros)
              for i in range(len(manifolds))]
    return torch.cat(blocks, dim=-1)


class FactorGradientsCached:
    """Cached per-factor Jacobian blocks (reference FactorGradientsCached!)."""

    def __init__(self, fg, factor_label: str):
        self.fg = fg
        self.factor_label = factor_label
        f = fg.factor(factor_label)
        self.variables = f.variables
        self.manifolds = [fg.var(v).manifold for v in f.variables]
        self.dofs = [m.dof for m in self.manifolds]
        self.offsets = [0]
        for d in self.dofs:
            self.offsets.append(self.offsets[-1] + d)
        self._J = None

    def __call__(self, at_points=None, meas=None) -> torch.Tensor:
        self._J = factor_jacobian(self.fg, self.factor_label, meas=meas,
                                  at_points=at_points)
        return self._J

    @property
    def J(self) -> torch.Tensor:
        if self._J is None:
            self()
        return self._J

    def block(self, var: str) -> torch.Tensor:
        i = self.variables.index(var)
        return self.J[:, self.offsets[i]:self.offsets[i + 1]]


def calc_perturbation_from_variable(cache: FactorGradientsCached, src: str,
                                    delta) -> Dict[str, torch.Tensor]:
    """Propagate a tangent perturbation of ``src`` through the factor to
    first order onto the other variables (reference
    calcPerturbationFromVariable): δr = J_src δx; δx_other = −J_other⁺ δr."""
    dr = cache.block(src) @ _on(delta, cache.fg.device)
    return {v: -torch.linalg.pinv(cache.block(v)) @ dr
            for v in cache.variables if v != src}

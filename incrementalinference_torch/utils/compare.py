"""Structural and statistical comparison helpers.

Counterpart of ``incrementalinference/jl_tpu/utils/compare.py`` (reference
src/services/CompareUtils.jl).  Beliefs are compared on the host.
"""

from __future__ import annotations

import numpy as np

from ..distributions import host32

__all__ = ["compare_beliefs", "compare_variables", "compare_graphs",
           "compare_factors", "compare_all_special"]


def compare_beliefs(a, b, tol: float = 1e-5) -> bool:
    """Particle+bandwidth equality within ``tol`` (reference compare on
    TreeBelief, src/services/CompareUtils.jl)."""
    return (a.points.shape == b.points.shape
            and bool(np.allclose(host32(a.points), host32(b.points), atol=tol))
            and bool(np.allclose(host32(a.bw), host32(b.bw), atol=tol)))


def compare_variables(va, vb, tol: float = 1e-5) -> bool:
    """Reference compareVariable: label/type equality plus per-solveKey
    belief comparison (src/services/CompareUtils.jl)."""
    if va.label != vb.label or va.vartype != vb.vartype:
        return False
    if set(va.beliefs) != set(vb.beliefs):
        return False
    return all(compare_beliefs(va.beliefs[k], vb.beliefs[k], tol)
               for k in va.beliefs)


def compare_factors(x, y, skip: tuple = ()) -> bool:
    """Field-wise factor comparison (reference ``compare`` on DFGFactor /
    ``compareAllSpecial`` on CommonConvWrapper, CompareUtils.jl:24-40).

    ``skip`` names fields to ignore (the reference's ``skip=[:vartypes]``
    escape hatch)."""
    if "variables" not in skip and x.variables != y.variables:
        return False
    if "model" not in skip and type(x.model) is not type(y.model):
        return False
    if "multihypo" not in skip and x.multihypo != y.multihypo:
        return False
    if "nullhypo" not in skip and x.nullhypo != y.nullhypo:
        return False
    return True


def compare_all_special(x, y, skip: tuple = ("vartypes",),
                        show: bool = True) -> bool:
    """Reference ``compareAllSpecial`` (CompareUtils.jl:24-40): lenient
    compare of two factors'/wrappers' compute state, skipping the known
    type-identity field.  Here factor compute plans are static specs, so the
    comparison reduces to the factor fields themselves."""
    ok = compare_factors(x, y, skip=skip)
    if show and not ok:
        print(f"compare_all_special: mismatch between {x!r} and {y!r}")
    return ok


def compare_graphs(fa, fb, tol: float = 1e-5) -> bool:
    """Reference compareFactorGraphs: same variables/factors and
    per-variable belief equality (src/services/CompareUtils.jl)."""
    if fa.ls() != fb.ls() or fa.lsf() != fb.lsf():
        return False
    if not all(compare_variables(fa.var(v), fb.var(v), tol)
               for v in fa.ls()):
        return False
    for fl in fa.lsf():
        x, y = fa.factor(fl), fb.factor(fl)
        if x.variables != y.variables or type(x.model) is not type(y.model):
            return False
        if x.multihypo != y.multihypo or x.nullhypo != y.nullhypo:
            return False
    return True

"""Default factor-type selection between variable types.

Counterpart of ``incrementalinference/jl_tpu/utils/defaults.py`` (reference
selectFactorType): Position{N} pairs → LinearRelative; circular pairs →
CircularCircular; group-manifold pairs → ManifoldFactor on that group.
"""

from __future__ import annotations

from ..distributions import MvNormal, Normal
from ..graph import VariableType
from ..manifolds import Circle, Euclidean
from ..models import CircularCircular, LinearRelative, ManifoldFactor

__all__ = ["select_factor_type"]


def select_factor_type(t1: VariableType, t2: VariableType):
    """A default relative factor for a variable pair (an instance; callers
    that need the type take ``type(...)`` of it)."""
    m1, m2 = t1.manifold, t2.manifold
    if m1 != m2:
        raise ValueError(f"no default factor between {t1} and {t2}")
    if isinstance(m1, Euclidean):
        n = m1.n
        z = Normal(0.0, 1.0) if n == 1 else MvNormal([0.0] * n, [1.0] * n)
        return LinearRelative(z)
    if isinstance(m1, Circle):
        return CircularCircular(Normal(0.0, 0.1))
    return ManifoldFactor(m1, MvNormal([0.0] * m1.dof, [1.0] * m1.dof))

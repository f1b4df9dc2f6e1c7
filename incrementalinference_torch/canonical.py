"""Canonical graph generators.

Counterpart of the generators of ``incrementalinference/jl_tpu/canonical.py``
that the main path uses (reference CanonicalGraphExamples.jl:
generateGraph_Kaess, generateGraph_LineStep).
"""

from __future__ import annotations

from typing import List, Optional

from .config import SolverParams
from .distributions import MvNormal, Normal
from .graph import ContinuousEuclid, ContinuousScalar, FactorGraph, initfg
from .models import LinearRelative, Prior

__all__ = ["generate_kaess", "generate_line_step"]


def generate_kaess(graphinit: bool = False,
                   params: Optional[SolverParams] = None,
                   device=None) -> FactorGraph:
    """Kaess et al. iSAM2 worked example (5 vars)."""
    fg = initfg(params, device=device)
    fg.add_variable("x1", ContinuousScalar)
    fg.add_factor(["x1"], Prior(Normal(0, 1)), graphinit=graphinit)
    for a, b, new in (("x1", "x2", "x2"), ("x2", "x3", "x3"),
                      ("x1", "l1", "l1"), ("x2", "l1", None),
                      ("x3", "l2", "l2")):
        if new is not None:
            fg.add_variable(new, ContinuousScalar)
        fg.add_factor([a, b], LinearRelative(Normal(0, 1)),
                      graphinit=graphinit)
    return fg


def generate_line_step(line_length: int, pose_every: int = 2,
                       landmark_every: int = 4,
                       pose_priors_at=(0,), landmark_priors_at=(),
                       sight_distance: int = 4, vardims: int = 1,
                       sigma_pose_prior: float = 0.1,
                       sigma_lm_prior: float = 0.1,
                       sigma_pose_pose: float = 0.1,
                       sigma_pose_lm: float = 0.1,
                       graphinit: bool = False,
                       params: Optional[SolverParams] = None,
                       device=None) -> FactorGraph:
    """Poses and landmark sightings along a line; each pose's id is its
    ground truth."""
    vtype = ContinuousScalar if vardims == 1 else ContinuousEuclid(vardims)

    def noise(i: float, s: float):
        if vardims == 1:
            return Normal(float(i), s)
        return MvNormal([float(i)] * vardims, [s] * vardims)

    fg = initfg(params, device=device)
    xs: List[int] = []
    lms: List[int] = []
    for i in range(line_length + 1):
        if i % pose_every == 0:
            xs.append(i)
            fg.add_variable(f"x{i}", vtype)
            if i in pose_priors_at:
                fg.add_factor([f"x{i}"], Prior(noise(i, sigma_pose_prior)),
                              graphinit=graphinit)
            if i > 0:
                fg.add_factor([f"x{i - pose_every}", f"x{i}"],
                              LinearRelative(noise(pose_every,
                                                   sigma_pose_pose)),
                              graphinit=graphinit)
        if landmark_every and i % landmark_every == 0:
            lms.append(i)
            fg.add_variable(f"lm{i}", vtype)
            if i in landmark_priors_at:
                fg.add_factor([f"lm{i}"], Prior(noise(i, sigma_lm_prior)),
                              graphinit=graphinit)
    for xi in xs:
        for lmi in lms:
            if abs(lmi - xi) < sight_distance:
                fg.add_factor([f"x{xi}", f"lm{lmi}"],
                              LinearRelative(noise(lmi - xi, sigma_pose_lm)),
                              graphinit=graphinit)
    return fg

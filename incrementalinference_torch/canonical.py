"""Canonical graph generators.

Counterpart of ``incrementalinference/jl_tpu/canonical.py`` (reference
CanonicalGraphExamples.jl: generateGraph_Kaess, _TestSymbolic,
_CaesarRing1D, _LineStep, _EuclidDistance), the SE(2) hexagon of the
reference benchmark suite and the fourdoor sequence (reference
test/fourdoortest.jl).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .config import SolverParams
from .distributions import MvNormal, Normal
from .graph import (ContinuousEuclid, ContinuousScalar, FactorGraph,
                    VariableType, initfg)
from .manifolds import SE2
from .models import (EuclidDistance, FactorModel, LinearRelative,
                     ManifoldFactor, ManifoldPrior, Mixture, Prior,
                     register_factor_model)

__all__ = ["generate_kaess", "generate_test_symbolic",
           "generate_caesar_ring1d", "generate_line_step",
           "generate_euclid_distance", "generate_hexagonal",
           "fourdoor_sequence", "calc_helix_T"]


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


def generate_test_symbolic(graphinit: bool = False,
                           device=None) -> FactorGraph:
    """Borglab symbolic-elimination example (8 vars)."""
    fg = initfg(device=device)
    for v in ["x1", "x2", "x3", "x4", "x5", "l1", "l2", "l3"]:
        fg.add_variable(v, ContinuousScalar)
    for a, b in [("x1", "l1"), ("x1", "x2"), ("x2", "l1"), ("x2", "x3"),
                 ("x3", "x4"), ("x4", "l2"), ("x4", "x5"), ("l2", "x5"),
                 ("x4", "l3"), ("x5", "l3")]:
        fg.add_factor([a, b], LinearRelative(Normal(0, 1)),
                      graphinit=graphinit)
    return fg


def generate_caesar_ring1d(graphinit: bool = False,
                           device=None) -> FactorGraph:
    """Caesar hex example: 7 poses and one landmark closing the loop."""
    fg = initfg(device=device)
    for i in range(7):
        fg.add_variable(f"x{i}", ContinuousScalar)
    fg.add_factor(["x0"], Prior(Normal(0, 1)), graphinit=graphinit)
    for i in range(6):
        fg.add_factor([f"x{i}", f"x{i + 1}"], LinearRelative(Normal(0, 1)),
                      graphinit=graphinit)
    fg.add_variable("l1", ContinuousScalar)
    for x in ("x0", "x6"):
        fg.add_factor([x, "l1"], LinearRelative(Normal(0, 1)),
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


def generate_euclid_distance(points=((100.0, 0.0), (0.0, 100.0)),
                             dist: float = 100.0, sigma_prior: float = 1.0,
                             sigma_dist: float = 1.0, N: int = 100,
                             graphinit: bool = False,
                             device=None) -> FactorGraph:
    """Range-only landmark graph: the rings around the prior points
    intersect in more than one mode."""
    dims = len(points[0])
    fg = initfg(SolverParams(N=N, graphinit=graphinit), device=device)
    for i, p in enumerate(points):
        lbl = f"x{i + 1}"
        fg.add_variable(lbl, ContinuousEuclid(dims))
        fg.add_factor([lbl], Prior(MvNormal(list(p), [sigma_prior] * dims)))
    fg.add_variable("l1", ContinuousEuclid(dims))
    for i in range(len(points)):
        fg.add_factor([f"x{i + 1}", "l1"],
                      EuclidDistance(Normal(dist, sigma_dist)))
    return fg


class _Pose2Point2Bearingless(FactorModel):
    """SE(2) pose → R² landmark offset factor of the hexagonal fixture: the
    landmark sits at body-frame offset z from the pose."""

    zdim = 2

    def __init__(self, Z: Optional[MvNormal] = None):
        self.Z = Z or MvNormal([10.0, 0.0], [0.3, 0.3])

    def sample(self, gen, n):
        return self.Z.sample(gen, n)

    def residual(self, meas, pose, lmk):
        c, s = torch.cos(pose[..., 2:]), torch.sin(pose[..., 2:])
        dx = lmk[..., 0:1] - pose[..., 0:1]
        dy = lmk[..., 1:2] - pose[..., 1:2]
        return meas - torch.cat([c * dx + s * dy, -s * dx + c * dy], dim=-1)

    def mean_cov(self):
        return self.Z.mean_cov()


register_factor_model(_Pose2Point2Bearingless, ("Z",))


def generate_hexagonal(graphinit: bool = True, landmark: bool = True,
                       params: Optional[SolverParams] = None,
                       device=None) -> FactorGraph:
    """SE(2) hexagonal ring, optionally with one landmark sighted from the
    first and the last pose (the loop closure): the RoME-style graph of the
    reference benchmark suite."""
    fg = initfg(params, device=device)
    se2 = SE2()
    pose2 = VariableType("Pose2", se2)
    fg.add_variable("x0", pose2)
    fg.add_factor(["x0"], ManifoldPrior(
        se2, [0.0] * 3, MvNormal([0.0] * 3, [0.1, 0.1, 0.05])),
        graphinit=graphinit)
    # drive 6 sides of a hexagon: forward 10, turn 60 deg
    step = MvNormal([10.0, 0.0, math.pi / 3], [0.5, 0.5, 0.05])
    for i in range(6):
        fg.add_variable(f"x{i + 1}", pose2)
        fg.add_factor([f"x{i}", f"x{i + 1}"], ManifoldFactor(se2, step),
                      graphinit=graphinit)
    if landmark:
        fg.add_variable("l1", ContinuousEuclid(2))
        for x in ("x0", "x6"):
            fg.add_factor([x, "l1"], _Pose2Point2Bearingless(),
                          graphinit=graphinit)
    return fg


def fourdoor_sequence(params: Optional[SolverParams] = None, device=None
                      ) -> Tuple[FactorGraph, List[Callable[[], None]]]:
    """The fourdoor multimodal 1-D robot story (reference
    test/fourdoortest.jl) as (fg, steps): each step grows ``fg`` and
    expects a solve after it."""
    fg = initfg(params, device=device)
    cv = 3.0
    door = Mixture(Prior,
                   [Normal(-100, cv), Normal(0, cv), Normal(100, cv),
                    Normal(300, cv)], [0.25, 0.25, 0.25, 0.25])

    def step1():
        fg.add_variable("x1", ContinuousScalar)
        fg.add_factor(["x1"], door)

    def step2():
        fg.add_variable("x2", ContinuousScalar)
        fg.add_factor(["x1", "x2"], LinearRelative(Normal(50.0, 2.0)))
        fg.add_variable("x3", ContinuousScalar)
        fg.add_factor(["x2", "x3"], LinearRelative(Normal(50.0, 4.0)))
        fg.add_factor(["x3"], door)

    def step3():
        fg.add_variable("x4", ContinuousScalar)
        fg.add_factor(["x3", "x4"], LinearRelative(Normal(200.0, 4.0)))
        fg.add_factor(["x4"], door)

    return fg, [step1, step2, step3]


def calc_helix_T(t_start=0.0, t_stop=1.0, points_per_turn=20,
                 direction=-1, radius=0.5, spine=lambda t: 0.0 + 0.0j):
    """Helix trajectory (reference calcHelix_T): returns (T, xy (n, 2),
    yaw (n,)) as numpy arrays, the yaw from a forward difference."""
    T = np.arange(t_start, t_stop * points_per_turn + 1) / points_per_turn

    def f(t):
        return radius * (np.exp(1j * (np.pi + direction * 2 * np.pi * t))
                         + 1 + spine(t))

    vals = np.array([f(t) for t in T])
    h = 1e-8
    grad = np.array([(f(t + h) - f(t)) / h for t in T])
    return (T, np.stack([vals.real, vals.imag], axis=1), np.angle(grad))

"""Incremental SE(2) SLAM through the PyTorch port: odometry arcs, a
landmark, clique recycling, persistence and a parametric cross-check.

Four poses are added one at a time along an arc, each followed by an
incremental solve that recycles the unchanged cliques of the tree before
it; the second pose sights a landmark.  The graph is then saved, loaded
back and solved parametrically.

Run, from the repository root:

    PYTHONPATH=. python examples_torch/se2_slam.py [--device cpu] [--n N]

It runs on the CUDA device unless ``--device cpu`` is given, and exits
non-zero if the last solve recycled no clique, a pose misses the bar of
tests/test_manifold_solves.py:36-54 (four fifths of its particles within
0.6 of the pose composed from the odometry), or a nonparametric mean lies
further than 1.5 from the parametric optimum
(tests/test_manifold_solves.py:133-150).
"""

import argparse
import os
import tempfile

import torch

from incrementalinference_torch import (SE2, ContinuousEuclid,
                                        ManifoldFactor, ManifoldPrior,
                                        MvNormal, SolverParams, VariableType,
                                        initfg, load_graph, save_graph,
                                        solve_tree)
from incrementalinference_torch.canonical import _Pose2Point2Bearingless
from incrementalinference_torch.parametric import solve_graph_parametric

STEP = (2.0, 0.0, 0.6)
SIGHTING = (3.0, 0.0)


def bar(cond, msg):
    if not cond:
        raise AssertionError(msg)


def start(device="cuda", n=100):
    """The graph before the first pose step: x0 and its prior."""
    se2 = SE2()
    fg = initfg(SolverParams(N=n), device=device)
    fg.add_variable("x0", VariableType("Pose2", se2))
    fg.add_factor(["x0"], ManifoldPrior(
        se2, torch.zeros(3), MvNormal([0.0] * 3, [0.05, 0.05, 0.02])))
    return fg


def add_pose(fg, i):
    """Pose ``x{i}`` and its odometry factor; at i = 2 also the landmark
    and its sighting."""
    se2 = fg.var("x0").manifold
    fg.add_variable(f"x{i}", VariableType("Pose2", se2))
    fg.add_factor([f"x{i-1}", f"x{i}"], ManifoldFactor(
        se2, MvNormal(list(STEP), [0.05, 0.05, 0.02])))
    if i == 2:
        fg.add_variable("l1", ContinuousEuclid(2))
        fg.add_factor(["x2", "l1"], _Pose2Point2Bearingless(
            MvNormal(list(SIGHTING), [0.1, 0.1])))
    return fg


def build(device="cuda", n=100):
    """The whole graph, four poses and the landmark, unsolved."""
    fg = start(device, n)
    for i in range(1, 5):
        add_pose(fg, i)
    return fg


def truth(se2, i, device):
    """Pose i composed from the noiseless odometry."""
    step = se2.exp(se2.identity().to(device),
                   torch.tensor(STEP, device=device))
    x = se2.identity().to(device)
    for _ in range(i):
        x = se2.compose(x, step)
    return x


def main(device="cuda", n=100):
    fg = start(device, n)
    tree = None
    for i in range(1, 5):
        add_pose(fg, i)
        tree = solve_tree(fg, old_tree=tree)       # incremental
    recycled = sum(c.is_recycled for c in tree.cliques.values())
    print(f"recycled cliques in final incremental solve: "
          f"{recycled}/{tree.num_cliques()}")
    bar(recycled > 0, "the last incremental solve recycled no clique")
    se2 = fg.var("x0").manifold
    for i in range(1, 5):
        p = fg.points(f"x{i}")
        near = float((se2.dist(p, truth(se2, i, p.device)) < 0.6)
                     .float().mean())
        bar(near > 0.8, f"x{i}: {near} of its particles within 0.6")

    with tempfile.TemporaryDirectory(prefix="iitorch_se2_") as tmp:
        path = save_graph(fg, os.path.join(tmp, "se2_slam.json"))
        fg2 = load_graph(path, device=device)
    solve_graph_parametric(fg2)
    for v in ("x4", "l1"):
        point = fg2.var(v).parametric_point
        print(v, "parametric:", [round(float(x), 2) for x in point])
        mean = fg.var(v).manifold.mean(fg.points(v))
        d = float(fg.var(v).manifold.dist(mean, point))
        bar(d < 1.5, f"{v}: nonparametric mean {d} from the parametric "
                     f"optimum")
    return fg, fg2, tree


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="incremental SE(2) SLAM "
                                             "through the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100, help="particles")
    a = ap.parse_args()
    main(device=a.device, n=a.n)

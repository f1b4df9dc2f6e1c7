"""The classic fourdoor multimodal 1-D robot (reference
test/fourdoortest.jl), through the PyTorch port.

A robot on a line sees a door three times.  The door map has four doors,
so one sighting leaves four modes; odometry and a second sighting leave
two; a third leaves one.  Each solve after the first recycles the cliques
of the tree before it (``old_tree``).

Run, from the repository root:

    PYTHONPATH=. python examples_torch/fourdoor.py [--device cpu] [--n N]

It runs on the CUDA device unless ``--device cpu`` is given, and exits
non-zero if a solve misses the bars of tests/test_solve.py:17-40.
"""

import argparse

from incrementalinference_torch import (ContinuousScalar, LinearRelative,
                                        Mixture, Normal, Prior, SolverParams,
                                        initfg, solve_tree)

DOORS = (-100.0, 0.0, 100.0, 300.0)


def bar(cond, msg):
    if not cond:
        raise AssertionError(msg)


def mass(fg, v, c, tol=20.0):
    """Share of ``v``'s particles within ``tol`` of ``c``."""
    return float(((fg.points(v)[:, 0] - c).abs() < tol).float().mean())


def modes(fg, v, centers, tol=20.0):
    return {c: round(mass(fg, v, c, tol), 2) for c in centers
            if mass(fg, v, c, tol) > 0.05}


def build_first_sighting(device="cuda", n=100):
    """The graph of the first solve: x1 and one door sighting.  Returns
    the graph and the door prior that later sightings reuse."""
    fg = initfg(SolverParams(N=n), device=device)
    door = Mixture(Prior, [Normal(c, 3.0) for c in DOORS], [0.25] * 4)
    fg.add_variable("x1", ContinuousScalar)
    fg.add_factor(["x1"], door)
    return fg, door


def add_second_sighting(fg, door):
    fg.add_variable("x2", ContinuousScalar)
    fg.add_factor(["x1", "x2"], LinearRelative(Normal(50.0, 2.0)))
    fg.add_variable("x3", ContinuousScalar)
    fg.add_factor(["x2", "x3"], LinearRelative(Normal(50.0, 4.0)))
    fg.add_factor(["x3"], door)
    return fg


def add_third_sighting(fg, door):
    fg.add_variable("x4", ContinuousScalar)
    fg.add_factor(["x3", "x4"], LinearRelative(Normal(200.0, 4.0)))
    fg.add_factor(["x4"], door)
    return fg


def build(device="cuda", n=100):
    """The whole graph, all three sightings, unsolved."""
    fg, door = build_first_sighting(device, n)
    add_second_sighting(fg, door)
    return add_third_sighting(fg, door)


def main(device="cuda", n=100):
    fg, door = build_first_sighting(device, n)
    tree = solve_tree(fg)
    print("after 1 sighting, x1 modes:", modes(fg, "x1", DOORS))
    for c in DOORS:
        bar(mass(fg, "x1", c) > 0.08, f"after 1 sighting: door {c} lost")

    add_second_sighting(fg, door)
    tree = solve_tree(fg, old_tree=tree)
    print("after 2 sightings, x1 modes:", modes(fg, "x1", DOORS))
    bar(mass(fg, "x1", -100) + mass(fg, "x1", 0) > 0.8,
        "after 2 sightings: x1 not on {-100, 0}")
    bar(mass(fg, "x1", 300) < 0.1, "after 2 sightings: x1 still at 300")
    bar(mass(fg, "x3", 0) + mass(fg, "x3", 100) > 0.8,
        "after 2 sightings: x3 not on {0, 100}")

    add_third_sighting(fg, door)
    tree = solve_tree(fg, old_tree=tree)
    for v, c in (("x1", 0.0), ("x2", 50.0), ("x3", 100.0), ("x4", 300.0)):
        p = fg.points(v)[:, 0]
        print(f"{v}: mean={float(p.mean()):7.1f}  "
              f"std={float(p.std(correction=0)):5.1f}")
        bar(mass(fg, v, c) >= 0.8, f"after 3 sightings: {v} not at {c}")
        bar(abs(float(p.mean()) - c) < 10.0,
            f"after 3 sightings: {v} mean {float(p.mean())} (truth {c})")
    return fg, tree


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="fourdoor through the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100, help="particles")
    a = ap.parse_args()
    main(device=a.device, n=a.n)

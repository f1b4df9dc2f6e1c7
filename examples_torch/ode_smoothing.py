"""Dynamics-constrained smoothing with DERelative (reference
ext/IncrInfrDiffEqFactorExt.jl; test territory testDERelative.jl), through
the PyTorch port.

A forced first-order system ẋ = -0.5x + u(t) is observed sparsely and
noisily; DERelative factors chain the states through the integrated flow
(RK4 inside the residual), and a third factor variable estimates an
unknown decay rate from the data.

Run, from the repository root:

    PYTHONPATH=. python examples_torch/ode_smoothing.py \
        [--device cpu] [--n N] [--nary-steps S]

It runs on the CUDA device unless ``--device cpu`` is given, and exits
non-zero if a smoothed state is 0.3 or more from the integrated truth or
the decay rate 0.15 or more from 0.7 (the bars of the reference package's
example).  ``--nary-steps`` sets the RK4 steps of the decay-rate factor
(32, as in that example).
"""

import argparse
import math

import torch

from incrementalinference_torch import (ContinuousScalar, DERelative,
                                        MvNormal, Normal, Prior,
                                        SolverParams, initfg, resolve_device,
                                        solve_tree)

# control trajectory u(t) = sin(t), sampled on a uniform grid; DERelative
# passes it to the dynamics as ``data`` and the dynamics interpolate
T0, T1, GRID = 0.0, 6.0, 25
DT = (T1 - T0) / (GRID - 1)


def bar(cond, msg):
    if not cond:
        raise AssertionError(msg)


def control():
    tgrid = torch.linspace(T0, T1, GRID)
    return torch.stack([tgrid, torch.sin(tgrid)])


def interp(t, u):
    """``jnp.interp(t, u[0], u[1])`` on the uniform grid.  ``t`` arrives as
    a Python float, so the cell is found on the host; only the lerp of two
    grid values is a tensor operation, which keeps it valid inside
    ``vmap(jacfwd)``."""
    s = min(max((t - T0) / DT, 0.0), GRID - 1.0)
    i = min(int(s), GRID - 2)
    return torch.lerp(u[1, i], u[1, i + 1], s - i)


def f(t, x, u):
    # -0.5 x as an alpha-add: under forward mode a product with a constant
    # costs host time, an alpha-add does not
    return torch.add(interp(t, u), x, alpha=-0.5)


def truth_states(device="cuda"):
    """x0 = 2 and the flow over [0, 2], [2, 4], [4, 6], 32 RK4 steps each."""
    device = resolve_device(device)
    truth = [2.0]
    for k in range(3):
        seg = DERelative(f, 2.0 * k, 2.0 * (k + 1), dim=1, data=control(),
                         steps=32)
        truth.append(float(seg.flow(torch.tensor([truth[k]],
                                                 device=device))[0]))
    return truth


def build_forced(truth, device="cuda", n=100):
    fg = initfg(SolverParams(N=n), device=device)
    for k in range(4):
        fg.add_variable(f"x{k}", ContinuousScalar)
    fg.add_factor(["x0"], Prior(Normal(2.0, 0.05)))
    # noisy observation only at the END of the window
    fg.add_factor(["x3"], Prior(Normal(truth[3] + 0.1, 0.2)))
    for k in range(3):
        fg.add_factor([f"x{k}", f"x{k+1}"],
                      DERelative(f, 2.0 * k, 2.0 * (k + 1),
                                 Z=MvNormal([0.0], [0.01]), dim=1,
                                 data=control(), steps=32))
    return fg


def g(t, x, k):
    return -k[..., :1] * x


X1_TRUTH = 2.0 * math.exp(-1.4)        # k = 0.7 over [0, 2]


def build_decay(device="cuda", n=100, nary_steps=32):
    """The n-ary DERelative: states a, b and the decay rate k."""
    de = DERelative(g, 0.0, 2.0, MvNormal([0.0], [1e-4]), dim=1,
                    steps=nary_steps)
    fg = initfg(SolverParams(N=n), device=device)
    for v in ("a", "b", "k"):
        fg.add_variable(v, ContinuousScalar)
    fg.add_factor(["a"], Prior(Normal(2.0, 0.02)))
    fg.add_factor(["b"], Prior(Normal(X1_TRUTH, 0.02)))
    fg.add_factor(["k"], Prior(Normal(0.5, 0.5)))
    fg.add_factor(["a", "b", "k"], de)
    return fg


def mean(fg, v):
    return float(fg.points(v)[:, 0].mean())


def main(device="cuda", n=100, nary_steps=32):
    truth = truth_states(device)
    fg = build_forced(truth, device, n)
    solve_tree(fg)
    print("forced-flow smoothing (truth -> posterior mean):")
    for k in range(4):
        print(f"  x{k}: {truth[k]:+.3f} -> {mean(fg, f'x{k}'):+.3f}")
        bar(abs(mean(fg, f"x{k}") - truth[k]) < 0.3,
            f"x{k}: {mean(fg, f'x{k}')} against {truth[k]}")

    # parameter estimation: unknown decay rate k as a THIRD factor
    # variable (reference n-ary DERelative splat)
    fk = build_decay(device, n, nary_steps)
    solve_tree(fk)
    print(f"decay-rate estimation: k = {mean(fk, 'k'):.3f} (truth 0.700)")
    bar(abs(mean(fk, "k") - 0.7) < 0.15, f"k = {mean(fk, 'k')}")
    return fg, fk, truth


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="ODE smoothing through the "
                                             "port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100, help="particles")
    ap.add_argument("--nary-steps", type=int, default=32,
                    help="RK4 steps of the decay-rate factor")
    a = ap.parse_args()
    main(device=a.device, n=a.n, nary_steps=a.nary_steps)

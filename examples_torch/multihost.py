"""Multi-process distributed solve through the PyTorch port.

Spawns two localhost processes that jointly solve a 12-branch anchored
forest (the multi-session SLAM shape: one shared anchor, independent
mapping sessions below it), then re-solve incrementally after growing one
branch: the distribution axis the reference reaches with ``addprocs(2)``
+ ``solveTree!(...; multiproc=true)`` (test/testMultiprocess.jl:4-13),
here as a subtree partition with the messages across the cut exchanged
by gloo collectives (incrementalinference_torch/parallel/multihost.py).
Both processes may share one GPU.  Then the parametric variant (Gaussian
cut messages).

Run, from the repository root:

    PYTHONPATH=. python examples_torch/multihost.py \
        [--device cpu] [--n N] [--scale S]

It runs on the CUDA device unless ``--device cpu`` is given, and exits
non-zero if the two processes do not hold the same posterior.  ``--n`` is
the particle count of the fixture (64, as in the reference package's
example) and ``--scale`` its number of branches.
"""

import argparse

from incrementalinference_torch.parallel.multihost import launch_multihost


def bar(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main(device="cuda", n=64, scale=12, grow=3, timeout=900.0):
    print("launching 2 processes (gloo collectives)…")
    reps = launch_multihost(2, "anchored_forest", scale=scale,
                            devices_per_proc=2, grow=grow, timeout=timeout,
                            N=n, device=device)
    for r in reps:
        w = r["warm"]
        print(f"process {r['pid']}: {w['n_cliques']} cliques, "
              f"warm solve {w['timings']['total_s']:.2f}s "
              f"(local up {w['timings']['local_up_s']:.2f}s, "
              f"exchange {w['timings']['exchange_up_s']*1e3:.0f}ms), "
              f"max err {w['max_err']:.3f}")
        i = r["incr"]
        print(f"  incremental re-solve (+{grow} poses): "
              f"{i['timings']['total_s']:.2f}s, "
              f"{i['n_recycled']}/{i['n_cliques']} cliques recycled, "
              f"max err {i['max_err']:.3f}")
    bar(abs(reps[0]["warm"]["max_err"] - reps[1]["warm"]["max_err"]) < 1e-6,
        "the two processes hold different posteriors")
    print("both processes hold the identical full posterior ✓")

    print("\nparametric variant (Gaussian cut messages):")
    reps_p = launch_multihost(2, "anchored_forest", scale=scale,
                              devices_per_proc=1, algorithm="parametric",
                              timeout=timeout, N=n, device=device)
    for r in reps_p:
        print(f"process {r['pid']}: warm "
              f"{r['warm']['timings']['total_s']:.2f}s, "
              f"max err {r['warm']['max_err']:.3f}")
    return reps, reps_p


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="two-process solve through "
                                             "the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=64, help="particles")
    ap.add_argument("--scale", type=int, default=12, help="branches")
    a = ap.parse_args()
    main(device=a.device, n=a.n, scale=a.scale)

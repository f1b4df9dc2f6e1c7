"""Migrating from IncrementalInference.jl: load a saveDFG archive, solve,
save it back, through the PyTorch port.

The reference ecosystem persists graphs with ``saveDFG(fg, path)``: a
tar.gz (or directory) of per-variable and per-factor packed JSON
(DispatchPackedConversions.jl:25-160, SerializingDistributions.jl:4-38).
``serialization.load_dfg_archive`` rebuilds a solvable graph from that
wire format (packed distributions, the standard factor models, variable
types, the 1-based to 0-based index shifts, point-major solver data), and
``save_dfg_archive`` writes the same layout back, solved beliefs included.

Run, from the repository root:

    PYTHONPATH=. python examples_torch/migrate_from_reference.py \
        [ARCHIVE] [--device cpu] [--n N]

ARCHIVE defaults to the repository's golden archive,
tests/fixtures/dfg_archive (nothing is downloaded); ``--n`` is the
particle count of variables the archive stores no points for.  It runs on
the CUDA device unless ``--device cpu`` is given, and exits non-zero if
the solve misses the bars of tests/test_dfg_import.py:58-76 (only for the
golden archive) or the archive written back does not load back equal.
"""

import argparse
import os
import tempfile

import torch

from incrementalinference_torch import solve_tree
from incrementalinference_torch.serialization import (load_dfg_archive,
                                                      save_dfg_archive)

ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "dfg_archive")


def bar(cond, msg):
    if not cond:
        raise AssertionError(msg)


def build(archive=ARCHIVE, device="cuda", n=100):
    """The archive's graph, as loaded (unsolved)."""
    return load_dfg_archive(archive, n_default=n, device=device)


def check_golden(fg):
    """tests/test_dfg_import.py:58-76: the fourdoor step-2 sub-story inside
    the archive (x0 on {-100, 0}), the landmark on its priors, the circular
    variable on its wrapped prior."""
    p0 = fg.points("x0")[:, 0]
    m = float(((p0 + 100).abs() < 20).float().mean()
              + (p0.abs() < 20).float().mean())
    bar(m > 0.8, f"x0 mass on {{-100, 0}}: {m}")
    bar(float(((p0 - 300).abs() < 20).float().mean()) < 0.1, "x0 at 300")
    l1 = fg.points("l1").mean(0)
    bar(abs(float(l1[0]) - 3.2) < 0.5 and abs(float(l1[1]) + 2.0) < 0.5,
        f"l1 mean {l1.tolist()}")
    th = float(((fg.points("theta")[:, 0] - 3.0).abs() < 0.5).float().mean())
    bar(th > 0.9, f"theta share near 3.0: {th}")


def main(archive=ARCHIVE, device="cuda", n=100):
    fg = build(archive, device, n)
    print(f"loaded: {len(fg.ls())} variables {sorted(fg.ls())}, "
          f"{len(fg.lsf())} factors")
    for v in sorted(fg.ls()):
        var = fg.var(v)
        print(f"  {v}: {var.vartype.name} "
              f"(initialized={var.is_initialized()})")

    solve_tree(fg)
    print("posterior means after solve_tree:")
    for v in sorted(fg.ls()):
        mu = fg.points(v).mean(dim=0)
        print(f"  {v}: {[round(float(x), 2) for x in mu]}")
    if os.path.abspath(archive) == ARCHIVE:
        check_golden(fg)

    # migrating back (or exchanging with a running Caesar stack):
    # save_dfg_archive writes the same saveDFG layout, solved beliefs
    # included, so the reference's loadDFG (or load_dfg_archive here) can
    # pick the session back up
    with tempfile.TemporaryDirectory(prefix="iitorch_migrate_") as tmp:
        out = save_dfg_archive(fg, os.path.join(tmp, "migrated_back.tar.gz"))
        fg2 = load_dfg_archive(out, n_default=n, device=device)
        print(f"round-trip: wrote {os.path.basename(out)}, re-imported "
              f"{len(fg2.ls())} variables / {len(fg2.lsf())} factors")
    bar(sorted(fg2.ls()) == sorted(fg.ls())
        and sorted(fg2.lsf()) == sorted(fg.lsf()),
        "the archive written back holds other variables or factors")
    for v in fg.ls():
        bar(torch.equal(fg2.points(v), fg.points(v)),
            f"the archive written back holds other points of {v}")
    return fg, fg2


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="saveDFG archive through the "
                                             "port")
    ap.add_argument("archive", nargs="?", default=ARCHIVE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100,
                    help="particles of variables stored without points")
    a = ap.parse_args()
    main(archive=a.archive, device=a.device, n=a.n)

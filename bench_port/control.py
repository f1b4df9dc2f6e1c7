"""The readings a cell's limits are set from: the program's, and the
control's, the reference put in the program's place in a lower precision.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,13 \
        --steps 4 [--precisions bfloat16,tf32] [--faults half_stale,...]

For each seed it runs ``--steps`` steps of the cell (as many as a run
compares), then prints one JSON line: every check's numbers for the
program's outputs and, for each precision, for the control's.  Then, for
each fault of ``faults.py`` named, the same steps again with the fault
planted, one line for each of the first three seeds.  The benchmark's own runs never run this.  Needs
the card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, steps, precisions, device, sync):
    """{source: {number: value}} of ``steps`` steps of the cell."""
    from bench_port.lib import registry
    from bench_port.run import Runner, sample

    runner = Runner(cell, seed, device, sync)
    records = [runner.step(k) for k in range(1, steps + 1)]
    ctx = {"cfg": cell["cfg"], "traffic": cell["traffic"]}
    out = {}
    for source in ("program",) + tuple(precisions):
        out[source] = {}
        for name, count in cell["traffic"]["checks"].items():
            got, _ = registry.module("checks", name).judge(
                sample(records, count, seed), ctx, source)
            out[source].update(got)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--precisions", default="bfloat16,tf32")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_port.lib import registry

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(registry.benchmark(), args.workload)
    precisions = [p for p in args.precisions.split(",") if p]
    seeds = [int(s) for s in args.seeds.split(",")]
    dev, sync = torch.device("cuda", 0), torch.cuda.synchronize
    for seed in seeds:
        got = readings(cell, seed, args.steps, precisions, dev, sync)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "steps": args.steps, "readings": got}), flush=True)
    from bench_port import faults

    for fault in (f for f in args.faults.split(",") if f):
        obj, attr, new = faults.patch(fault)
        real = getattr(obj, attr)
        setattr(obj, attr, new)
        try:
            for seed in seeds[:3]:
                got = readings(cell, seed, args.steps, (), dev, sync)
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "steps": args.steps, "fault": fault,
                                  "readings": got}), flush=True)
        finally:
            setattr(obj, attr, real)
    return 0


if __name__ == "__main__":
    sys.exit(main())

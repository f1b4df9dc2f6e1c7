"""One run of one cell of the port's benchmark.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up (imports, the CUDA context, the port's compiled libraries from its
in-checkout build directories, the first graph build, one warm-up step of
the cell's shapes), then runs a closed loop of smoothing steps for
``--seconds``: one client starts each step when the previous one has
finished, and the step in flight at the close finishes.  A step runs the
traffic's phases (``phases/``): it builds the cell's graph from
measurements drawn from ``--seed`` and its index, solves it with
``solve_tree`` and, where the traffic names ``ppe``, reads every
variable's estimates with ``set_ppe``.  After the window the checks named
by the traffic compare the steps' outputs with the plain references.  The
last line of standard output is the result (see README.md); the checks'
numbers beside their limits are the last lines of standard error.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names no run may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "incrementalinference")
#: steps a traced run profiles, from the window's first: one SE(2) step
#: runs some 260,000 device operations
TRACE_STEPS = 1


def _process_age() -> float:
    """Seconds the process has lived (Linux), 0 where that is unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age() - (time.perf_counter() - _T0)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def sample(records, count, seed):
    """``count`` records drawn from the seed, the slowest among them (all
    where ``count`` is 0 or not less than their number)."""
    import numpy as np

    if not count or count >= len(records):
        return records
    slowest = max(range(len(records)), key=lambda i: records[i]["latency"])
    rest = [i for i in range(len(records)) if i != slowest]
    rng = np.random.default_rng([seed % (1 << 64), 7])
    pick = rng.choice(len(rest), size=count - 1, replace=False)
    return [records[slowest]] + [records[rest[i]] for i in sorted(pick)]


class Runner:
    """The cell's steps on one device: the traffic's phases in order
    (``phases/<phase>.py``), each timed as a span of its name."""

    def __init__(self, cell, seed, device, sync):
        from bench_port.lib import registry
        import incrementalinference_torch as it

        self.it = it
        self.cfg, self.traffic = cell["cfg"], cell["traffic"]
        self.seed, self.device, self.sync = seed, device, sync
        self.graph = registry.module("graphs", self.cfg["graph"])
        self.phases = [(name, registry.module("phases", name))
                       for name in self.traffic["phases"]]

    def step(self, k):
        state = {"step": k, "out": {}}
        spans = []
        t = time.perf_counter()
        for name, phase in self.phases:
            phase.run(self, state)
            self.sync()
            t1 = time.perf_counter()
            spans.append((name, t, t1))
            t = t1
        return {"step": k, "spans": spans,
                "latency": spans[-1][2] - spans[0][1], **state["out"]}


def read_trace(prof, host_mark, host_end, host_spans, steps, problems):
    """The profiled steps' device events on the host's clock (aligned by the
    marker kernel launched first), busy time, gaps and the breakdown."""
    from torch.autograd import DeviceType

    from bench_port.lib import trace as T

    events = [(ev.name, ev.time_range.start, ev.time_range.end)
              for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    marks = [e for e in events if "spin_kernel" in e[0]]
    if not marks:
        raise RuntimeError("the marker kernel is not in the device trace")
    offset = marks[0][1] - host_mark * 1e6
    events = [e for e in events if e is not marks[0]]
    lo, hi = marks[0][1], host_end * 1e6 + offset
    spans = [(s, e) for _, s, e in events]
    busy = T.device_busy_us([(max(s, lo), min(e, hi)) for s, e in spans
                             if e > lo and s < hi])
    named = [(n, s * 1e6 + offset, e * 1e6 + offset)
             for n, s, e in host_spans]
    return {"events": events, "busy_us": busy, "window_us": hi - lo,
            "steps": steps, "problems": problems,
            "breakdown": {"device_ops": T.top_ops(events),
                          "idle_gaps": T.top_gaps(T.idle_gaps(spans, lo, hi),
                                                  named)}}


def card_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(args):
    """The run as the benchmark's command makes it: on the card, or no
    result at all."""
    sys.path.insert(0, ROOT)
    # one process with one host thread for PyTorch's own CPU work: the
    # solve's host time is Python dispatch, and idle pool threads on a
    # shared host only add spread
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    from bench_port.lib import registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} seen; no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return execute(args, bench, cell, device)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def execute(args, bench, cell, device):
    """Set-up, window, checks and the result line on ``device``.  Only the
    tests call this with the CPU, to drive a run's pieces without a card."""
    import torch

    from bench_port.lib import registry

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    chips = cell["entry"]["chips"]
    runner = Runner(cell, args.seed, device, sync)

    # set-up: the warm-up step, whose spans are the process's first
    warm = {n: e - s for n, s, e in runner.step(0)["spans"]}
    sync()
    setup_s = _AGE0 + time.perf_counter() - _T0

    traffic = cell["traffic"]
    trace_steps = TRACE_STEPS if args.trace else 0
    prof = None
    records, attempted, failed = [], 0, 0
    host_spans, problems = [], 0
    w0 = time.perf_counter()
    deadline = w0 + args.seconds
    k = 1
    while time.perf_counter() < deadline:
        if k == 1 and trace_steps:
            from torch.profiler import ProfilerActivity, profile
            from incrementalinference_torch.ops.kernels import row_lse

            row_lse.reset_counts()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            host_mark = time.perf_counter()
            torch.cuda._sleep(1000)
        attempted += 1
        try:
            rec = runner.step(k)
            records.append(rec)
            if k <= trace_steps:
                host_spans += rec["spans"]
        except Exception:
            failed += 1
            traceback.print_exc()
        if prof is not None and k == trace_steps:
            sync()
            host_end = time.perf_counter()
            prof.__exit__(None, None, None)
            problems = row_lse.counts["problems"]
        k += 1
    window = time.perf_counter() - w0
    if prof is not None and k <= trace_steps:
        # the window closed before the profiled steps were done
        sync()
        host_end = time.perf_counter()
        prof.__exit__(None, None, None)
        problems = row_lse.counts["problems"]

    device_info = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(0) if on_card else device.type,
        "count": chips,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else 0)}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    ctx = {"cfg": cell["cfg"], "traffic": traffic, "trace": None,
           "setup_s": setup_s, "window_s": window,
           "latencies": [r["latency"] for r in records],
           "warm": warm, "spans": {}}
    profiled = [r for r in records if r["step"] <= trace_steps]
    timed = [r for r in records if r["step"] > trace_steps] or records
    for name in traffic["phases"]:
        ctx["spans"][name] = [e - s for r in timed
                              for n, s, e in r["spans"] if n == name]
    if prof is not None:
        ctx["trace"] = read_trace(prof, host_mark, host_end, host_spans,
                                  len(profiled), problems)
        del prof
        device_info["busy_s"] = ctx["trace"]["busy_us"] / 1e6
        device_info["window_s"] = ctx["trace"]["window_us"] / 1e6

    metrics = {}
    section = "per_layer" if args.trace else "end_to_end"
    for m in registry.metrics_for(bench, section, args.workload):
        v = registry.module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the checks, once the window has closed and the peak has been read
    if on_card:
        torch.cuda.empty_cache()
    numbers, diagnostics = {}, {}
    c0 = time.perf_counter()
    for name, count in traffic["checks"].items():
        mod = registry.module("checks", name)
        got, diag = mod.judge(sample(records, count, args.seed), ctx,
                              "program")
        numbers.update(got)
        diagnostics.update(diag)
    # a number the cell gives no limit is printed, not compared: its
    # control did not separate from the program there
    limits = cell["limits"]
    checks = {n: {"value": _finite(numbers.get(n)), "limit": lim}
              for n, lim in limits.items()}
    diagnostics.update({n: v for n, v in numbers.items() if n not in limits})
    result["correct"] = bool(records) and not failed and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result["metrics"] = metrics
    result["device"] = device_info
    if ctx["trace"] is not None:
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"bench_port: modules loaded that no run may load: {found}; "
              "no result", file=sys.stderr)
        return 3
    lat = [r["latency"] for r in records]
    quart = statistics.quantiles(lat, n=4) if len(lat) >= 2 else lat
    print(f"card: {card_limit() if on_card else 'none'}; steps "
          f"{len(records)} in {window:.3f} s, latency quartiles "
          f"{[round(q, 4) for q in quart]}, first and last "
          f"{[round(x, 4) for x in lat[:1] + lat[-1:]]}; checks "
          f"{time.perf_counter() - c0:.3f} s", file=sys.stderr)
    if ctx["trace"] is not None:
        print(f"trace: {ctx['trace']['steps']} steps profiled, "
              f"{ctx['trace']['problems']} pair problems", file=sys.stderr)
    for n, v in sorted(diagnostics.items()):
        print(f"diagnostic {n} {v!r} (no limit)", file=sys.stderr)
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None):
    return run(parse(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())

"""The share of the profiled steps' ``batched_gauss_newton`` calls (``ops/
convolve.py``) that replayed a captured CUDA graph: the port's counters
``conv_graph_replays`` over it and ``conv_graph_captures`` and
``conv_eager_solves``, each call counted in one of the three."""

from bench_port.lib import program_trace

COUNTERS = ("conv_graph_replays", "conv_graph_captures", "conv_eager_solves")


def read(ctx):
    pt = program_trace.get(ctx)
    if pt is None:
        return None
    calls = sum(pt.counters.get(c, 0) for c in COUNTERS)
    if not calls:
        return None
    return 100.0 * pt.counters.get("conv_graph_replays", 0) / calls

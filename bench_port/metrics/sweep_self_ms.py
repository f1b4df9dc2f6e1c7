"""Milliseconds a step inside the port's ``solve_tree`` spans that no
``graphinit``, ``tree``, ``convolve``, ``product`` or ``bandwidth`` span
covers: the sweeps' own host time (``parallel/scheduler.py``: clique
subgraphs, plans, the Gibbs schedule; ``parallel/messages.py``)."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if pt is None or not pt.union_of("solve_tree"):
        return None
    return pt.self_ms_per_step("solve_tree", program_trace.LEAVES)

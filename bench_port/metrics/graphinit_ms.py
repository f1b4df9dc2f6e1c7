"""Milliseconds a step inside the port's ``graphinit`` spans
(``graphinit.doautoinit`` wherever it runs, the graph build's included, and
``init_all`` in ``solve_tree``); the program's own spans over the profiled
steps."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.ms_per_step("graphinit")

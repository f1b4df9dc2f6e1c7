"""Milliseconds a step inside the port's ``bandwidth`` spans
(``beliefs.loo_bandwidth``, the leave-one-out bandwidth selection); the
program's own spans over the profiled steps."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.ms_per_step("bandwidth")

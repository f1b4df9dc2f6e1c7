"""Milliseconds a step inside the port's ``convolve`` spans
(``ops/convolve.py`` ``eval_factor_core_batched``: one factor's proposals,
its Levenberg-Marquardt loop included), in the build's graphinit and in the
solve alike; the program's own spans over the profiled steps."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.ms_per_step("convolve")

"""Device operations a step whose start, on the host's clock, falls inside
one of the port's ``convolve`` spans (or a span within one)."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.ops_per_step("convolve")

"""The share of the time of the port's ``convolve`` spans in which no
device operation ran (device events put on the host's clock by the
program's marker)."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.idle_pct("convolve")

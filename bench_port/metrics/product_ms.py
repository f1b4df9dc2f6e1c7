"""Milliseconds a step inside the port's ``product`` spans
(``ops/product.py`` ``manifold_product`` and the fused update's product in
``ops/fused.py``: the pair cascade, the row-logsumexp kernel and the column
draw); the program's own spans over the profiled steps."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.ms_per_step("product")

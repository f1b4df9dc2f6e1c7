"""Jacobian passes a step (``vmap(jacrev)`` over the particles, one an LM
iteration or closed-form step of ``ops/convolve.py``
``batched_gauss_newton``): the port's ``jacobian_passes`` counter over the
profiled steps."""

from bench_port.lib import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    if pt is None:
        return None
    return pt.counters.get("jacobian_passes", 0) / pt.steps

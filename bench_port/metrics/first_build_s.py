"""Seconds of the process's first graph build: the warm-up step's
``build`` span, in the set-up."""


def read(ctx):
    return ctx["warm"].get("build")

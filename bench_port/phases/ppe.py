"""Reads every variable's estimates with ``set_ppe``, as a user does
after a solve.  Leaves the estimates."""


def run(runner, state):
    fg = state["fg"]
    state["out"]["ppe"] = {lbl: runner.it.set_ppe(fg, lbl)
                           for lbl in state["out"]["meas"]["labels"]}

"""Solves the graph with ``solve_tree`` and the traffic's ``algorithm``.
Leaves each variable's belief (points, bandwidth) and whether the solve
replaced it."""


def run(runner, state):
    fg = state["fg"]
    runner.it.solve_tree(fg, algorithm=runner.traffic["algorithm"])
    beliefs, replaced = {}, {}
    for lbl, v in fg.variables.items():
        b = v.beliefs.get("default")
        beliefs[lbl] = None if b is None else (b.points, b.bw)
        replaced[lbl] = b is not None and b is not state["before"].get(lbl)
    state["out"]["beliefs"], state["out"]["replaced"] = beliefs, replaced

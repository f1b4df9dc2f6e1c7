"""Builds the cell's graph from measurements drawn from the seed and the
step's index, through the port's API (``graphs/<graph>.py``).  Leaves the
graph, the beliefs it starts from and a copy of their particles."""


def run(runner, state):
    fg, meas = runner.graph.build(runner.cfg, runner.seed, state["step"],
                                  runner.device, runner.traffic["graphinit"])
    before = {lbl: v.beliefs.get("default") for lbl, v in
              fg.variables.items()}
    state["fg"], state["before"] = fg, before
    state["out"]["meas"] = meas
    state["out"]["init"] = {lbl: None if b is None else b.points.clone()
                            for lbl, b in before.items()}

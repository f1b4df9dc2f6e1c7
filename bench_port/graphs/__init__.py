"""Graph makers, one file per configuration's ``graph``: each has
``build(cfg, seed, step, device, graphinit) -> (graph, measurements)``."""

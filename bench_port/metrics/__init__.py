"""Metric readers, one file each, end-to-end and per-layer alike:
``read(ctx)`` returns the metric's value, or None where the run gave it
nothing to read (the metric is then left out of the line).  ``ctx`` holds
the cell (``cfg``, ``traffic``), the host clock's readings (``setup_s``,
``window_s``, every step's ``latencies``), the harness's spans (``warm``:
the warm-up step's seconds in each phase; ``spans``: each phase's seconds
in every timed step, by the phase's name) and, in a traced run, the device
trace (``trace``)."""

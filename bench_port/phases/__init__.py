"""The phases of a step, one file each, named in a traffic mix's
``phases``.  ``run(runner, state)`` does the phase's work on
``state`` (the step's index ``step``; what earlier phases left) and puts
what the checks read under ``state["out"]``; the harness times each phase
as a span of its name, ending in a synchronize."""

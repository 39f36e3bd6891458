"""Host time of `_run_call`: the host enqueuing a call's micro-steps (with
the profiler's cost per torch op), per traced `process()` call: the
program's span `engine.launch` over the traced slice."""
from flowbench.metrics._spans import per_call


def read(reading):
    return per_call(reading, "engine.launch")

"""Host time of `_run_call`: the host enqueuing a call's micro-steps (with
the profiler's cost per torch op), per 1,048,576 traced events: the
program's span `engine.launch` over the traced slice."""
from flowbench.metrics._spans import per_mevent


def read(reading):
    return per_mevent(reading, "engine.launch")

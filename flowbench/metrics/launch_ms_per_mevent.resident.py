"""Host time of `fn()`'s launches, per 1,048,576 replayed events of the
traced replays: the program's span `engine.launch` (`_run_call`, the
host enqueuing every micro-step of the stream; with the profiler's cost
per torch op, which the untraced replays do not pay)."""
from flowbench.metrics._spans import per_mevent


def read(reading):
    return per_mevent(reading, "engine.launch")

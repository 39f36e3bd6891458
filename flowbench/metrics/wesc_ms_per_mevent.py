"""Host time of `pack_wesc`: the equal-stamp write escapes, a Python loop
over calls, steps and phases, per 1,048,576 traced events: the program's
span `engine.pack_wesc` over the traced slice."""
from flowbench.metrics._spans import per_mevent


def read(reading):
    return per_mevent(reading, "engine.pack_wesc")

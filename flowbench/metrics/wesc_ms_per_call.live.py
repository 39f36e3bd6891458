"""Host time of `pack_wesc`: the equal-stamp write escapes, a Python loop
over calls, steps and phases, per traced `process()` call: the program's
span `engine.pack_wesc` over the traced slice."""
from flowbench.metrics._spans import per_call


def read(reading):
    return per_call(reading, "engine.pack_wesc")

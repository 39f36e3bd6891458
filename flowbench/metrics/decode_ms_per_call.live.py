"""Host time of `_unpack_outputs`: the wire decoded into the output
columns, per traced `process()` call: the program's span `engine.decode`
over the traced slice."""
from flowbench.metrics._spans import per_call


def read(reading):
    return per_call(reading, "engine.decode")

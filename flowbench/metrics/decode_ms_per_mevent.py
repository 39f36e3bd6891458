"""Host time of `_unpack_outputs`: the wire decoded into the output
columns, per 1,048,576 traced events: the program's span `engine.decode`
over the traced slice."""
from flowbench.metrics._spans import per_mevent


def read(reading):
    return per_mevent(reading, "engine.decode")

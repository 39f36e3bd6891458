"""Host time of `pack_r2`: the rank-2 lanes and center surfaces of the
correction pass, per traced `process()` call: the program's span
`engine.pack_r2` over the traced slice."""
from flowbench.metrics._spans import per_call


def read(reading):
    return per_call(reading, "engine.pack_r2")

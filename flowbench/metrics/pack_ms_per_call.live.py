"""Host time of `pack2`: the native compact pack, the winners and the
delta-coded words, per traced `process()` call: the program's span
`engine.pack` over the traced slice."""
from flowbench.metrics._spans import per_call


def read(reading):
    return per_call(reading, "engine.pack")

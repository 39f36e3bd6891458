"""Host time of `pack2`: the native compact pack, the winners and the
delta-coded words, per 1,048,576 traced events: the program's span
`engine.pack` over the traced slice."""
from flowbench.metrics._spans import per_mevent


def read(reading):
    return per_mevent(reading, "engine.pack")

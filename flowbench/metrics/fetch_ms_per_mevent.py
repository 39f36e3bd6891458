"""Host time of the wire's device-to-host copies, the wait for the call's
device work included, per 1,048,576 traced events: the program's span
`engine.fetch` over the traced slice."""
from flowbench.metrics._spans import per_mevent


def read(reading):
    return per_mevent(reading, "engine.fetch")

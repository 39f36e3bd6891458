"""Host time of the wire's device-to-host copies, the wait for the call's
device work included, per traced `process()` call: the program's span
`engine.fetch` over the traced slice."""
from flowbench.metrics._spans import per_call


def read(reading):
    return per_call(reading, "engine.fetch")

"""Share of the traced slice's calls whose write escapes overflowed, so
that they took the epoch scatter on the device: the program's counters
`engine.epoch_calls` over `engine.calls`."""
from flowbench.metrics._spans import epoch_call_pct


def read(reading):
    return epoch_call_pct(reading)

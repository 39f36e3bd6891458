"""Share of the traced window in which nothing ran on the device (rank
0's card): kernels, copies and sets, overlapping ones counted once."""
from flowbench.metrics._common import idle_pct


def read(reading):
    return idle_pct(reading)

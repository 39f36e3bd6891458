"""Rank 0's device time in NCCL kernels (halo exchange, band integral,
lane reduce-scatter and gather, their waits included) per traced
`process()` call."""
from flowbench.metrics._common import kernel_time


def read(reading):
    t = reading["trace"]
    n, secs = kernel_time(reading, ("nccl", "Nccl", "NCCL"))
    if not t or not n or not t["calls"]:
        return None
    return secs / t["calls"] * 1e3

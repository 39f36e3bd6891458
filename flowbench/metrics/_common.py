"""Arithmetic the per-layer readers share."""
from __future__ import annotations


def idle_pct(reading: dict):
    """100 x (1 - the device's busy time over the traced window)."""
    t = reading["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def traced_steps(reading: dict) -> int:
    """The micro-steps of the traced calls, from the events each call
    was given and the configuration's chunk: the work the slice did,
    however the program launches it."""
    m = int(reading["flow"]["chunk_size"])
    return sum(-(-c["events"] // m) for c in reading["calls"]
               if c["traced"])


def kernel_time(reading: dict, parts: tuple) -> tuple:
    """(launches, seconds) of the traced kernels whose name holds one of
    `parts`."""
    t = reading["trace"]
    n, s = 0, 0.0
    for name, (count, secs) in (t["kernels"] if t else {}).items():
        if any(p in name for p in parts):
            n += count
            s += secs
    return n, s

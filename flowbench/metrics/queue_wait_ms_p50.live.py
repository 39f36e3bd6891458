"""Median over the window's calls of how long a call waited past its due
time before `process()` took it (the open-loop schedule's queue); the
calls of the traced slice, which the profiler slows, are left out."""
from flowbench.harness import percentile


def read(reading):
    waits = [(c["start"] - c["due"]) * 1e3 for c in reading["calls"]
             if c["due"] is not None and not c["traced"]]
    return percentile(waits, 50) if waits else None

"""Median over the window's calls of the wall time of one `process()`
call (the benchmark's span around it); the calls of the traced slice,
which the profiler slows, are left out."""
from flowbench.harness import percentile


def read(reading):
    spans = [(c["end"] - c["start"]) * 1e3 for c in reading["calls"]
             if c["due"] is not None and not c["traced"]]
    return percentile(spans, 50) if spans else None

"""Host time of one plane-fit launch in a k = 7 cell, in microseconds:
the program's span `kernels.local_flow` (ops/kernels.local_flow's card
path: the checks, the outputs' allocations and the launch) over its
count in the traced slice, given only where the program counted general
launches there (`kernels.local_flow_general_launches`); with the
profiler's cost per torch op, which untraced calls do not pay."""
from flowbench.metrics._spans import totals, traced


def read(reading):
    t = totals()
    if (t is None or not traced(reading)[0] or not t["counters"].get(
            "kernels.local_flow_general_launches")):
        return None
    count, secs = t["spans"].get("kernels.local_flow", (0, 0.0))
    return secs / count * 1e6 if count else None

"""The plane fits' share of their roofline in a fidelity cell:
local_flow_roofline_pct's reading (roofline.local_flow_step, which counts
each phase's fit over its snapshot chain and the correction pass over
the chunk's chain, times the traced micro-steps, over the device time of
the kernels it names), given only where the program counted
correction-mode launches in the traced slice
(`kernels.local_flow_correction_launches`), so that the correction
pass's share is never read from a run that did not run it."""
from flowbench.metrics import local_flow_roofline_pct
from flowbench.metrics._spans import totals


def read(reading):
    t = totals()
    if t is None or not t["counters"].get(
            "kernels.local_flow_correction_launches"):
        return None
    return local_flow_roofline_pct.read(reading)

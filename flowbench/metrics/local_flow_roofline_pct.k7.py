"""The general plane-fit kernel's share of its roofline in a k = 7 cell:
local_flow_roofline_pct's reading (roofline.local_flow_step times the
traced micro-steps, over the device time of the kernels it names), given
only where the program counted general launches in the traced slice
(`kernels.local_flow_general_launches`), so that it never times another
kernel in the general kernel's name."""
from flowbench.metrics import local_flow_roofline_pct
from flowbench.metrics._spans import totals


def read(reading):
    t = totals()
    if t is None or not t["counters"].get(
            "kernels.local_flow_general_launches"):
        return None
    return local_flow_roofline_pct.read(reading)

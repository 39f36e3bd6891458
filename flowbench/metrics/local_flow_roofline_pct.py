"""The plane fit's share of its roofline: the least time for the traced
micro-steps' plane fits (roofline.local_flow_step, from the
configuration's shapes, times the micro-steps of the traced calls) over
the device time of the kernels named here."""
from flowbench import roofline
from flowbench.metrics._common import kernel_time, traced_steps

KERNELS = ("local_flow_streamed", "local_flow_general")


def read(reading):
    _, secs = kernel_time(reading, KERNELS)
    steps = traced_steps(reading)
    if not steps or secs <= 0:
        return None
    return 100.0 * roofline.local_flow_step(reading["flow"]) * steps / secs

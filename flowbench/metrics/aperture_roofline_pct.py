"""The aperture pass's share of its roofline: the least time for the
traced micro-steps' passes (roofline.aperture_step, from the
configuration's shapes, times the micro-steps of the traced calls) over
the device time of the float64 integral and the pool, whatever kernels
implement them (named here)."""
from flowbench import roofline
from flowbench.metrics._common import kernel_time, traced_steps

KERNELS = ("aperture_kernel", "integral_kernel")


def read(reading):
    _, secs = kernel_time(reading, KERNELS)
    steps = traced_steps(reading)
    if not steps or secs <= 0:
        return None
    return 100.0 * roofline.aperture_step(reading["flow"]) * steps / secs

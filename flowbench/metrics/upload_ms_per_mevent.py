"""Host time of the host-to-device copies of each call's batch, per
1,048,576 traced events: the program's span `engine.upload` over the
traced slice."""
from flowbench.metrics._spans import per_mevent


def read(reading):
    return per_mevent(reading, "engine.upload")

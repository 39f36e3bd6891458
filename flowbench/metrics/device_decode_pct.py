"""Share of the traced slice's decoded lanes that the program decoded on
the card (its decode_wire kernel) rather than on the host: the program's
counters `engine.device_decoded_lanes` over `engine.decoded_lanes`."""
from flowbench.metrics._decode import device_decode_pct


def read(reading):
    return device_decode_pct(reading)

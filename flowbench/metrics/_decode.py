"""What the decode-share readers share: the program's lane counters
(`engine.decoded_lanes`, every lane decoded into output columns, and
`engine.device_decoded_lanes`, those its decode_wire kernel decoded on
the card), kept while the traced slice's profiler records.
"""
from __future__ import annotations

from flowbench.metrics._spans import totals, traced


def device_decode_pct(reading: dict) -> float | None:
    """100 x the lanes decoded on the card over every lane decoded, or
    None where the program counts no decoded lane (a program without the
    counters, a multi-rank run) or no call was traced."""
    t = totals()
    lanes = t["counters"].get("engine.decoded_lanes", 0) if t else 0
    if not lanes or not traced(reading)[0]:
        return None
    return 100.0 * t["counters"].get("engine.device_decoded_lanes",
                                     0) / lanes

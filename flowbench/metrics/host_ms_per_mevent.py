"""Host time of `process()` per 1,048,576 events: the traced calls' wall
time less the device's busy time inside them (pack, upload, download,
decode and launches: all of `process()` the card does not overlap)."""
from flowbench.harness import MEBI


def read(reading):
    t = reading["trace"]
    if not t or reading["traffic"]["driver"] not in ("replay", "live"):
        return None
    traced = [c["events"] for c in reading["calls"] if c["traced"]]
    if not traced or not t["calls"]:
        return None
    events = t["calls"] * sum(traced) / len(traced)
    return (t["call_s"] - t["busy_in_calls_s"]) / events * MEBI * 1e3

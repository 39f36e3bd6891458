"""What the stage metrics share: the program's own span totals and
counters (`farms_tpu_torch.utils.tracing`), which it keeps while the
traced slice's profiler records, over the traced calls' events or count
(`reading["calls"]`).

Each helper gives None where the program keeps no totals: a program
without the module, a run whose totals are empty, or a multi-rank run,
whose ranks keep theirs in processes of their own.
"""
from __future__ import annotations

from flowbench.harness import MEBI


def totals() -> dict | None:
    """The program's totals in this process, or None."""
    try:
        from farms_tpu_torch.utils import tracing
    except ImportError:
        return None
    t = tracing.totals()
    return t if t["spans"] or t["counters"] else None


def traced(reading: dict) -> tuple:
    """(calls, events) of the traced slice."""
    calls = [c for c in reading["calls"] if c["traced"]]
    return len(calls), sum(c["events"] for c in calls)


def span_s(reading: dict, name: str) -> float | None:
    """Seconds in span `name` over the traced slice, or None."""
    t = totals()
    if t is None or name not in t["spans"]:
        return None
    return t["spans"][name][1]


def per_mevent(reading: dict, name: str) -> float | None:
    """Milliseconds in span `name` per 1,048,576 traced events."""
    secs = span_s(reading, name)
    events = traced(reading)[1]
    if secs is None or not events:
        return None
    return secs / events * MEBI * 1e3


def per_call(reading: dict, name: str) -> float | None:
    """Milliseconds in span `name` per traced call."""
    secs = span_s(reading, name)
    calls = traced(reading)[0]
    if secs is None or not calls:
        return None
    return secs / calls * 1e3


def epoch_call_pct(reading: dict) -> float | None:
    """100 x the calls that took the epoch scatter over every call the
    engine made (counters `engine.epoch_calls`, `engine.calls`)."""
    t = totals()
    calls = t["counters"].get("engine.calls", 0) if t else 0
    if not calls or not traced(reading)[0]:
        return None
    return 100.0 * t["counters"].get("engine.epoch_calls", 0) / calls

"""Share of the traced replays that replayed a captured CUDA graph: 100 x
the program's counter `engine.graph_replays` over `engine.resident_calls`
(every fn() of process_resident), kept while the traced slice's profiler
records; None where the program counts no resident call."""
from flowbench.metrics._spans import totals, traced


def read(reading):
    t = totals()
    calls = t["counters"].get("engine.resident_calls", 0) if t else 0
    if not calls or not traced(reading)[0]:
        return None
    return 100.0 * t["counters"].get("engine.graph_replays", 0) / calls

"""Stage spans and counters of the engines, on while a torch profiler records.

The engines open a span around each host stage of a call (packing, the
upload, the launches, the download, the decode) and count the calls and
the paths they take. Nothing happens unless a torch profiler is recording
in this process: then each span is also a profiler range named
`farms_tpu_torch.<name>`, so the trace names the stage the host was in at
any moment, and its host-clock duration adds to an in-memory total.
Without a profiler a span site costs one check of the profiler's flag and
returns a shared null context. Nothing is written to disk.

An operator who wants the split of a run wraps it in a profiler and reads
the totals afterwards::

    from farms_tpu_torch.utils import tracing
    tracing.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        engine.process(events)
    tracing.totals()
    # {"spans": {"engine.pack": [1, 0.012], ...},
    #  "counters": {"engine.calls": 8, ...}}

The counters the engines and kernel wrappers keep: `engine.calls` and
`engine.epoch_calls` (FlowEngine.device_calls: every call, and the dense
calls, whose step finds each phase's written pixels by the epoch
scatter), `engine.decoded_lanes` (every lane
decoded into output columns, on the host or on the card),
`engine.device_decoded_lanes` (the lanes the decode_wire kernel decoded),
`engine.resident_calls` and `engine.graph_replays` (every fn() of
FlowEngine.process_resident, and those that replayed a captured CUDA
graph), `kernels.local_flow_general_launches` (ops/kernels.local_flow:
the launches of the general plane-fit kernel, k >= 7) and
`kernels.local_flow_correction_launches` (its launches of either kernel
in correction mode: the rank-2 center correction's pass); a graph replay
adds the launches it holds. Besides the engines' stage spans,
ops/kernels.local_flow opens `kernels.local_flow` around its card path's
host work (checks, allocations, the launch), which a graph replay does
not repeat.

The totals are per process: the ranks of a sharded engine each keep
their own. `reset()` clears them between profiler sessions.
"""
from __future__ import annotations

import contextlib
import time

from torch.autograd import profiler as _profiler

PREFIX = "farms_tpu_torch."

# name -> [count, seconds]; name -> count
_spans: dict = {}
_counters: dict = {}
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name
        self.range = _profiler.record_function(PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        secs = time.perf_counter() - self.start
        self.range.__exit__(*exc)
        total = _spans.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += secs
        return False


def span(name: str):
    """A context manager that times a stage while a profiler records
    (a profiler range and a host-clock total), and does nothing else."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def totals() -> dict:
    """{"spans": {name: [count, seconds]}, "counters": {name: count}}
    since the last reset (copies)."""
    return {"spans": {k: list(v) for k, v in _spans.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Clear every span total and counter."""
    _spans.clear()
    _counters.clear()

"""Open-loop live stream through `FlowEngine.process`.

The pool is made at the mix's `rate`, so sensor time is wall time: an
event is due when its stamp, counted from the window's first event, has
passed since the window opened. The stream goes to `process()` in calls
of `call_events`; a call is due when its last event is due, is handed
over then, or at once when the engine is still busy with an earlier one,
and the schedule never slows for it. A call's latency is its return
minus its due time, so a stall shows in every later call. The window
holds the calls due in its `seconds`; each is completed. A traced run
traces the window's last `trace_calls` calls, so the calls before them,
which the per-layer span metrics read, run as in an untraced run.

Checked against the reference: the run's first call (from the initial
state), `check_calls` window calls drawn from the seed in [0,
`check_within`), and the window's last call, each with the whole-sensor
state before and after it.
"""
from __future__ import annotations

import time

from flowbench import harness


def run(cell, seed: int, seconds: float, trace: bool, device_type: str):
    import torch
    from farms_tpu_torch.events.io import EventBatch
    from flowbench.trace import Profile, summarize

    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    tr = cell.traffic
    C = int(tr["call_events"])
    marks = [("imports", time.perf_counter())]
    pool = harness.make_pool(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("events", time.perf_counter()))
    engine = harness.make_engine(cell, dev)
    marks.append(("engine", time.perf_counter()))
    samples = []
    pos = 0
    for w in range(int(tr["warmup_calls"])):
        ev = EventBatch(*pool.take(pos, C))
        pos += C
        out = engine.process(ev)
        if w == 0:
            samples.append([ev, None, out, engine.whole_state()])
    checks = set(harness.sample_indices(seed, int(tr["check_within"]),
                                        int(tr["check_calls"])))
    trace_n = int(tr["trace_calls"]) if trace else 0
    prof = Profile() if trace_n else None
    spans = harness.Spans("process()")
    first = pool.stamp(pos)
    # the calls due in the window, known before it opens; the traced
    # slice is the last `trace_calls` of them
    n_calls = 0
    while pool.stamp(pos + (n_calls + 1) * C - 1) - first <= seconds * 1e6:
        n_calls += 1
    harness.settle()
    opened = time.perf_counter()
    last = None
    for j in range(n_calls):
        due = opened + (pool.stamp(pos + C - 1) - first) * 1e-6
        ev = EventBatch(*pool.take(pos, C))
        pos += C
        traced = prof is not None and j >= n_calls - trace_n
        if traced:
            prof.start()
        prev = engine.whole_state()
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        out = spans.call(lambda: engine.process(ev), C, due=due,
                         annotate=traced)
        if j in checks:
            samples.append([ev, prev, out, engine.whole_state()])
        else:
            last = (ev, prev, out)
    if last is not None:
        samples.append([*last, engine.whole_state()])
    lat = [(c["end"] - c["due"]) * 1e3 for c in spans.calls]
    slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:5]
    note = "slowest calls (index, call ms, latency ms): " + ", ".join(
        f"({i}, {(spans.calls[i]['end'] - spans.calls[i]['start']) * 1e3:.1f}"
        f", {lat[i]:.1f})" for i in sorted(slow))
    return {
        "note": note,
        "setup_end": opened,
        "e2e": {"latency_p50_ms": harness.percentile(lat, 50)},
        "setup_marks": marks + [("warm-up", opened)],
        "attempted": len(spans.calls), "failed": 0,
        "calls": spans.calls,
        "trace": summarize(prof) if prof is not None else None,
        "samples": [harness.sample_record(*s) for s in samples],
        "t0": int(pool.take(0, 1)[2][0]),
        "peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda
        else 0,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
    }

"""Device-resident replay through `FlowEngine.process_resident`.

The mix's `stream_events` are uploaded once as one call of the explicit
5-row layout; `fn()` then runs every micro-step of the stream with the
flow left in device memory. The window replays `fn()` back to back, each
replay from the engine's start state (a step never changes a state in
place, so restoring it is one assignment) and synchronised at its end.
`resident_events_per_s` is the events of the replays completed inside
the window over its seconds.

Checked against the reference: the window's last replay, all of its
lanes decoded from the wire blocks it left on the card, and the state
after it, from the initial state.
"""
from __future__ import annotations

import time

from flowbench import harness


def run(cell, seed: int, seconds: float, trace: bool, device_type: str):
    import torch
    from farms_tpu_torch.events.io import EventBatch
    from flowbench.reference.dense import Semantics, decode_wire
    from flowbench.trace import Profile, summarize

    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    tr = cell.traffic
    n = int(tr["stream_events"])
    marks = [("imports", time.perf_counter())]
    pool = harness.make_pool(cell, seed, dev, n_events=n)
    ev = EventBatch(*pool.take(0, n))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("events", time.perf_counter()))
    engine = harness.make_engine(cell, dev)
    marks.append(("engine", time.perf_counter()))
    fn, n = engine.process_resident(ev)
    start_state = engine.state

    def replay():
        engine.state = start_state
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        return out

    for _ in range(int(tr["warmup_replays"])):
        replay()
    trace_n = int(tr["trace_replays"]) if trace else 0
    prof = Profile() if trace_n else None
    spans = harness.Spans("fn()")
    harness.settle()
    opened = time.perf_counter()
    close = opened + seconds
    out = None
    j = 0
    while time.perf_counter() < close:
        traced = prof is not None and 1 <= j <= trace_n
        if traced:
            prof.start()
        out = spans.call(replay, n, annotate=traced)
        if prof is not None and j == trace_n:
            prof.stop()
        j += 1
    elapsed = spans.calls[-1]["end"] - opened
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    main, aux = (a.cpu().numpy() for a in out)
    C = main.shape[1]
    cols = decode_wire(main.transpose(1, 0, 2).reshape(C, -1)[:, :n],
                       aux.reshape(-1)[:n], Semantics.from_dict(cell.flow))
    sample = harness.sample_record(ev, None, cols, engine.whole_state())
    return {
        "setup_end": opened,
        "e2e": {"resident_events_per_s": len(spans.calls) * n / elapsed},
        "setup_marks": marks + [("warm-up", opened)],
        "attempted": len(spans.calls), "failed": 0,
        "calls": spans.calls,
        "trace": summarize(prof) if prof is not None else None,
        "samples": [sample],
        "t0": int(ev.t[0]),
        "peak_bytes": peak,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
    }

"""Closed-loop replay through `FlowEngine.process` (or a sharded engine's).

A recorded stream is replayed from the pool in batches of the mix's
`batch_events`; the next batch is handed over when the last returns.
`events_per_s` is every event whose flow `process()` returned inside the
window over the window's seconds. On several ranks every rank is given
the same stream (the engine's contract), rank 0 decides between batches
whether the window goes on and broadcasts it, and its count is the
result.

A traced run traces the same batches on every rank: the per-layer
metrics read rank 0's trace, the device's busy time and window are the
ranks' mean.

Once the window has closed, every rank looks in its own `sys.modules`
for the modules the benchmark must not load (the ranks are processes of
their own); rank 0 returns what any rank found, and the run then fails.

Checked against the reference: the first call of the run (from the
initial state), `check_batches` window batches drawn from the seed in
[0, `check_within`), and on one rank the window's last batch, each with
the whole-sensor state before and after it.
"""
from __future__ import annotations

import time

from flowbench import harness


def run(cell, seed: int, seconds: float, trace: bool, device_type: str):
    world = int(cell.config.get("devices", 1))
    if world > 1:
        from farms_tpu_torch.parallel import mesh
        return mesh.run(_rank, world, device_type, cell, seed, seconds,
                        trace, device_type)
    return _rank(cell, seed, seconds, trace, device_type)


def _rank(cell, seed, seconds, trace, device_type):
    import torch
    import torch.distributed as dist
    from farms_tpu_torch.events.io import EventBatch
    from farms_tpu_torch.parallel import mesh
    from flowbench.trace import Profile, summarize

    rank, world = mesh.rank_and_size()
    cuda = device_type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    tr = cell.traffic
    B = int(tr["batch_events"])
    marks = [("imports", time.perf_counter())]
    pool = harness.make_pool(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("events", time.perf_counter()))
    engine = harness.make_engine(cell, dev)
    marks.append(("engine", time.perf_counter()))
    pos = 0

    def batch():
        nonlocal pos
        ev = EventBatch(*pool.take(pos, B))
        pos += B
        return ev

    samples = []
    for w in range(int(tr["warmup_batches"])):
        ev = batch()
        out = engine.process(ev)
        if w == 0:
            samples.append([ev, None, out, engine.whole_state()])
    checks = set(harness.sample_indices(seed, int(tr["check_within"]),
                                        int(tr["check_batches"])))
    trace_n = int(tr["trace_batches"]) if trace else 0
    prof = Profile() if trace_n else None
    harness.settle()
    if world > 1:
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        mesh.barrier()
    spans = harness.Spans("process()")
    start = time.perf_counter()
    end = start + seconds
    last = None
    j = 0
    while True:
        go = time.perf_counter() < end
        if world > 1:
            flag.fill_(int(go))
            dist.broadcast(flag, src=0)
            go = bool(flag.item())
        if not go:
            break
        ev = batch()
        traced = prof is not None and 1 <= j <= trace_n
        if traced:
            prof.start()
        prev = engine.whole_state() if (j in checks or world == 1) else None
        out = spans.call(lambda: engine.process(ev), B, annotate=traced)
        if prof is not None and j == trace_n:
            prof.stop()
        if j in checks:
            samples.append([ev, prev, out, engine.whole_state()])
        else:
            last = (ev, prev, out)
        j += 1
    if world == 1 and last is not None:
        samples.append([*last, engine.whole_state()])
    elapsed = spans.calls[-1]["end"] - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = summarize(prof) if prof is not None else None
    if world > 1:
        peaks = torch.tensor([peak], dtype=torch.int64, device=dev)
        dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
        peak = int(peaks.item())
        if prof is not None:
            # the device's busy time and traced window, averaged over the
            # cards (each rank traces the same calls)
            bw = torch.tensor([summary["busy_s"], summary["window_s"]]
                              if summary else [0.0, 0.0],
                              dtype=torch.float64, device=dev)
            dist.all_reduce(bw)
            if summary:
                summary["device_busy_s"] = float(bw[0]) / world
                summary["device_window_s"] = float(bw[1]) / world
    found = _forbidden_in_ranks(rank, world, dev) if world > 1 else []
    if rank:
        return None
    events = sum(c["events"] for c in spans.calls)
    return {
        "setup_end": start,
        "e2e": {"events_per_s": events / elapsed},
        "setup_marks": marks + [("warm-up", start)],
        "attempted": len(spans.calls), "failed": 0,
        "calls": spans.calls,
        "trace": summary,
        "samples": [harness.sample_record(*s) for s in samples],
        "t0": int(pool.take(0, 1)[2][0]),
        "peak_bytes": int(peak),
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": world,
        "forbidden": found,
    }


def _forbidden_in_ranks(rank: int, world: int, dev) -> list:
    """What each rank found of run.FORBIDDEN in its own process, as
    `rank r: name`, on every rank."""
    import torch
    import torch.distributed as dist
    from flowbench import run as bench_run
    flags = torch.zeros(world, len(bench_run.FORBIDDEN), dtype=torch.int32,
                        device=dev)
    mine = set(bench_run.forbidden_modules())
    for i, name in enumerate(bench_run.FORBIDDEN):
        flags[rank, i] = int(name in mine)
    dist.all_reduce(flags)
    return [f"rank {r}: {name}" for r in range(world)
            for i, name in enumerate(bench_run.FORBIDDEN) if flags[r, i]]

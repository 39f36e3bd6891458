"""Streaming ingestion: chunked iteration over unbounded event sources.

Counterpart of `farms_tpu.events.stream`. The reference's streaming mode
(`run()`, vFlow.cpp:465-826) reads one text line per event; here an
iterator of `EventBatch` chunks (from a file, an array, or any generator of
struct-of-arrays blocks) feeds the engine, whose state carries across
chunks. A producer thread pulls the source ahead of the engine; it touches
only NumPy, and the engine runs in the consumer's thread.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Iterable, Iterator

import numpy as np

from farms_tpu_torch.events.io import EventBatch, FlowOutput, load_events_txt


def iter_file_chunks(path: str, chunk_events: int,
                     max_events: int | None = None) -> Iterator[EventBatch]:
    """Yield successive chunks of an event file (parsed once, natively
    where the library is built, then sliced)."""
    ev = load_events_txt(path, max_events)
    for start in range(0, len(ev), chunk_events):
        yield ev[start:start + chunk_events]


def stream_flow(engine, chunks: Iterable[EventBatch], prefetch: int = 1,
                meter=None) -> Iterator[FlowOutput]:
    """Run `engine` (a FlowEngine) over a stream of chunks, yielding the
    flow of each chunk.

    State (time surfaces, flow surfaces, t0) carries across chunks, so the
    concatenated outputs equal one `process()` over the whole stream when
    the chunk boundaries fall on micro-batch boundaries.

    `prefetch` is the backpressure depth: a producer thread pulls up to
    that many source chunks ahead of the one being processed (0: no
    thread). An error of the source reaches the consumer, raised from this
    generator, never a silently short stream; a consumer that abandons the
    generator stops the producer. `meter`, if given, is called after every
    chunk with (events_in_chunk, seconds_for_chunk, events_total,
    seconds_total); `print_meter` prints a line to stderr.
    """
    source = _prefetched(chunks, prefetch) if prefetch > 0 else chunks
    n_total = 0
    t_total = 0.0
    for chunk in source:
        if len(chunk) == 0:
            continue
        t0 = time.perf_counter()
        out = engine.process(chunk)
        dt = time.perf_counter() - t0
        n_total += len(chunk)
        t_total += dt
        if meter is not None:
            meter(len(chunk), dt, n_total, t_total)
        yield out


def _prefetched(chunks: Iterable[EventBatch], depth: int):
    """The chunks of `chunks`, pulled by a producer thread through a queue
    of `depth` entries."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(tag, payload) -> bool:
        # a bounded put that gives up once the consumer is gone, so an
        # abandoned generator cannot pin the producer (and its source)
        while not stop.is_set():
            try:
                q.put((tag, payload), timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        err = None
        try:
            for c in chunks:
                if not put("chunk", c):
                    return
        except BaseException as e:   # noqa: BLE001 - re-raised by the consumer
            err = e
        put("end", err)

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            tag, payload = q.get()
            if tag == "end":
                if payload is not None:
                    raise payload
                return
            yield payload
    finally:
        stop.set()


def print_meter(n, dt, n_total, t_total):
    """Running events/s line for stream_flow's `meter` hook."""
    rate = n / dt if dt > 0 else float("inf")
    avg = n_total / t_total if t_total > 0 else float("inf")
    print(f"[stream] {n} events in {dt*1e6:.0f} us "
          f"({rate:,.0f} ev/s; running avg {avg:,.0f} ev/s over "
          f"{n_total} events)", file=sys.stderr)


def process_file_streaming(engine, path: str, chunk_events: int = 1 << 20,
                           max_events: int | None = None) -> FlowOutput:
    """Stream a file through `engine` and return the merged output."""
    outs = list(stream_flow(engine, iter_file_chunks(path, chunk_events,
                                                     max_events)))
    if not outs:
        return engine.process(EventBatch(
            np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.uint32), np.zeros(0, np.int32)))
    return FlowOutput.concatenate(outs)

"""Benchmark harness of the BASELINE.json configs, on the PyTorch port.

Counterpart of `farms_tpu.bench.harness`, with the same configs, sizes and
JSON lines:
  1. 320x320, 100K events, filtersize 5, inlierCheck 3
  2. 320x320, 1M events, filtersize sweep 3/5/7
  3. 640x480 ATIS-style stream (multi-scale pipeline)
  4. DAVIS240 (240x180) streaming: text file -> load -> process -> host
  5. 1280x720 stream, the halo engine over every visible card when there
     are two or more, the single engine otherwise

Each config reports events/s (the reference's own metric, main.cpp:201).
Configs 1-3 and 5 time `process_resident` replays: every replay starts
from the state that came before the first call (restored outside the
timed window) and is timed whole, from a synchronized start to a
synchronized end. Run as

    python -m farms_tpu_torch.bench.harness --configs 1,2|all [--out F]
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import (load_events_txt,
                                       synthetic_random_events,
                                       synthetic_rotating_shapes,
                                       write_events_davis_txt)
from farms_tpu_torch.pipeline.engine import FlowEngine


@dataclasses.dataclass
class BenchResult:
    name: str
    events: int
    events_per_sec: float
    extra: dict


# Events replayed in each timed round of `_time_resident`.
TARGET_EVENTS = 4_000_000


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_resident(engine: FlowEngine, ev, reps: int = 2) -> float:
    """Best events/s over `reps` rounds of process_resident replays, each
    round enough replays of the whole stream for TARGET_EVENTS events.
    Before every replay the engine's state is set back to the one that
    preceded the first call (no step modifies a state in place), outside
    the timed window, so each replay does the work of the stream's first
    pass; its time runs from a synchronized start to a synchronized
    end."""
    fn, n = engine.process_resident(ev)
    start = engine.state
    fn()                                     # warm-up
    calls = max(1, -(-TARGET_EVENTS // n))
    best = 0.0
    for _ in range(reps):
        total = 0.0
        for _ in range(calls):
            engine.state = start
            _sync(engine.device)
            t0 = time.perf_counter()
            fn()
            _sync(engine.device)
            total += time.perf_counter() - t0
        best = max(best, calls * n / total)
    engine.state = start
    return best


def config1_small(chunk: int = 4096) -> BenchResult:
    """100K events, 320x320, filtersize 5, inlierCheck 3."""
    cfg = FlowConfig(width=320, height=320, filter_size=5,
                     min_evts_on_plane=3, chunk_size=chunk)
    n = chunk * max(1, 100_000 // chunk)
    ev = synthetic_random_events(n, width=320, height=320, rate_hz=2e6)
    rate = _time_resident(FlowEngine(cfg), ev)
    return BenchResult("config1_100k_fs5", n, rate, {})


def config2_sweep(chunk: int = 32768,
                  filter_sizes=(3, 5, 7)) -> list[BenchResult]:
    """1M events, 320x320, filtersize sweep."""
    out = []
    n = chunk * 32
    ev = synthetic_random_events(n, width=320, height=320, rate_hz=5e6)
    for fs in filter_sizes:
        cfg = FlowConfig(width=320, height=320, filter_size=fs,
                         chunk_size=chunk)
        rate = _time_resident(FlowEngine(cfg), ev)
        out.append(BenchResult(f"config2_1M_fs{fs}", n, rate, {}))
    return out


def config3_atis(chunk: int = 32768) -> BenchResult:
    """640x480 stream, full multi-scale pipeline."""
    cfg = FlowConfig(width=640, height=480, chunk_size=chunk)
    n = chunk * 16
    ev = synthetic_random_events(n, width=640, height=480, rate_hz=8e6)
    rate = _time_resident(FlowEngine(cfg), ev)
    return BenchResult("config3_640x480", n, rate, {})


def config4_davis_streaming(chunk: int = 8192) -> BenchResult:
    """DAVIS240 (240x180) streaming: the whole file -> output contract on
    an Event Camera Dataset-style sequence, regenerated in its regime
    (synthetic_rotating_shapes) and written in the dataset's own `t x y p`
    float-second layout; the timed region covers the load (the layout
    conversion included), process() and the host outputs."""
    cfg = FlowConfig(width=240, height=180, chunk_size=chunk,
                     steps_per_scan=8, wire="f16")
    gen = synthetic_rotating_shapes(duration_us=3_000_000,
                                    omega_rad_s=4 * np.pi)
    with tempfile.TemporaryDirectory() as work:
        path = write_events_davis_txt(gen, os.path.join(work, "shapes"))
        eng = FlowEngine(cfg)
        eng.process(load_events_txt(path, chunk * 8, layout="txyp",
                                    time_unit="s"))           # warm-up
        eng.reset()
        t0 = time.perf_counter()
        ev = load_events_txt(path, layout="txyp", time_unit="s")
        out = eng.process(ev)
        dt = time.perf_counter() - t0
    n = len(ev)
    return BenchResult("config4_davis_streaming", n, n / dt,
                       {"source": "shapes_rotation-style txyp file",
                        "valid_frac": float((out.r_local > 0).mean())})


def config5_inputs(chunk: int = 32768):
    """Config 5's FlowConfig and stream: 1280x720, eight calls' worth of
    events."""
    cfg = FlowConfig(width=1280, height=720, chunk_size=chunk)
    ev = synthetic_random_events(chunk * 8, width=1280, height=720,
                                 rate_hz=2e7)
    return cfg, ev


def _config5_rank(chunk: int) -> float:
    """One rank of config 5's halo engine (parallel/mesh.py `run`)."""
    from farms_tpu_torch.parallel.halo import HaloFlowEngine
    cfg, ev = config5_inputs(chunk)
    return _time_resident(HaloFlowEngine(cfg), ev)


def config5_sharded(chunk: int = 32768) -> BenchResult:
    """1280x720 stream: the halo engine with one rank per visible card
    where there are two or more (it pads non-divisible widths), the
    single engine otherwise."""
    from farms_tpu_torch.parallel import mesh
    n_dev = torch.cuda.device_count()
    if n_dev >= 2:
        rate = mesh.run(_config5_rank, n_dev, "cuda", chunk)
        engine = "HaloFlowEngine"
    else:
        cfg, ev = config5_inputs(chunk)
        rate = _time_resident(FlowEngine(cfg), ev)
        engine = "FlowEngine"
    return BenchResult(f"config5_1280x720_dev{n_dev}", chunk * 8, rate,
                       {"engine": engine, "devices": n_dev})


ALL_CONFIGS: dict[str, Callable] = {
    "1": config1_small,
    "2": config2_sweep,
    "3": config3_atis,
    "4": config4_davis_streaming,
    "5": config5_sharded,
}


def result_lines(res) -> list[str]:
    """The JSON lines of a config's result(s)."""
    import json
    return [json.dumps({"config": r.name, "events": r.events,
                        "events_per_sec": round(r.events_per_sec, 1),
                        **r.extra})
            for r in (res if isinstance(res, list) else [res])]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="FARMS benchmark harness (PyTorch port)")
    p.add_argument("--configs", default="1",
                   help="comma-separated config ids (1-5) or 'all'")
    p.add_argument("--out", default=None,
                   help="also append result lines to this JSONL file")
    args = p.parse_args(argv)
    ids = (list(ALL_CONFIGS) if args.configs == "all"
           else args.configs.split(","))
    unknown = [c for c in ids if c not in ALL_CONFIGS]
    if unknown:
        p.error(f"unknown config id(s) {unknown}; "
                f"valid: {', '.join(ALL_CONFIGS)} or 'all'")
    for cid in ids:
        for line in result_lines(ALL_CONFIGS[cid]()):
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as sink:
                    sink.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Throughput benchmark of the PyTorch port: prints one JSON line.

Counterpart of `bench.py`, with its three lanes, its `FARMS_BENCH_*`
environment variables and defaults, and its key names:

- **device lane** (`value`): events start in device memory and outputs
  stay there. `device_batches` uploads `n_calls` distinct calls before the
  timer, each a freshly seeded 320 x 320 random stream whose stamps
  continue one timeline (call i's offset by i spans), packed as `bench.py`
  packs them (`pack(compact=True)`, `pack_wesc`, `pack_r2` under
  correction); `timed_lane` runs them in order through `scan_chunk` from
  `init_state`, best of 3, fenced by `torch.cuda.synchronize`.
- **fidelity lane** (`fidelity_*`): the `fidelity` preset's device rate,
  and `fidelity_validity_agreement`, measured in the run: the first timed
  chunk's wire rows decoded (`decode_wire_columns`) and held against the
  float64 event-serial oracle's validity on the same events
  (`oracle_valid_bits`, through `accuracy.oracle_cached`'s cache).
- **e2e lane** (`e2e_*`): the median of `FARMS_BENCH_E2E_REPS` passes of
  `FARMS_BENCH_E2E_CALLS` `process()` calls on host events (pack, upload,
  download and decode included) on the `FARMS_BENCH_E2E_WIRE` wire, with
  the passes, the wire's MB/s and the wall seconds a pass.

Departures from `bench.py`'s line:
- left out: `vs_baseline`, `e2e_vs_baseline` and `fidelity_vs_baseline`,
  whose denominator (`bench.py:52`, 6.25 M events/s) is a per-TPU-chip
  target;
- left out: the tunnel's keys (`e2e_fetches_per_process_call`,
  `e2e_rtt_ms`, `e2e_fetch_wall_s_per_pass`, `e2e_1thread_*`): the port
  has no fetch thread pool and no tunnel round trip to count;
- not read: `FARMS_BENCH_BACKEND` (Pallas or XLA in JAX): the port has
  no kernel switch, a CUDA tensor runs the kernels;
- added: `device` (the torch device type), `device_name`
  (`torch.cuda.get_device_name`) and `card` (`nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`), null on the CPU.

Run: python -m farms_tpu_torch.bench.driver [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from farms_tpu_torch.bench import accuracy
from farms_tpu_torch.bench.harness import _sync, card, require_device
from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, synthetic_random_events
from farms_tpu_torch.pipeline.engine import (FlowEngine, decode_wire_columns,
                                             scan_chunk)
from farms_tpu_torch.state.surfaces import init_state

# the sensor of bench.py's config (BASELINE.json config 2)
SENSOR = (320, 320)
# calls packed for the fidelity lane (bench.py:191)
FIDELITY_CALLS = 6


def _env(name: str, default):
    return type(default)(os.environ.get(name, default))


def device_batches(eng: FlowEngine, cfg: FlowConfig, ev: EventBatch,
                   spc: int, n_calls: int, span: int, device):
    """Upload n_calls DISTINCT batch dicts continuing one timeline.

    Call 0 is `ev`, call i > 0 a stream seeded i; each call's stamps are
    offset by i * span, so the calls continue one stream. Each is packed
    as process() ships the dense path's calls, with the compact layout in
    place of the delta-coded words: compact events, the equal-stamp
    escapes of the derived `written` where they fit, and the rank-2
    correction lanes when the config asks for them. `pack_wesc` advances
    the engine's host stamp mirror, so the batches are right only when
    they run in the order they were packed. Returns (batches on
    `device`, the host streams)."""
    n = cfg.chunk_size * spc
    batches, evs = [], []
    for i in range(n_calls):
        evi = (ev if i == 0 else
               synthetic_random_events(n, width=cfg.width, height=cfg.height,
                                       rate_hz=5e6, seed=i))
        evi = EventBatch(evi.x, evi.y,
                         (evi.t.astype(np.int64) + i * int(span))
                         .astype(np.uint32), evi.pol)
        evs.append(evi)
        packed, _ = eng.pack(evi, steps_per_call=spc, compact=True)
        wesc, ok = eng.pack_wesc(evi, steps_per_call=spc)
        batch = {"ev": packed[0]}
        if ok[0]:
            batch["wesc"] = wesc[0]
        if cfg.center_correction:
            r2f, r2c = eng.pack_r2(evi, steps_per_call=spc)
            batch["r2f"] = r2f[0]
            batch["r2c"] = eng.array_centers(r2c[0])
        batches.append({k: torch.from_numpy(np.ascontiguousarray(v))
                        .to(device) for k, v in batch.items()})
    return batches, evs


def timed_lane(cfg: FlowConfig, batches, device, reps: int = 3):
    """Best-of-reps events/s over the uploaded call sequence, each rep
    from init_state; returns (rate, the last rep's wire outputs)."""
    best = 0.0
    outs = None
    n = cfg.chunk_size * batches[0]["ev"].shape[0]
    for _ in range(reps):
        state = init_state(cfg, device)
        _sync(device)
        outs = []
        t0 = time.perf_counter()
        for b in batches:
            state, out = scan_chunk(state, b, cfg)
            outs.append(out)
        _sync(device)
        dt = time.perf_counter() - t0
        best = max(best, len(batches) * n / dt)
    return best, outs


def warm_up(cfg: FlowConfig, batch: dict, device) -> None:
    """One call from init_state, outside any timed window (the first
    launch of each kernel and allocator growth)."""
    scan_chunk(init_state(cfg, device), batch, cfg)
    _sync(device)


def oracle_valid_bits(ev_slice: EventBatch, cfg: FlowConfig) -> np.ndarray:
    """Float64 event-serial oracle validity bits (accuracy.oracle_cached:
    cached on the config and every event's t, x and y)."""
    return accuracy.oracle_cached(ev_slice, cfg, "bench")["r_local"] > 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Benchmark line of the PyTorch port (bench.py's lanes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    device = require_device(ap.parse_args(argv).device)
    width, height = SENSOR

    # benchmark preset: the highest-throughput point within the accuracy
    # budget against the event-serial oracle (ACCURACY.md)
    m = _env("FARMS_BENCH_CHUNK", 131072)
    spc = _env("FARMS_BENCH_STEPS", 8)
    n_calls = _env("FARMS_BENCH_CALLS", 16)
    e2e_calls = _env("FARMS_BENCH_E2E_CALLS", 4)
    e2e_reps = _env("FARMS_BENCH_E2E_REPS", 5)
    n = m * spc  # events per scan call
    wire = _env("FARMS_BENCH_WIRE", "f16")
    phases = _env("FARMS_BENCH_PHASES", 2)
    aphases = _env("FARMS_BENCH_APHASES", 0)
    snapshots = _env("FARMS_BENCH_SNAPSHOTS", 1)
    correction = _env("FARMS_BENCH_CORRECTION", 0)
    cfg = FlowConfig(width=width, height=height, chunk_size=m,
                     use_dense=True, wire=wire, sub_phases=phases,
                     aperture_sub_phases=aphases,
                     causal_snapshots=snapshots,
                     center_correction=correction)

    ev = synthetic_random_events(n, width=width, height=height, rate_hz=5e6,
                                 seed=0)
    # timeline span of one call's worth of events (plus one mean gap), so
    # call i's stamps continue where call i-1 ended
    span = int(ev.t[-1]) + max(1, int(ev.t[-1]) // max(1, n))

    # ---- device lane (benchmark preset) ------------------------------------
    eng = FlowEngine(cfg, device=device)
    batches, _ = device_batches(eng, cfg, ev, spc, n_calls, span, device)
    warm_up(cfg, batches[0], device)
    best, _ = timed_lane(cfg, batches, device)
    del batches

    # ---- fidelity lane: the `--preset fidelity` operating point ------------
    # device rate and validity agreement against the float64 oracle, both
    # measured in this run on this stream
    fidelity = 0.0
    agreement = None
    if _env("FARMS_BENCH_FIDELITY", 1):
        cfg_f = dataclasses.replace(
            cfg, sub_phases=_env("FARMS_BENCH_F_PHASES", 2),
            aperture_sub_phases=_env("FARMS_BENCH_F_APHASES", 2),
            causal_snapshots=_env("FARMS_BENCH_F_SNAPSHOTS", 8),
            center_correction=_env("FARMS_BENCH_F_CORRECTION", 32768),
            correction_coarse_chain=bool(_env("FARMS_BENCH_F_COARSE", 1)))
        eng_f = FlowEngine(cfg_f, device=device)
        ev_f = synthetic_random_events(n, width=width, height=height,
                                       rate_hz=5e6, seed=100)
        packs, f_evs = device_batches(eng_f, cfg_f, ev_f, spc,
                                      FIDELITY_CALLS, span, device)
        warm_up(cfg_f, packs[0], device)
        fidelity, f_outs = timed_lane(cfg_f, packs, device)
        del packs
        # agreement on the first chunk (m events) of the timed stream:
        # decode the wire rows the run produced
        main0 = f_outs[0][0][0].cpu().numpy()     # [C, m] step 0
        aux0 = f_outs[0][1][0].cpu().numpy()      # [m]
        gv = decode_wire_columns(main0, aux0, cfg_f)["r_local"] > 0
        ov = oracle_valid_bits(f_evs[0][:m], cfg_f)
        agreement = float((gv[:m] == ov).mean())

    # ---- e2e lane: fresh host events, pack + H2D + D2H included -----------
    e2e_wire = _env("FARMS_BENCH_E2E_WIRE", "sparse")
    e2e = 0.0
    e2e_passes = []
    frac_present = frac_valid = 1.0
    up_bytes = 8
    if e2e_calls:
        eng2 = FlowEngine(dataclasses.replace(cfg, wire=e2e_wire),
                          device=device)
        eng2.process(ev)  # warm-up
        for _ in range(e2e_reps):
            eng2.reset()
            t0 = time.perf_counter()
            for i in range(e2e_calls):
                out = eng2.process(EventBatch(
                    ev.x, ev.y,
                    (ev.t.astype(np.int64) + i * span).astype(np.uint32),
                    ev.pol))
            float(np.sum(out.r_true))  # host arrays
            e2e_passes.append(e2e_calls * n / (time.perf_counter() - t0))
        e2e = statistics.median(e2e_passes)
        frac_present = float(np.mean((out.vx != 0) | (out.vy != 0)
                                     | np.isnan(out.vx)))
        frac_valid = float(np.mean(out.r_local != 0))
        # 4 B/event up where the compact2 delta layout applies (pack2)
        if eng2.pack2(ev[: 4 * m])[1] is not None:
            up_bytes = 4

    # e2e wire bytes down: 1 aux byte plus 4 per present and 4 per valid
    # lane on the sparse wire, 9 (f16) or 17 (f32) dense
    if e2e_wire == "sparse":
        down_bytes = 1 + 4 * (frac_present + frac_valid)
    else:
        down_bytes = 9 if e2e_wire == "f16" else 17
    out = {
        "metric": "events_per_second_single_chip",
        "value": round(best, 1),
        "unit": "events/s",
        "chunk_size": m,
        "sub_phases": phases,
        "e2e_events_per_second": round(e2e, 1),
        "e2e_wire_MBps": round(e2e * (up_bytes + down_bytes) / 1e6, 1),
        "e2e_passes": [round(p, 1) for p in e2e_passes],
        "e2e_wall_s_per_pass": round(e2e_calls * n / e2e if e2e else 0.0, 3),
        "fidelity_events_per_second": round(fidelity, 1),
    }
    if agreement is not None:
        # measured in this run: the first timed chunk's decoded validity
        # bits against the float64 event-serial oracle on the same events
        out["fidelity_validity_agreement"] = round(agreement, 4)
        out["fidelity_agreement_events"] = m
    out["device"] = device.type
    out["device_name"] = (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else None)
    out["card"] = card(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Where FlowEngine.process spends its time, stage by stage (PyTorch port).

Runs the `benchmark` operating point (320 x 320, chunk 131072, 2
sub-phases, f16 wire) on the 1,048,576-event random stream of bench.py
(5e6 ev/s, seed 0) and prints one JSON line of wall seconds per stage:
host packing (pack2, pack_wesc), upload, the device micro-steps, download
and host decode (median of 3 runs), plus the device's busy share over the
micro-steps: the device-side time (kernels, copies) torch.profiler
records in a fourth, profiled run over the median wall time of the
unprofiled micro-steps. Needs a CUDA
device:

    python scripts/torch_stage_times.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from farms_tpu_torch.config import FlowConfig  # noqa: E402
from farms_tpu_torch.events.io import synthetic_random_events  # noqa: E402
from farms_tpu_torch.pipeline.engine import FlowEngine, scan_chunk  # noqa: E402


def _stages(eng: FlowEngine, ev, dev, profile: bool):
    t = {}
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    packed, aux2, n = eng.pack2(ev)
    t["pack2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wesc, ok = eng.pack_wesc(ev)
    t["pack_wesc"] = time.perf_counter() - t0
    t["upload"] = t["steps"] = t["download"] = 0.0
    blocks, busy_us = [], 0.0
    for c in range(packed.shape[0]):
        t0 = time.perf_counter()
        chunk = {"ev": torch.from_numpy(packed[c]).to(dev),
                 "base": torch.from_numpy(aux2[0][c]).to(dev),
                 "esc": torch.from_numpy(aux2[1][c]).to(dev)}
        if ok[c]:
            chunk["wesc"] = torch.from_numpy(wesc[c]).to(dev)
        sync()
        t["upload"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                eng.state, (main, aux) = scan_chunk(eng.state, chunk, eng.cfg)
                sync()
            # device-side events only (kernels, copies, sets): a CPU op's
            # row repeats the time of the kernels it launched
            busy_us += sum(e.self_device_time_total for e in prof.events()
                           if e.device_type == DeviceType.CUDA
                           and not e.is_user_annotation)
        else:
            eng.state, (main, aux) = scan_chunk(eng.state, chunk, eng.cfg)
            sync()
        t["steps"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        blocks.append((main.cpu().numpy(), aux.cpu().numpy()))
        t["download"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng._unpack_outputs(blocks, ev, n)
    t["decode"] = time.perf_counter() - t0
    return t, busy_us * 1e-6, out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = FlowConfig(width=320, height=320, chunk_size=131072, sub_phases=2,
                     wire="f16")
    n = 1 << 20
    ev = synthetic_random_events(n, width=320, height=320, rate_hz=5e6,
                                 seed=0)
    FlowEngine(cfg, device=dev).process(ev[:cfg.chunk_size])   # warm-up
    reps = []
    for profile in (False, False, False, True):
        eng = FlowEngine(cfg, device=dev)
        t, busy, out = _stages(eng, ev, dev, profile)
        if not profile:
            reps.append(t)
    med = {k: float(np.median([r[k] for r in reps])) for k in reps[0]}
    total = sum(med.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "events": n, "seconds": med, "total_s": total,
        "events_per_s": n / total,
        "device_busy_s": busy,
        "device_busy_share_of_steps": busy / med["steps"],
        "valid_fraction": float((out.r_local > 0).mean()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

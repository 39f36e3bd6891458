#!/usr/bin/env python3
"""Where FlowEngine.process spends its time, stage by stage (PyTorch port).

Runs a CLI preset's operating point (default `benchmark`: 320 x 320, chunk
131072, 2 sub-phases, f16 wire; `fidelity` adds 2 aperture phases, 8
snapshots and the rank-2 correction) on the 1,048,576-event random stream
of bench.py (5e6 ev/s, seed 0) and prints one JSON line of wall seconds
per stage: host packing (pack2, pack_wesc, pack_r2 under correction),
upload, the device micro-steps, download and host decode (median of 3
runs), plus the device's busy share over the micro-steps: the device-side
time (kernels, copies) torch.profiler records in a fourth, profiled run
over the median wall time of the unprofiled micro-steps. Needs a CUDA
device:

    python scripts/torch_stage_times.py [--preset fidelity] [--filtersize 7]

With `--halo-ranks N` it times the halo engine (parallel/halo.py) instead,
on N ranks with one card each (NCCL; N = 1 runs in this process): the wall
seconds of each of 4 `process` runs on the same stream, the first being
the ranks' first, and of the engine's host packing (`pack_halo`) alone,
as rank 0 sees them. Needs N cards:

    python scripts/torch_stage_times.py --halo-ranks 2
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from farms_tpu_torch.cli import _PRESETS  # noqa: E402
from farms_tpu_torch.config import FlowConfig  # noqa: E402
from farms_tpu_torch.events.io import synthetic_random_events  # noqa: E402
from farms_tpu_torch.ops import _build  # noqa: E402
from farms_tpu_torch.parallel import mesh  # noqa: E402
from farms_tpu_torch.parallel.halo import HaloFlowEngine  # noqa: E402
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
    r2 = None
    if eng.cfg.center_correction:
        t0 = time.perf_counter()
        r2 = eng.pack_r2(ev)
        t["pack_r2"] = time.perf_counter() - t0
    t["upload"] = t["steps"] = t["download"] = 0.0
    blocks, busy_us = [], 0.0
    for c in range(packed.shape[0]):
        t0 = time.perf_counter()
        chunk = {"ev": torch.from_numpy(packed[c]).to(dev),
                 "base": torch.from_numpy(aux2[0][c]).to(dev),
                 "esc": torch.from_numpy(aux2[1][c]).to(dev)}
        if ok[c]:
            chunk["wesc"] = torch.from_numpy(wesc[c]).to(dev)
        if r2 is not None:
            chunk["r2f"] = torch.from_numpy(r2[0][c]).to(dev)
            chunk["r2c"] = torch.from_numpy(r2[1][c]).to(dev)
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


def _halo_runs(cfg, ev, reps: int, device: str = "cuda"):
    """A rank's wall seconds of reps HaloFlowEngine.process runs, each of
    a new engine and started together on every rank, then of pack_halo
    alone (a mesh.run entry point; a rank's "cuda" is its own card)."""
    dev = torch.device(device)
    _, n = mesh.rank_and_size()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    runs = []
    for _ in range(reps):
        eng = HaloFlowEngine(cfg, device=dev)
        sync()
        if n > 1:
            torch.distributed.barrier()
        t0 = time.perf_counter()
        eng.process(ev)
        sync()
        runs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    HaloFlowEngine(cfg, device=dev).pack_halo(ev)
    return runs, time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="benchmark",
                   choices=["benchmark", "fidelity"])
    p.add_argument("--filtersize", type=int, default=3)
    p.add_argument("--halo-ranks", type=int, default=0,
                   help="time the halo engine on this many ranks instead")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    chunk, phases, ap, snaps, corr, cchain, wire = _PRESETS[args.preset]
    cfg = FlowConfig(width=320, height=320, filter_size=args.filtersize,
                     chunk_size=chunk, sub_phases=phases,
                     aperture_sub_phases=ap, causal_snapshots=snaps,
                     center_correction=corr, correction_coarse_chain=cchain,
                     wire=wire)
    n = 1 << 20
    ev = synthetic_random_events(n, width=320, height=320, rate_hz=5e6,
                                 seed=0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.halo_ranks:
        _build.build()          # once, before the ranks start
        runs, pack_s = mesh.run(_halo_runs, args.halo_ranks, "cuda", cfg,
                                ev, 4)
        warm = float(np.median(runs[1:]))
        print(json.dumps({
            "card": smi, "preset": args.preset, "filter_size": cfg.filter_size,
            "events": n, "halo_ranks": max(1, args.halo_ranks),
            "process_s": runs, "first_s": runs[0], "warm_median_s": warm,
            "events_per_s_warm": n / warm, "pack_halo_s": pack_s,
        }))
        return 0
    FlowEngine(cfg, device=dev).process(ev[:cfg.chunk_size])   # warm-up
    reps = []
    for profile in (False, False, False, True):
        eng = FlowEngine(cfg, device=dev)
        t, busy, out = _stages(eng, ev, dev, profile)
        if not profile:
            reps.append(t)
    med = {k: float(np.median([r[k] for r in reps])) for k in reps[0]}
    total = sum(med.values())
    print(json.dumps({
        "card": smi, "preset": args.preset, "filter_size": cfg.filter_size,
        "events": n, "seconds": med, "total_s": total,
        "events_per_s": n / total,
        "device_busy_s": busy,
        "device_busy_share_of_steps": busy / med["steps"],
        "valid_fraction": float((out.r_local > 0).mean()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-device scaling sweep of the PyTorch port.

Counterpart of `scripts/scaling_sweep.py`: the device-resident events/s
(`process_resident` replays, timed by `harness._time_resident`, which sets
the start state back before every replay outside the timed window) of the
sharded engines at N ranks, and the efficiency against one rank; written
to SCALING_TORCH.json with the backend and the card.

- Engines: halo and multihost as the JAX sweep runs them (multihost on a
  (tx, ev) = (N / 2, 2) grid), and dp and spatial (x tiles) through the
  same loop. At N = 1 every engine is the single FlowEngine, measured once
  and shared by the engines' first rows.
- Ranks are spawned processes (parallel/mesh.py `run`): NCCL with one card
  a rank on cuda, gloo ranks with `--device cpu`, which check only the
  plumbing (the ranks share one host's cores).
- Before an engine is timed, each rank runs the stream through
  `process()` and through one `process_resident` call from a fresh state,
  and rank 0 holds the decoded columns equal bit for bit (a mismatch
  raises); `lanes_unlike_single` counts the lanes where any column
  differs from the single engine's `process()` (on the card a sharded
  integral may break a float64 scale tie otherwise, pipeline/ties.py).
- `halo_replication_ceiling` is core / (core + 2 R) for the `core` rows
  of a rank's band (W / N for halo and spatial x tiles, W / tx for
  multihost; 1 where a rank holds every row: dp, multihost at tx = 1),
  with R the plane fit's support radius, 2 * (filter_size // 2). The JAX
  sweep reads a missing `args.filter_size`, so its R is always 2, and
  takes W / N for multihost too. The ceiling counts only the halo rows a
  rank fits again; dp and multihost's ev axis compute the whole band's
  maps on every rank, which it does not count.

Run: python -m farms_tpu_torch.bench.scaling [--devices 1 2 4 8]
     [--device cpu] [--out SCALING_TORCH.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from farms_tpu_torch.bench.harness import (TARGET_EVENTS, _time_resident,
                                           card, require_device)
from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import FlowOutput, synthetic_random_events
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.dp import ShardedFlowEngine
from farms_tpu_torch.parallel.halo import HaloFlowEngine
from farms_tpu_torch.parallel.multihost import MultiHostFlowEngine
from farms_tpu_torch.parallel.tiling import SpatialFlowEngine
from farms_tpu_torch.pipeline.engine import FlowEngine

ENGINES = ("halo", "multihost", "dp", "spatial")
_COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
            "r_local", "theta_local", "scale")


def make_engine(name: str, cfg: FlowConfig, nd: int, device):
    """Engine `name` over this process's nd ranks (the single engine at
    nd = 1)."""
    if nd == 1:
        return FlowEngine(cfg, device=device)
    if name == "halo":
        return HaloFlowEngine(cfg, device=device)
    if name == "multihost":
        tx = max(1, nd // 2)
        return MultiHostFlowEngine(
            cfg, mesh=mesh.make_global_mesh(tx=tx, ev=nd // tx),
            device=device)
    if name == "dp":
        return ShardedFlowEngine(cfg, device=device)
    if name == "spatial":
        return SpatialFlowEngine(cfg, device=device)
    raise ValueError(f"unknown engine {name!r}; known: {ENGINES}")


def halo_ceiling(eng) -> float:
    """core / (core + 2 R): the share of the plane fits a rank of `eng`
    runs that are its own, for the `core` rows of its band and R = 2 *
    (filter_size // 2); 1 where a rank holds every row."""
    if isinstance(eng, HaloFlowEngine):
        parts = eng.n_shards
    elif isinstance(eng, (ShardedFlowEngine, SpatialFlowEngine)):
        parts = eng.mesh.tx          # dp's mesh is (1, N)
    else:
        parts = 1
    if parts == 1:
        return 1.0
    core = eng.cfg.array_width // parts
    return core / (core + 2 * 2 * (eng.cfg.filter_size // 2))


def resident_output(eng, ev) -> FlowOutput | None:
    """One process_resident call of `ev` from the engine's state, decoded
    as its process() decodes: the FlowOutput on the ranks whose process()
    returns one, None on the others. Call it on every rank."""
    fn, n = eng.process_resident(ev)
    main, aux = fn()
    if isinstance(eng, HaloFlowEngine):
        perm = eng.pack_halo(ev, -(-n // eng.cfg.chunk_size))[2]
        block = eng._gather(main, aux, perm is not None)
        return None if block is None else eng._unpack([block], ev, n, perm)
    if isinstance(eng, SpatialFlowEngine):
        block = eng._gather(main, aux)
    elif isinstance(eng, ShardedFlowEngine):
        block = eng._collect(main, aux)
        if not eng._returns_output():
            return None
    else:
        block = (main, aux)
    return None if block is None else eng._unpack_outputs([block], ev, n)


def _differing(a: FlowOutput, b: FlowOutput) -> np.ndarray:
    """Lanes where any column of a and b differs in its bits."""
    diff = np.zeros(len(a), bool)
    for col in _COLUMNS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        if x.dtype != y.dtype:
            raise AssertionError(f"{col}: {x.dtype} against {y.dtype}")
        w = x.view(np.uint8).reshape(len(x), -1)
        diff |= (w != y.view(np.uint8).reshape(len(y), -1)).any(1)
    return diff


def engine_rank(name: str, nd: int, cfg: FlowConfig, ev, device,
                single: FlowOutput | None, replay_events: int):
    """One rank of engine `name` at nd ranks: its resident replay checked
    against its process() from a fresh state (bit for bit, on the ranks
    that return outputs), then timed. Returns (events/s, engine class
    name, lanes unlike `single`, halo_ceiling) on rank 0."""
    eng = make_engine(name, cfg, nd, device)
    want = eng.process(ev)
    eng.reset()
    got = resident_output(eng, ev)
    eng.reset()
    unlike = None
    if got is not None:
        bad = _differing(want, got)
        if bad.any():
            raise AssertionError(
                f"{type(eng).__name__} at {nd} ranks: process_resident "
                f"differs from process() on {int(bad.sum())} lanes")
        unlike = (None if single is None
                  else int(_differing(single, got).sum()))
    rate = _time_resident(eng, ev, target_events=replay_events)
    return rate, type(eng).__name__, unlike, halo_ceiling(eng)


def sweep(cfg: FlowConfig, ev, devices, engines=ENGINES, device="cuda",
          replay_events: int = TARGET_EVENTS):
    """{engine: [row per N in `devices`]}, printing each row."""
    device = require_device(device)
    single = FlowEngine(cfg, device=device).process(ev)
    shared = None   # the single engine's result, run once
    results = {}
    for name in engines:
        rows = []
        base = None
        for nd in devices:
            t0 = time.time()
            if nd == 1 and shared is not None:
                res = shared
            else:
                res = mesh.run(engine_rank, nd, device.type, name, nd, cfg,
                               ev, device.type, single, replay_events)
            if nd == 1:
                shared = res
            rate, cls, unlike, ceiling = res
            if base is None:
                base = rate
            eff = rate / (base * nd)
            rows.append({
                "devices": nd,
                "engine": cls,
                "events_per_sec": round(rate, 1),
                "efficiency_vs_1dev": round(eff, 4),
                "halo_replication_ceiling": round(ceiling, 4),
                "efficiency_vs_ceiling": round(eff / ceiling, 4),
                "lanes_unlike_single": unlike,
            })
            print(f"[{name} n={nd}] {json.dumps(rows[-1])} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        results[name] = rows
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Scaling sweep of the PyTorch port's sharded engines")
    ap.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--max-window", type=int, default=20,
                    help="aperture half-window (the halo engines' band "
                         "depth)")
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--engines", nargs="+", default=list(ENGINES),
                    choices=ENGINES)
    ap.add_argument("--replay-events", type=int, default=TARGET_EVENTS,
                    help="events replayed in each timed round")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a rank) or cpu (gloo)")
    ap.add_argument("--out", default="SCALING_TORCH.json")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cuda = device.type == "cuda"
    n_avail = torch.cuda.device_count() if cuda else os.cpu_count()
    devices = [d for d in args.devices if d <= n_avail]
    cfg = FlowConfig(width=args.width, height=args.height,
                     max_window=args.max_window, chunk_size=args.chunk,
                     steps_per_scan=4)
    n = args.chunk * 4 * args.calls
    ev = synthetic_random_events(n, width=args.width, height=args.height,
                                 rate_hz=5e6)
    results = {
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if cuda else None,
        "card": card(device),
        "n_devices_available": n_avail,
        "devices_run": devices,
        "note": ("NCCL, one card a rank, on one host" if cuda else
                 "gloo ranks sharing one host's CPU cores: the rows check "
                 "the plumbing (spawn, collectives, resident replay "
                 "against process()), not scaling"),
        "config": {"width": args.width, "height": args.height,
                   "max_window": args.max_window, "chunk_size": args.chunk,
                   "events": n, "replay_events": args.replay_events},
        "engines": sweep(cfg, ev, devices, args.engines, device,
                         args.replay_events)}
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Device-lane rate sweep over operating points, on the PyTorch port.

Counterpart of `scripts/device_sweep.py`: the driver's device-lane method
(`driver.device_batches`: distinct calls continuing one timeline, uploaded
before the timer; `driver.timed_lane`: best of 3, fenced by
`torch.cuda.synchronize`) for each (P, A, S, correction) of CONFIGS on the
320 x 320 random stream. Prints one JSON line per config, with the card
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`; null on
the CPU). `setup_s` is the seconds to pack and upload the calls and run
the warm-up call (JAX's `compile_s`; the port builds its kernels when the
engine is made).

Environment: SWEEP_CHUNK (131072), SWEEP_STEPS (8), SWEEP_CALLS (6).

Run: python -m farms_tpu_torch.bench.device_sweep [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from farms_tpu_torch.bench import driver
from farms_tpu_torch.bench.harness import card, require_device
from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import synthetic_random_events
from farms_tpu_torch.pipeline.engine import FlowEngine

CONFIGS = [
    # (sub_phases, aperture_sub_phases, snapshots, correction)
    (2, 2, 1, 0),          # benchmark preset, epoch-less
    (2, 2, 4, 0),
    (2, 2, 4, 32768),
    (2, 2, 8, 32768),
    (4, 2, 2, 16384),
    (4, 2, 4, 16384),
    (8, 2, 2, 0),          # round-4 fidelity preset, epoch-less
    (8, 2, 2, 8192),
]


def sweep(configs=CONFIGS, device="cuda"):
    """Yield one result dict per (P, A, S, C) of `configs`."""
    device = require_device(device)
    width, height = driver.SENSOR
    m = int(os.environ.get("SWEEP_CHUNK", 131072))
    spc = int(os.environ.get("SWEEP_STEPS", 8))
    n_calls = int(os.environ.get("SWEEP_CALLS", 6))
    ev = synthetic_random_events(m * spc, width=width, height=height,
                                 rate_hz=5e6, seed=0)
    span = int(ev.t[-1]) + 1
    smi = card(device)
    for (P, A, S, C) in configs:
        cfg = FlowConfig(width=width, height=height, chunk_size=m,
                         wire="f16", sub_phases=P, aperture_sub_phases=A,
                         causal_snapshots=S, center_correction=C)
        eng = FlowEngine(cfg, device=device)
        t0 = time.time()
        batches, _ = driver.device_batches(eng, cfg, ev, spc, n_calls, span,
                                           device)
        driver.warm_up(cfg, batches[0], device)
        setup_s = time.time() - t0
        best, _ = driver.timed_lane(cfg, batches, device)
        yield {"P": P, "A": A, "S": S, "C": C,
               "device_ev_per_s": round(best, 1), "M": round(best / 1e6, 2),
               "setup_s": round(setup_s, 1), "card": smi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Device-lane rates of the PyTorch port over CONFIGS")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    for line in sweep(device=args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

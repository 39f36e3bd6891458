"""Accuracy of the chunked engine against the float64 event-serial oracle.

Counterpart of `scripts/accuracy_sweep.py`, on the PyTorch port: the same
two 120,000-event 320 x 320 streams (`make_stream`), the same sweep flags
and the same metrics (`metrics`: validity agreement, AEE and angular error
of the true flow on the lanes both sides hold valid, scale match), with
the rows run through the port's `FlowEngine` on the card (`--device cpu`
or `--cpu`: the kernels' plain versions).

Two streams:
- "random": the benchmark's own distribution (synthetic_random_events at
  5 M events/s);
- "bar": four stacked translating bars and background noise (structured
  flow: AEE in px/ms).

The oracle (pipeline/oracle.py) is cached under CACHE_DIR
(`$FARMS_TORCH_ORACLE_CACHE`, else `farms_tpu_torch/_build/oracle`),
keyed on the config and every event's t, x and y; the JAX script keys on
the first 64 stamps only, so an edit past them would read a stale file.
The directory is the port's own: it never reads a file that `farms_tpu`
wrote.

The output has the JAX script's structure, with "backend" the device
type ("cuda" or "cpu") and, on the card, "device" (its name) and "card"
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`).
`--append` adds the run's rows to an existing output of the same backend,
card and event count, so one file can hold the rows of several sweeps;
"runs" lists the flags of each sweep in the file, in order.

Run: python -m farms_tpu_torch.bench.accuracy [--stream bar random]
     [--n 120000] [--chunks ...] [--phases ...] [--aperture-phases ...]
     [--snapshots ...] [--correction ...] [--coarse-chain] [--wire f16]
     [--out ACCURACY_TORCH.json] [--append] [--device cpu | --cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

from farms_tpu_torch.bench.harness import card, require_device
from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import (EventBatch, FlowOutput,
                                       synthetic_random_events,
                                       synthetic_translating_bar)
from farms_tpu_torch.pipeline.engine import FlowEngine
from farms_tpu_torch.pipeline.oracle import run_oracle

CACHE_DIR = os.environ.get(
    "FARMS_TORCH_ORACLE_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "_build", "oracle"))
CHUNKS = (256, 2048, 16384, 65536, 131072)


def make_stream(kind: str, n: int) -> EventBatch:
    if kind == "random":
        return synthetic_random_events(n, width=320, height=320,
                                       rate_hz=5e6, seed=0)
    # "bar": four stacked bars sweeping +x at 10_000 px/s (~2.4 M ev/s)
    # plus ~30% random background, merged chronologically
    parts = []
    for i, y0 in enumerate((40, 120, 200, 280)):
        b = synthetic_translating_bar(width=320, height=320, bar_len=60,
                                      speed_px_per_sec=10000.0,
                                      duration_us=30000, jitter_us=30,
                                      seed=i)
        # recenter each bar's y band (generator centers at height/2)
        parts.append((b.x, b.y - (160 - y0), b.t, b.pol))
    n_bar = sum(len(p[0]) for p in parts)
    n_bg = max(0, n - n_bar)
    t_end = max(int(p[2][-1]) for p in parts)
    rng = np.random.default_rng(9)
    bg = (rng.integers(0, 320, n_bg).astype(np.int32),
          rng.integers(0, 320, n_bg).astype(np.int32),
          np.sort(rng.integers(1000, t_end, n_bg)).astype(np.uint32),
          np.ones(n_bg, dtype=np.int32))
    parts.append(bg)
    x = np.concatenate([p[0] for p in parts])
    y = np.concatenate([np.clip(p[1], 0, 319) for p in parts]).astype(np.int32)
    t = np.concatenate([p[2] for p in parts])
    pol = np.concatenate([p[3] for p in parts])
    order = np.argsort(t, kind="stable")
    return EventBatch(x[order].astype(np.int32), y[order],
                      t[order].astype(np.uint32), pol[order])


def oracle_key(ev: EventBatch, cfg: FlowConfig, tag: str) -> str:
    """The cache key of the oracle's run of `ev` under `cfg`: the config
    fields the oracle reads and every event's t, x and y."""
    h = hashlib.sha1(
        (tag + repr((len(ev), cfg.width, cfg.height, cfg.filter_size,
                     cfg.min_evts_on_plane, cfg.max_window, cfg.window_jump,
                     cfg.kill_old_flow_time_us, cfg.det_threshold,
                     cfg.replicate_y_clamp_quirk))).encode())
    for col in (ev.t, ev.x, ev.y):
        h.update(np.ascontiguousarray(col).tobytes())
    return h.hexdigest()[:16]


def oracle_cached(ev: EventBatch, cfg: FlowConfig, tag: str) -> dict:
    """The oracle's columns of `ev` (r_true, theta_true, vx, vy, r_local,
    theta_local, scale), from CACHE_DIR where a run of the same stream
    and config left them, else run and stored there."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR,
                        f"oracle_{tag}_{oracle_key(ev, cfg, tag)}.npz")
    if os.path.exists(path):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    t0 = time.time()
    o = run_oracle(ev, cfg)
    print(f"[oracle {tag}] {len(ev)} events in {time.time() - t0:.1f}s",
          file=sys.stderr, flush=True)
    d = {"r_true": o.r_true, "theta_true": o.theta_true, "vx": o.vx,
         "vy": o.vy, "r_local": o.r_local, "theta_local": o.theta_local,
         "scale": o.scale.astype(np.int32)}
    # written under a private name and renamed, so a reader never sees
    # half a file
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez_compressed(tmp, **d)
    os.replace(tmp, path)
    return d


def metrics(got, orc) -> dict:
    """Error metrics on rows both sides consider flow-valid."""
    ov = orc["r_local"] > 0
    gv = np.asarray(got.r_local) > 0
    both = ov & gv
    n_both = int(both.sum())
    # true (aperture-corrected) flow vectors, px/s
    gtx = np.asarray(got.r_true)[both] * np.cos(np.asarray(got.theta_true)[both])
    gty = np.asarray(got.r_true)[both] * np.sin(np.asarray(got.theta_true)[both])
    otx = orc["r_true"][both] * np.cos(orc["theta_true"][both])
    oty = orc["r_true"][both] * np.sin(orc["theta_true"][both])
    aee_px_ms = float(np.mean(np.hypot(gtx - otx, gty - oty)) / 1e3)
    dot = gtx * otx + gty * oty
    den = np.hypot(gtx, gty) * np.hypot(otx, oty)
    ang = np.degrees(np.arccos(np.clip(dot / np.maximum(den, 1e-30), -1, 1)))
    return {
        "n_valid_oracle": int(ov.sum()),
        "valid_agreement": float((ov == gv).mean()),
        "n_compared": n_both,
        "aee_true_px_per_ms": round(aee_px_ms, 4),
        "ang_err_mean_deg": round(float(ang.mean()), 3),
        "ang_err_p95_deg": round(float(np.percentile(ang, 95)), 3),
        "scale_match": float((np.asarray(got.scale)[both]
                              == orc["scale"][both]).mean()),
    }


def stream_rate(ev: EventBatch) -> float:
    """The stream's mean event rate, events/s."""
    return len(ev) / max(1, int(ev.t[-1]) - int(ev.t[0])) * 1e6


def run_row(ev: EventBatch, orc: dict, *, chunk_size: int, sub_phases: int,
            aperture_sub_phases: int, causal_snapshots: int, correction: int,
            coarse_chain: bool, wire: str = "f16", device="cuda",
            width: int = 320, height: int = 320
            ) -> tuple[dict, FlowOutput, float]:
    """One row of the sweep: the config (8 micro-steps a scan, as the JAX
    sweep's), the port's FlowEngine on `device` over the whole stream, and
    its metrics against the oracle's columns `orc`. Returns (row, the
    engine's output, its process() seconds)."""
    cfg = FlowConfig(width=width, height=height, chunk_size=chunk_size,
                     steps_per_scan=8, sub_phases=sub_phases,
                     aperture_sub_phases=aperture_sub_phases,
                     causal_snapshots=causal_snapshots,
                     center_correction=correction,
                     correction_coarse_chain=coarse_chain, wire=wire)
    eng = FlowEngine(cfg, device=device)
    t0 = time.time()
    got = eng.process(ev)
    dt = time.time() - t0
    row = {"chunk_size": chunk_size, "sub_phases": sub_phases,
           "aperture_sub_phases": aperture_sub_phases,
           "causal_snapshots": causal_snapshots, "correction": correction,
           "coarse_chain": coarse_chain,
           "span_us_per_chunk": round(chunk_size / stream_rate(ev) * 1e6),
           **metrics(got, orc)}
    return row, got, dt


def _skipped(m: int, P: int, AP: int, S: int) -> bool:
    """The JAX sweep's filter of the crossed flags: combinations that
    FlowConfig would refuse."""
    return bool(m % (P * S) or (AP and ((AP % P and P % AP) or m % AP)))


def _merged(results: dict, path: str) -> dict:
    """`results` appended to the output at `path` (same backend, card and
    event count), stream by stream."""
    with open(path) as fh:
        old = json.load(fh)
    same = ("backend", "device", "card", "n_events")
    if any(old.get(k) != results.get(k) for k in same):
        raise ValueError(f"--append: {path} holds another run "
                         f"({ {k: old.get(k) for k in same} })")
    old["runs"] += results["runs"]
    for kind, s in results["streams"].items():
        if kind in old["streams"]:
            old["streams"][kind]["rows"] += s["rows"]
        else:
            old["streams"][kind] = s
    return old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Accuracy sweep of the PyTorch port against the "
                    "float64 oracle")
    ap.add_argument("--stream", nargs="+", default=["bar", "random"])
    ap.add_argument("--n", type=int, default=120_000)
    ap.add_argument("--chunks", nargs="+", type=int, default=list(CHUNKS))
    ap.add_argument("--phases", nargs="+", type=int, default=[1],
                    help="sub_phases values to cross with --chunks "
                         "(FlowConfig.sub_phases)")
    ap.add_argument("--aperture-phases", nargs="+", type=int, default=[0],
                    help="aperture_sub_phases values to cross in "
                         "(0 = coupled to sub_phases)")
    ap.add_argument("--snapshots", nargs="+", type=int, default=[1],
                    help="causal_snapshots values to cross in")
    ap.add_argument("--correction", nargs="+", type=int, default=[0],
                    help="center_correction budgets to cross in "
                         "(0 = off; rank-2 lanes per chunk)")
    ap.add_argument("--coarse-chain", action="store_true",
                    help="correction pass folds phase boundaries only "
                         "(FlowConfig.correction_coarse_chain)")
    ap.add_argument("--wire", default="f16",
                    help="wire format for the engine (the benchmark "
                         "ships f16)")
    ap.add_argument("--out", default="ACCURACY_TORCH.json")
    ap.add_argument("--append", action="store_true",
                    help="add the rows to --out's rows of the same backend "
                         "and event count")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu (the JAX sweep's flag)")
    args = ap.parse_args(argv)

    device = require_device("cpu" if args.cpu else args.device)
    results = {"backend": device.type, "n_events": args.n,
               "runs": [" ".join(argv if argv is not None
                                 else sys.argv[1:])],
               "streams": {}}
    if device.type == "cuda":
        results["device"] = torch.cuda.get_device_name(device)
        results["card"] = card(device)
    print(f"[accuracy] backend {device.type}, card {results.get('card')}",
          flush=True)
    for kind in args.stream:
        ev = make_stream(kind, args.n)
        rate = stream_rate(ev)
        print(f"[{kind}] {len(ev)} events, {rate/1e6:.2f} M ev/s", flush=True)
        orc = oracle_cached(ev, FlowConfig(width=320, height=320), kind)
        rows = []
        for m, P, AP, S, C in itertools.product(
                args.chunks, args.phases, args.aperture_phases,
                args.snapshots, args.correction):
            if _skipped(m, P, AP, S):
                continue
            row, _, dt = run_row(
                ev, orc, chunk_size=m, sub_phases=P, aperture_sub_phases=AP,
                causal_snapshots=S, correction=C,
                coarse_chain=args.coarse_chain, wire=args.wire, device=device)
            rows.append(row)
            print(f"[{kind} m={m} P={P} AP={AP} S={S} C={C}] "
                  f"{json.dumps(row)} ({dt:.1f}s)", flush=True)
        results["streams"][kind] = {"rate_ev_per_s": round(rate),
                                    "rows": rows}

    if args.append and os.path.exists(args.out):
        results = _merged(results, args.out)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

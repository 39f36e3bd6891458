#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its result and seconds:

1. the card (nvidia-smi name and power limit) and the kernel build
   (nvcc, from farms_tpu_torch/csrc, into farms_tpu_torch/_build);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes (320 x 320; local flow at k = 3 and k = 5, aperture
   with 11 scales and once at 260 x 346 with the y-clamp quirk), with both
   median times from CUDA events;
3. chunk_size=1 on the card against the float64 NumPy oracle
   (farms_tpu_torch/pipeline/oracle.py) on a translating-bar stream;
4. the main path through the CLI at the `benchmark` preset on a
   1,048,576-event stream (320 x 320, 5e6 ev/s, seed 0): the kernels'
   launch counts over that run, and agreement with the same CLI run on the
   CPU (plain versions).

The line before the last is the card's nvidia-smi name and power limit;
the one before it a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero,
and without CUDA the script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SENSOR = 320
STREAM_EVENTS = 1 << 20
TIMING_REPS = 30


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _phase(name: str, t0: float, result: str) -> None:
    print(f"[phase {name}] {result} ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def _median_ms(fn, reps: int = TIMING_REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _stamp_surfaces(W: int, H: int, seed: int):
    """Seeded stamp1 surfaces: untouched cells (0), stamps on both sides
    of 2^31 (wrapped-negative int32) and a recently written block."""
    rng = np.random.default_rng(seed)
    touched = rng.random((W, H)) < 0.7
    base = rng.integers(1, 5_000_000, (W, H)).astype(np.uint32)
    base[rng.random((W, H)) < 0.2] += np.uint32(2**31)
    t_pre = np.where(touched, base + 1, 0).astype(np.uint32)
    t_post = t_pre.copy()
    blk = t_post[W // 5:4 * W // 5, H // 8:5 * H // 8]
    t_post[W // 5:4 * W // 5, H // 8:5 * H // 8] = blk + 800 + (blk == 0)
    return t_pre.view(np.int32), t_post.view(np.int32)


def _flow_fields(W: int, H: int, seed: int):
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    fl = (rng.uniform(100, 3000, (W, H)) * mask).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (W, H))
    fvx = (fl * np.cos(ang)).astype(np.float32)
    fvy = (fl * np.sin(ang)).astype(np.float32)
    return fl, fvx, fvy


def _compare(name, got, want, names):
    """Integer outputs must be equal; floats are expected bitwise equal
    (same operation order, -fmad=false). Returns the max abs float diff."""
    import torch
    max_err = 0.0
    for label, g, w in zip(names, got, want):
        if g.dtype.is_floating_point:
            same = torch.equal(g, w) or bool(
                (torch.isnan(g) == torch.isnan(w)).all()
                and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w)))
            diff = (g.double() - w.double()).abs().nan_to_num(0.0)
            max_err = max(max_err, float(diff.max()))
            if not same:
                raise AssertionError(f"{name} {label}: kernel differs from "
                                     f"plain, max abs {float(diff.max())}")
        elif not torch.equal(g, w):
            n = int((g != w).sum())
            raise AssertionError(f"{name} {label}: {n} cells differ")
    return max_err


def check_kernels(dev):
    """Phase 2: each kernel vs its plain version at the main path's shapes."""
    import torch
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.ops import dense_flow as plain
    from farms_tpu_torch.ops import kernels

    results = {}
    local_names = ("accept", "a", "b", "dtdp", "cand")
    for k in (3, 5):
        t0 = time.perf_counter()
        cfg = FlowConfig(width=SENSOR, height=SENSOR, filter_size=k)
        err = 0.0
        for seed in (1, 2):
            t_pre, t_post = _stamp_surfaces(SENSOR, SENSOR, seed + 10 * k)
            chain = torch.from_numpy(t_pre)[None].to(dev)
            center = torch.from_numpy(t_post).to(dev)
            got = kernels.local_flow(chain, center, cfg)
            want = plain.local_flow_core(chain, center, cfg)
            torch.cuda.synchronize()
            err = max(err, _compare(f"local_flow k={k}", got, want,
                                    local_names))
            accepted = int(got[0].sum())
            fitted = int((got[4] >= 0).sum())
        ms = _median_ms(lambda: kernels.local_flow(chain, center, cfg))
        plain_ms = _median_ms(lambda: plain.local_flow_core(chain, center,
                                                            cfg))
        results[f"local_flow_k{k}"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms)
        _phase(f"kernel local_flow k={k}", t0,
               f"equal to plain at {SENSOR}x{SENSOR} (accept {accepted}, "
               f"windows {fitted}); max_abs_err {err}; kernel {ms:.4f} ms, "
               f"plain {plain_ms:.4f} ms")

    ap_names = ("tvx", "tvy", "scale")
    for (W, H, quirk) in ((SENSOR, SENSOR, False), (260, 346, True)):
        t0 = time.perf_counter()
        cfg = FlowConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
        ins = [torch.from_numpy(a).to(dev) for a in _flow_fields(W, H, 3)]
        got = kernels.aperture(*ins, cfg)
        want = plain.dense_aperture(*ins, cfg)
        torch.cuda.synchronize()
        err = _compare(f"aperture {W}x{H}", got, want, ap_names)
        pooled = int((got[2] > 0).sum())
        ms = _median_ms(lambda: kernels.aperture(*ins, cfg))
        plain_ms = _median_ms(lambda: plain.dense_aperture(*ins, cfg))
        if (W, H) == (SENSOR, SENSOR):
            results["aperture"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms)
        _phase(f"kernel aperture {W}x{H} quirk={quirk}", t0,
               f"equal to plain ({cfg.num_scales} scales, {pooled} pixels "
               f"pooled past scale 0); max_abs_err {err}; kernel {ms:.4f} "
               f"ms, plain {plain_ms:.4f} ms")
    return results


def check_oracle(dev):
    """Phase 3: chunk_size=1 on the card reproduces the float64 oracle."""
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.events.io import synthetic_translating_bar
    from farms_tpu_torch.pipeline.engine import FlowEngine
    from farms_tpu_torch.pipeline.oracle import run_oracle

    t0 = time.perf_counter()
    ev = synthetic_translating_bar(width=64, height=64, bar_len=20,
                                   duration_us=30000, speed_px_per_sec=1000,
                                   jitter_us=20, seed=1)[:600]
    ref = run_oracle(ev, FlowConfig(width=64, height=64))
    got = FlowEngine(FlowConfig(width=64, height=64, chunk_size=1,
                                steps_per_scan=32), device=dev).process(ev)
    rv, gv = ref.r_local > 0, got.r_local > 0
    if not (rv == gv).all():
        raise AssertionError(f"oracle: {(rv != gv).sum()} validity flips")
    if not (ref.scale == got.scale).all():
        raise AssertionError(f"oracle: {(ref.scale != got.scale).sum()} "
                             "scale differences")
    if rv.sum() < 100:
        raise AssertionError("oracle: the bar stream produced no flow")
    rl = np.abs(got.r_local[rv] / ref.r_local[rv] - 1).max()
    rt = np.abs(got.r_true[rv] / ref.r_true[rv] - 1).max()
    if rl > 1e-4 or rt > 1e-4:
        raise AssertionError(f"oracle: r_local rel {rl}, r_true rel {rt}")
    _phase("oracle chunk_size=1", t0,
           f"{len(ev)} events, {int(rv.sum())} valid: valid and scale equal "
           f"to the float64 oracle; max rel err r_local {rl:.3g}, "
           f"r_true {rt:.3g}")


def _run_cli(argv):
    from farms_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}:\n{out}")
    rate = re.search(r"with rate of : (\S+) events/sec", out)
    return out, float(rate.group(1))


def check_main_path(work):
    """Phase 4: the benchmark preset through the CLI, card vs CPU."""
    import torch
    from farms_tpu_torch.events.io import (read_flow_txt,
                                           synthetic_random_events,
                                           write_events_txt)
    from farms_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    ev = synthetic_random_events(STREAM_EVENTS, width=SENSOR, height=SENSOR,
                                 rate_hz=5e6, seed=0)
    base = os.path.join(work, "events")
    write_events_txt(ev, base)
    _phase("stream", t0, f"{len(ev)} events written as x y t p text")

    argv = ["--filename", base, "--width", str(SENSOR), "--height",
            str(SENSOR), "--preset", "benchmark"]
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    _, rate = _run_cli(argv)
    launches = dict(kernels.LAUNCHES)
    card = read_flow_txt(base + "_FARMSOut_batch.txt")
    want = 8 * 2      # 8 micro-steps of 131072 events x 2 sub-phases
    if launches != {"local_flow": want, "aperture": want}:
        raise AssertionError(f"launch counts {launches}, expected {want} each")
    if len(card) != len(ev) or not np.isfinite(card.r_true).all():
        raise AssertionError("card output: wrong length or non-finite")
    _phase("cli benchmark cuda", t0,
           f"{len(card)} rows, launches {launches}, "
           f"[Benchmark Main] rate {rate:.1f} events/sec")

    t0 = time.perf_counter()
    _, cpu_rate = _run_cli(argv + ["--device", "cpu"])
    cpu = read_flow_txt(base + "_FARMSOut_batch.txt")
    vc, vg = cpu.r_local > 0, card.r_local > 0
    agree = float((vc == vg).mean())
    both = vc & vg
    scale_eq = float((cpu.scale[both] == card.scale[both]).mean())
    if agree < 0.999 or scale_eq < 0.99 or both.sum() < 1000:
        raise AssertionError(f"card vs cpu: valid agreement {agree}, scale "
                             f"equal {scale_eq} on {both.sum()} lanes")
    _phase("cli benchmark cpu", t0,
           f"valid agreement {agree:.6f} ({int(vg.sum())} valid on the "
           f"card, {int(vc.sum())} on the cpu); scale equal on "
           f"{scale_eq:.6f} of {int(both.sum())} commonly valid lanes; cpu "
           f"rate {cpu_rate:.1f} events/sec")
    return launches, rate


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one GPU",
              file=sys.stderr)
        return 2
    from farms_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _phase("card", t0, f"nvidia-smi: {smi}; torch: {kind}; torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    _phase("build", t0, f"nvcc {' '.join(_build.NVCC_FLAGS)} -> "
           f"{os.path.relpath(lib)}")

    timings = check_kernels(dev)
    check_oracle(dev)
    with tempfile.TemporaryDirectory() as work:
        launches, rate = check_main_path(work)

    entries = [
        dict(name="local_flow", route="cuda",
             source="farms_tpu_torch/csrc/local_flow.cu",
             replaces="farms_tpu/ops/pallas/kernels.py:434",
             launches=launches["local_flow"], **timings["local_flow_k3"]),
        dict(name="aperture", route="cuda",
             source="farms_tpu_torch/csrc/aperture.cu",
             replaces="farms_tpu/ops/pallas/kernels.py:640",
             launches=launches["aperture"], **timings["aperture"]),
    ]
    print(json.dumps({"kernels": entries}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its result and seconds:

1. the card (nvidia-smi name and power limit) and the kernel build
   (one nvcc per source in farms_tpu_torch/csrc, all started together,
   into farms_tpu_torch/_build);
2. each CUDA kernel against its plain PyTorch version on the card, bitwise,
   at the main paths' shapes (320 x 320), with the median times of one
   wrapper call and of one plain call from CUDA events, and the median
   device time of one call from torch.profiler (the sum of every kernel it
   launches): local flow at k = 3 and k = 5, on one surface, on the
   fidelity preset's 8-surface snapshot chain and on a 96-surface chain;
   its correction mode (fold_center=False) at k = 3 and 5 on chains of 3
   (coarse), 17 (full) and 96 surfaces; the general kernel at k = 7 and 9
   in both fold modes on chains of 1 and 9, at k = 7 on 129 surfaces and
   at k = 9 on 96 (longer than the whole-chain tile the earlier general
   kernel staged; the plain version, seconds a call, timed on 3 calls),
   at k = 7 on the 260 x 346 geometry, and at a run-time radius, k = 11
   on 9 surfaces (5 slabs of support rows) and k = 21 in correction mode
   on 3 (14 slabs; the plain version timed on 3 calls), each case with
   the shape the library reports; the float64 integral kernel
   against the plain integral (also on the CPU), with the cells where
   CUDA's own innermost-dimension cumsum departs from the sequential order;
   the aperture pass (integral and pool; the pool's own device time
   beside it) with 11 scales and once at 260 x 346 with the y-clamp quirk;
3. the kernels' halo modes (the row shards of the halo engine,
   farms_tpu_torch/parallel/halo.py) at 320 x 320 cut into 1, 2 and 4
   bands (320, 160 and 80 rows: the shards of `--devices 1`, 2 and 4):
   local flow on each band plus its R exchanged rows (cut from the
   zero-padded surfaces) at k = 3 and 5 on chains of 1 and 8, correction
   mode on a 3-surface chain at k = 3, 5 and 7 and the general kernel at
   k = 7 on one surface; aperture on
   each band of the float64 integral (0 above the sensor, its total row
   below). Each bitwise against its plain halo mode on the card and
   against the rows of the whole-sensor kernel's output, with the same
   times for one interior 80-row band and for the one 320-row band;
4. chunk_size=1 on the card against the float64 NumPy oracle
   (farms_tpu_torch/pipeline/oracle.py) on a translating-bar stream, with
   tests/test_golden.py's asserts: the dense engine, the per-event engine
   (use_dense=False) and the serial engine (pipeline/serial.py), the last
   two with one integral launch per step (per valid event) and no other;
5. the main paths through the CLI on a 1,048,576-event stream (320 x 320,
   5e6 ev/s, seed 0): the `benchmark` preset, the `fidelity` preset
   (snapshot chain, rank-2 correction), the benchmark preset at
   --filtersize 7 on the first 262,144 events and the fidelity preset at
   --filtersize 7 on the first 131,072 (the general kernel on the snapshot
   chain and in correction mode). For each, the kernels'
   launch counts over that run (every count is set to 0 just before it)
   and the same valid flags and scale ids as the same CLI run on the CPU
   (plain versions) on every event;
6. the halo engine through the CLI (`--engine halo --devices 1`, every
   halo mode of every kernel on one card) at both presets on the same
   stream: its launch counts, and an output file equal byte for byte to
   the single engine's card run;
7. with two or more cards, `--engine halo --devices 2` (and 4, with four
   cards) over NCCL at the benchmark preset, each rank on its own card:
   the single engine's output file (phase 6 shows it is one rank's) byte
   for byte on every line but those whose scale id differs at a float64
   tie of the per-scale mean lengths (farms_tpu_torch/pipeline/ties.py on
   the aperture inputs of the single engine's run). With one card it
   prints why it did not run;
8. `--backend perevent --preset benchmark` through the CLI on the same
   stream, card against CPU as in 5: 16 integral launches (8 steps x 2
   phases) and none of the other kernels;
9. `--SERIAL 1 --numEvents 4096` through the CLI on the card and the CPU:
   one `Local` line per event and one `true` line per valid event
   (captured), the [Benchmark Main] line and no output file; then the
   serial engine in-process, card against CPU on every valid flag and
   scale id;
10. rates: FlowEngine.process on the card, per-event against dense, at
   chunks 256, 2048 and 131072 on the stream and chunk 1 on a 4096-event
   cut: events/s and device-busy ms per 1M events (torch.profiler), each
   line with the card's nvidia-smi name and power limit. No bound.

The line before the last is the card's nvidia-smi name and power limit;
the one before it a JSON summary of the kernels, with each kernel's bound
(the larger of the bytes it must move over 3.35 TB/s and its operations
over 67 TFLOP/s in f32 and 34 TFLOP/s in f64, the H100 SXM's data-sheet
peaks) and its share (bound over device time) for its whole-sensor case,
(`halo_*`) for one 80-row band and (`halo1_*`) for the one band of 320
rows;
the last line is {"ok": true, "device": {...}}. Any failure raises and
exits non-zero, and without CUDA the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

SENSOR = 320
STREAM_EVENTS = 1 << 20
K7_EVENTS = 1 << 18
K7_FIDELITY_EVENTS = 1 << 17
SERIAL_EVENTS = 4096        # the serial CLI phase's cut of the stream
# (chunk_size, events, profiled events) of the rates phase
RATE_RUNS = ((1, 4096, 256), (256, STREAM_EVENTS, 16384),
             (2048, STREAM_EVENTS, 131072),
             (131072, STREAM_EVENTS, STREAM_EVENTS))
TIMING_REPS = 30
LONG_PLAIN_REPS = 3         # plain calls timed on the long chains
LOCAL_NAMES = ("accept", "a", "b", "dtdp", "cand")
APERTURE_NAMES = ("tvx", "tvy", "scale")
FLOW_COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
                "r_local", "theta_local", "scale")
NCCL_TIMEOUT = 600          # seconds for one multi-rank CLI run
# each kernel's CUDA source and the Pallas kernel it replaces
# (the integral replaces the XLA cumsum that aperture_pallas runs before
# its Pallas kernel)
KERNEL_SOURCES = {"local_flow": ("local_flow.cu", 434),
                  "local_flow_general": ("local_flow.cu", 171),
                  "aperture": ("aperture.cu", 640),
                  "integral": ("aperture.cu", 733)}
BAND_COUNTS = (1, 2, 4)     # row shards of the halo-mode kernel checks
# NVIDIA H100 SXM data-sheet peaks: HBM bytes/s, f32 and f64 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12


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


def _device_ms(fn, kernel: str | None = None, reps: int = TIMING_REPS):
    """Median device time of one call of fn over reps calls, from
    torch.profiler's device-side events: of the CUDA kernel whose name
    contains `kernel`, or with kernel None of all the device work of a
    call, the sum over the kernels it launches of each one's median (times
    its launches per call). (A CUDA-event interval around one short call
    also holds the wrapper's host time, during which the card waits.) None
    where three traces recorded no such event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # now and then a trace holds no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                    and (kernel is None or kernel in e.name)):
                by_name.setdefault(e.name, []).append(
                    e.self_device_time_total)
        if by_name:
            return sum(float(np.median(t)) * max(1, round(len(t) / reps))
                       for t in by_name.values()) / 1e3
    return None


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _share(r: dict, prefix: str = ""):
    """Bound over device time of a result entry (None where the device
    time was not measured)."""
    ms = r.get(f"{prefix}device_ms")
    return None if not ms else r[f"{prefix}bound_ms"] / ms


def _bound(n_bytes: float, f32_ops: float, f64_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rates."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = f32_ops / PEAK_F32 + f64_ops / PEAK_F64
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def local_flow_bound(k: int, n_chain: int, band_rows: int, rows: int,
                     Ha: int) -> dict:
    """Bound of one local-flow call: it reads the chain and the center
    (int32 [band_rows, Ha] each) once and writes five 4-byte [rows, Ha]
    maps. Its f32 operations per pixel: for each of the 9 candidates, k^2
    cells of (d, sum), a division and a compare; k^2 cells of the winner's
    sums (d, yv, 5 products, 8 sums); 46 for the adjugate solve; k^2 cells
    of the inlier test (d, yv, 2 products, 2 sums, abs, compare). The
    chain fold's compares are integer and not counted."""
    per_pixel = 9 * (2 * k * k + 2) + 15 * k * k + 46 + 8 * k * k
    return _bound((n_chain + 1) * band_rows * Ha * 4 + 5 * rows * Ha * 4,
                  per_pixel * rows * Ha)


def aperture_bound(n_scales: int, rows: int, Ha: int,
                   integ_rows: int = 0) -> dict:
    """Bound of one aperture call. Whole sensor: it reads flow_len, vx and
    vy and writes tvx, tvy and scale (4-byte [rows, Ha] maps each), and
    builds the float64 integral on the way (f32: 3 products and a compare
    per pixel; f64: 2 sums for each of 4 fields). Band mode: it reads the
    float64 band [4, integ_rows, Ha + 1] and flow_vx/vy. Per pixel and
    scale: 4 fields x 3 f64 corner sums; f32: a compare, 3 divisions and a
    compare; one more compare per pixel."""
    px = rows * Ha
    if integ_rows:
        return _bound(4 * integ_rows * (Ha + 1) * 8 + 5 * px * 4,
                      (5 * n_scales + 1) * px, 12 * n_scales * px)
    return _bound(6 * px * 4, (4 + 5 * n_scales + 1) * px,
                  (8 + 12 * n_scales) * px)


def integral_bound(rows: int, cols: int) -> dict:
    """Bound of one integral call: it reads flow_len, vx and vy (4-byte
    [rows, cols] maps) and writes the float64 [4, rows + 1, cols + 1]
    integral; per pixel a compare and 3 products in f32 and, for each of 4
    fields, 2 sums in f64."""
    px = rows * cols
    return _bound(3 * px * 4 + 4 * (rows + 1) * (cols + 1) * 8, 4 * px,
                  8 * px)


def _stamp_surfaces(W: int, H: int, seed: int):
    """Seeded stamp1 surfaces: untouched cells (0), stamps on both sides
    of 2^31 (wrapped-negative int32) and a recently written block."""
    rng = np.random.default_rng(seed)
    touched = rng.random((W, H)) < 0.7
    base = rng.integers(1, 5_000_000, (W, H)).astype(np.uint32)
    base[rng.random((W, H)) < 0.2] += np.uint32(2**31)
    t_pre = np.where(touched, base + 1, 0).astype(np.uint32)
    return t_pre.view(np.int32), _rewrite_block(t_pre).view(np.int32)


def _rewrite_block(t):
    """A later stamp1 surface: a block of t's cells written 800 us on."""
    W, H = t.shape
    sl = (slice(W // 5, 4 * W // 5), slice(H // 8, 5 * H // 8))
    post = t.copy()
    post[sl] = t[sl] + 800 + (t[sl] == 0)
    return post


def _stamp_chain(W: int, H: int, seed: int, n: int):
    """A seeded chain of n stamp1 surfaces (oldest first, stamps past 2^31,
    each rewriting a random half of the cells later; a single-surface
    chain is _stamp_surfaces' pre-scatter surface), a default-mode center
    (the last surface with a block written later, as after a phase's last
    sub-scatter) and a rank-2 center surface a little before the chain's
    last value at a third of the cells (0 elsewhere)."""
    t_pre, _ = _stamp_surfaces(W, H, seed)
    rng = np.random.default_rng(seed)
    surfs = [t_pre.view(np.uint32)]
    for _ in range(n - 1):
        hot = (rng.random((W, H)) < 0.5) & (surfs[-1] != 0)
        step = rng.integers(200, 900, (W, H)).astype(np.uint32)
        surfs.append(np.where(hot, surfs[-1] + step, surfs[-1]))
    last = surfs[-1]
    pick = (rng.random((W, H)) < 0.34) & (last != 0)
    back = rng.integers(1, 400, (W, H)).astype(np.uint32)
    rank2 = np.where(pick, last - back, 0).astype(np.uint32)
    return (np.stack(surfs).view(np.int32),
            _rewrite_block(last).view(np.int32),
            np.ascontiguousarray(rank2.view(np.int32)))


def _flow_fields(W: int, H: int, seed: int):
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    fl = (rng.uniform(100, 3000, (W, H)) * mask).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (W, H))
    fvx = (fl * np.cos(ang)).astype(np.float32)
    fvy = (fl * np.sin(ang)).astype(np.float32)
    return fl, fvx, fvy


def _wide_fields(W: int, H: int, seed: int):
    """Flow surfaces of magnitudes over 2^-30 .. 2^12 at 30 % of the
    pixels: float64 sums of them round, so a summation order shows."""
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    mag = 2.0 ** rng.uniform(-30, 12, (3, W, H))
    sign = np.where(rng.random((3, W, H)) < 0.5, -1.0, 1.0)
    return tuple((mag * sign * mask).astype(np.float32))


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
    """Phase 2: each kernel vs its plain version at the main paths' shapes.

    Returns, for each kernel, the largest max abs error over its cases and
    the median times of its main-path case (local_flow: k = 3; the general
    kernel: k = 7 with one chain surface; aperture: 320 x 320)."""
    import torch
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.ops import dense_flow as plain
    from farms_tpu_torch.ops import kernels

    errs = {name: 0.0 for name in kernels.LAUNCHES}
    results = {}

    def local_case(label, name, cfg, chain, center, fold,
                   plain_reps=TIMING_REPS):
        t0 = time.perf_counter()
        kernels.reset_launches()
        got = kernels.local_flow(chain, center, cfg, fold_center=fold)
        if kernels.LAUNCHES[name] != 1:
            raise AssertionError(f"{label}: launches {kernels.LAUNCHES}")
        want = plain.local_flow_core(chain, center, cfg, fold_center=fold)
        torch.cuda.synchronize()
        err = _compare(label, got, want, LOCAL_NAMES)
        errs[name] = max(errs[name], err)
        def run():
            return kernels.local_flow(chain, center, cfg, fold_center=fold)

        ms = _median_ms(run)
        device_ms = _device_ms(run)
        plain_ms = _median_ms(lambda: plain.local_flow_core(
            chain, center, cfg, fold_center=fold), plain_reps)
        _phase(f"kernel {label}", t0,
               f"equal to plain at {cfg.width}x{cfg.height} (accept "
               f"{int(got[0].sum())}, windows {int((got[4] >= 0).sum())}); "
               f"max_abs_err {err}; kernel {ms:.4f} ms (device "
               f"{_fmt_ms(device_ms)}), plain {plain_ms:.4f} ms; shape "
               f"{kernels.local_flow_shape(cfg.filter_size)}")
        return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms)

    def dev_tensors(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    for k in (3, 5):
        cfg = FlowConfig(width=SENSOR, height=SENSOR, filter_size=k)
        for seed in (1, 2):
            t_pre, t_post = _stamp_surfaces(SENSOR, SENSOR, seed + 10 * k)
            chain, center = dev_tensors(t_pre[None], t_post)
            times = local_case(f"local_flow k={k} seed={seed}", "local_flow",
                               cfg, chain, center, True)
        if k == 3:
            results["local_flow"] = dict(
                times, **local_flow_bound(3, 1, SENSOR, SENSOR, SENSOR))
    # the fidelity slice's modes: the per-phase pass on its 8-surface
    # snapshot chain and correction on the coarse (3) and full (17) chains
    # at k = 3 and 5; the general kernel in both fold modes; chains longer
    # than a whole-chain tile of shared memory held (96 surfaces at k = 3,
    # 5 and 9, 129 at k = 7) in both modes; the general kernel at
    # 260 x 346, and at a run-time radius, the support in slabs of rows
    # (5 at k = 11, 14 at k = 21)
    cases = [(k, n, True, SENSOR, SENSOR) for k in (3, 5) for n in (8, 96)]
    cases += [(k, n, False, SENSOR, SENSOR) for k in (3, 5)
              for n in (3, 17, 96)]
    cases += [(k, n, fold, SENSOR, SENSOR) for k, n in
              ((7, 1), (7, 9), (9, 1), (9, 9), (7, 129), (9, 96))
              for fold in (True, False)]
    cases += [(7, 9, True, 260, 346), (11, 9, True, SENSOR, SENSOR),
              (21, 3, False, SENSOR, SENSOR)]
    for k, n, fold, W, H in cases:
        cfg = FlowConfig(width=W, height=H, filter_size=k)
        surfs, t_post, rank2 = _stamp_chain(W, H, 100 + k + n, n)
        chain, center = dev_tensors(surfs, t_post if fold else rank2)
        name = "local_flow" if k in (3, 5) else "local_flow_general"
        times = local_case(
            f"{name} k={k} chain={n} fold_center={fold} {W}x{H}", name, cfg,
            chain, center, fold,
            LONG_PLAIN_REPS if k > 9 or (k > 5 and n > 9) else TIMING_REPS)
        if (k, n, fold, W) == (7, 1, True, SENSOR):
            results["local_flow_general"] = dict(
                times, **local_flow_bound(7, 1, SENSOR, SENSOR, SENSOR))

    for (W, H, quirk) in ((SENSOR, SENSOR, False), (260, 346, True)):
        t0 = time.perf_counter()
        cfg = FlowConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
        fields = _flow_fields(W, H, 3)
        ins = [torch.from_numpy(a).to(dev) for a in fields]
        # the integral kernel against plain on the card and on the CPU, on
        # the main path's kind of fields and on fields whose float64 sums
        # round; and CUDA's own cumsum over the innermost dimension (a
        # parallel scan) against the sequential order the plain version
        # makes explicit, on the latter
        for arrays in (fields, _wide_fields(W, H, 4)):
            cin = [torch.from_numpy(a) for a in arrays]
            din = [a.to(dev) for a in cin]
            kernels.reset_launches()
            got = kernels.integral(*din)
            if kernels.LAUNCHES["integral"] != 1:
                raise AssertionError(f"integral: launches "
                                     f"{kernels.LAUNCHES}")
            want = plain.build_integral(*din)
            cpu = plain.build_integral(*cin)
            torch.cuda.synchronize()
            bits = [t.view(torch.int64) for t in (got, want)]
            if not torch.equal(*bits) or not torch.equal(
                    bits[0].cpu(), cpu.view(torch.int64)):
                n = int((bits[0].cpu() != cpu.view(torch.int64)).sum())
                raise AssertionError(f"integral {W}x{H}: kernel differs "
                                     f"from plain ({n} cells differ from "
                                     "the cpu)")
        gate = (din[0] > 0).to(torch.float32)
        stack = torch.stack([gate, din[0] * gate, din[1] * gate,
                             din[2] * gate]).to(torch.float64)
        inner = torch.cumsum(torch.cumsum(stack, 1), 2)
        departs = int((inner.view(torch.int64)
                       != want[:, 1:, 1:].contiguous().view(torch.int64))
                      .sum())
        ms = _median_ms(lambda: kernels.integral(*ins))
        device_ms = _device_ms(lambda: kernels.integral(*ins))
        plain_ms = _median_ms(lambda: plain.build_integral(*ins))
        if (W, H) == (SENSOR, SENSOR):
            results["integral"] = dict(ms=ms, device_ms=device_ms,
                                       plain_ms=plain_ms,
                                       **integral_bound(W, H))
        _phase(f"kernel integral {W}x{H}", t0,
               f"equal bit for bit to plain on the card and on the cpu; "
               f"max_abs_err 0.0; on fields whose float64 sums round, "
               f"torch.cumsum over the innermost dimension on the card "
               f"departs from the sequential order in {departs} of "
               f"{inner.numel()} cells; kernel {ms:.4f} ms "
               f"(device {_fmt_ms(device_ms)}), plain {plain_ms:.4f} ms")

        t0 = time.perf_counter()
        got = kernels.aperture(*ins, cfg)
        want = plain.dense_aperture(*ins, cfg)
        torch.cuda.synchronize()
        err = _compare(f"aperture {W}x{H}", got, want, APERTURE_NAMES)
        errs["aperture"] = max(errs["aperture"], err)
        pooled = int((got[2] > 0).sum())
        ms = _median_ms(lambda: kernels.aperture(*ins, cfg))
        device_ms = _device_ms(lambda: kernels.aperture(*ins, cfg))
        pool_ms = _device_ms(lambda: kernels.aperture(*ins, cfg),
                             "aperture_kernel")
        plain_ms = _median_ms(lambda: plain.dense_aperture(*ins, cfg))
        if (W, H) == (SENSOR, SENSOR):
            results["aperture"] = dict(
                ms=ms, device_ms=device_ms, pool_device_ms=pool_ms,
                plain_ms=plain_ms, **aperture_bound(cfg.num_scales, W, H))
        _phase(f"kernel aperture {W}x{H} quirk={quirk}", t0,
               f"equal to plain ({cfg.num_scales} scales, {pooled} pixels "
               f"pooled past scale 0); max_abs_err {err}; kernel {ms:.4f} "
               f"ms (device: the pass {_fmt_ms(device_ms)}, its pool "
               f"{_fmt_ms(pool_ms)}), plain {plain_ms:.4f} ms")
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        r["share"] = _share(r)
    return results


def _band(arr, nb: int, i: int, h: int):
    """Band i of nb over the rows of a [..., W, H] array: its rows and h
    more on each side, zero past the sensor edge (what exchange_halo gives
    each of nb ranks)."""
    rows = arr.shape[-2] // nb
    pad = [(0, 0)] * (arr.ndim - 2) + [(h, h), (0, 0)]
    return np.ascontiguousarray(
        np.pad(arr, pad)[..., i * rows:i * rows + rows + 2 * h, :])


def check_halo_kernels(dev):
    """Phase 3: the kernels' halo modes on 1, 2 and 4 row bands at 320 x
    320.

    Each band's kernel output must equal the plain halo mode's on the
    card and the rows of the whole-sensor kernel's output bitwise: the
    band holds the values the whole-sensor zero pad (or, for the
    aperture, the whole integral) holds, read in the same order. Returns,
    for each kernel, the median times and bound of its main case on one
    interior 80-row band (band 1 of 4) and, prefixed `1_`, on the one band
    of 320 rows, and the largest max abs error."""
    import torch
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.ops import dense_flow as plain
    from farms_tpu_torch.ops import kernels

    errs = {name: 0.0 for name in kernels.LAUNCHES}
    results = {}

    def band_case(label, name, run_kernel, run_plain, whole, names):
        """run_*(nb, i) computes band i of nb; whole is the whole-sensor
        output. Returns {nb: times} for the timed bands."""
        t0 = time.perf_counter()
        for nb in BAND_COUNTS:
            rows = SENSOR // nb
            for i in range(nb):
                kernels.reset_launches()
                got = run_kernel(nb, i)
                if kernels.LAUNCHES[name] != 1 or sum(
                        kernels.LAUNCHES.values()) != 1:
                    raise AssertionError(f"{label} band {i} of {nb}: "
                                         f"launches {kernels.LAUNCHES}")
                want = run_plain(nb, i)
                torch.cuda.synchronize()
                errs[name] = max(errs[name], _compare(
                    f"{label} band {i} of {nb}", got, want, names))
                _compare(f"{label} band {i} of {nb} vs whole-sensor rows",
                         got, [w[i * rows:(i + 1) * rows] for w in whole],
                         names)
        times, said = {}, []
        for nb, i in ((4, 1), (1, 0)):
            ms = _median_ms(lambda: run_kernel(nb, i))
            device_ms = _device_ms(lambda: run_kernel(nb, i))
            plain_ms = _median_ms(lambda: run_plain(nb, i))
            times[nb] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms)
            said.append(f"{SENSOR // nb}-row band kernel {ms:.4f} ms "
                        f"(device {_fmt_ms(device_ms)}), plain "
                        f"{plain_ms:.4f} ms")
        _phase(f"halo kernel {label}", t0,
               f"bands of {', '.join(str(SENSOR // nb) for nb in BAND_COUNTS)}"
               f" rows equal to the plain halo mode and to the whole-sensor "
               f"rows; max_abs_err {errs[name]}; {'; '.join(said)}")
        return times

    def timed(name, times, bound):
        """The result entry of a main case: 80-row band times and bound,
        then the 320-row band's, prefixed 1_."""
        entry = dict(times[4], **bound(SENSOR // 4))
        entry.update({f"1_{k}": v for k, v in
                      dict(times[1], **bound(SENSOR)).items()})
        results[name] = entry

    cases = [(k, n, True) for k in (3, 5) for n in (1, 8)]
    cases += [(k, 3, False) for k in (3, 5, 7)] + [(7, 1, True)]
    for k, n, fold in cases:
        cfg = FlowConfig(width=SENSOR, height=SENSOR, filter_size=k)
        R = cfg.support_radius
        surfs, t_post, rank2 = _stamp_chain(SENSOR, SENSOR, 200 + k + n, n)
        center = t_post if fold else rank2
        whole = kernels.local_flow(
            *(torch.from_numpy(a).to(dev) for a in (surfs, center)), cfg,
            fold_center=fold)
        bands = {nb: [[torch.from_numpy(_band(a, nb, i, R)).to(dev)
                       for a in (surfs, center)] for i in range(nb)]
                 for nb in BAND_COUNTS}
        name = "local_flow" if k in (3, 5) else "local_flow_general"

        def run(fn, nb, i, cfg=cfg, R=R, fold=fold, bands=bands):
            return fn(*bands[nb][i], cfg, fold_center=fold, halo=R,
                      row_offset=i * (SENSOR // nb))

        times = band_case(
            f"{name} k={k} chain={n} fold_center={fold}", name,
            lambda nb, i, run=run: run(kernels.local_flow, nb, i),
            lambda nb, i, run=run: run(plain.local_flow_core, nb, i), whole,
            LOCAL_NAMES)
        if n == 1 and fold and k in (3, 7):
            timed(name, times, lambda rows, k=k, R=R: local_flow_bound(
                k, 1, rows + 2 * R, rows, SENSOR))

    cfg = FlowConfig(width=SENSOR, height=SENSOR)
    A = cfg.max_window + 1
    ins = [torch.from_numpy(a).to(dev) for a in _flow_fields(SENSOR, SENSOR,
                                                               6)]
    whole = kernels.aperture(*ins, cfg)
    integ = plain.build_integral(*ins)
    full = torch.cat([torch.zeros_like(integ[:, :A]), integ,
                      integ[:, -1:].expand(-1, A, -1)], 1)
    ap_bands = {}
    for nb in BAND_COUNTS:
        rows = SENSOR // nb
        ap_bands[nb] = [
            ([a[i * rows:(i + 1) * rows] for a in ins],
             full[:, i * rows:(i + 1) * rows + 2 * A + 1].contiguous())
            for i in range(nb)]

    def run_ap(fn, nb, i):
        core, band = ap_bands[nb][i]
        return fn(*core, cfg, halo=A, integ=band)

    times = band_case("aperture band", "aperture",
                      lambda nb, i: run_ap(kernels.aperture, nb, i),
                      lambda nb, i: run_ap(plain.dense_aperture, nb, i),
                      whole, APERTURE_NAMES)
    timed("aperture", times, lambda rows: aperture_bound(
        cfg.num_scales, rows, SENSOR, rows + 2 * A + 1))
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        r["share"] = _share(r)
        r["1_share"] = _share(r, "1_")
    return results


def _assert_oracle(label, ref, got):
    """tests/test_golden.py:44-60's asserts: valid flags, scale ids and t
    equal to the float64 oracle's, r_local and r_true within 1e-4
    relative, the true flow's angle within 0.01 degrees. Returns the
    largest errors."""
    rv, gv = ref.r_local > 0, got.r_local > 0
    if not (rv == gv).all():
        raise AssertionError(f"{label}: {(rv != gv).sum()} validity flips")
    if not (ref.scale == got.scale).all():
        raise AssertionError(f"{label}: {(ref.scale != got.scale).sum()} "
                             "scale differences")
    if not (ref.t == got.t).all() or rv.sum() < 100:
        raise AssertionError(f"{label}: stamps differ or the bar stream "
                             "produced no flow")
    rl = np.abs(got.r_local[rv] / ref.r_local[rv] - 1).max()
    rt = np.abs(got.r_true[rv] / ref.r_true[rv] - 1).max()
    ang = np.degrees(np.abs(np.angle(np.exp(
        1j * (ref.theta_true[rv] - got.theta_true[rv]))))).max()
    if rl > 1e-4 or rt > 1e-4 or ang >= 0.01:
        raise AssertionError(f"{label}: r_local rel {rl}, r_true rel {rt}, "
                             f"angle {ang} deg")
    return rl, rt, ang


def check_oracle(dev):
    """Phase 4: chunk_size=1 on the card reproduces the float64 oracle:
    the dense engine, the per-event engine (use_dense=False) and the serial
    engine. The per-event paths run one integral launch per micro-step
    (the last call's padding steps too) or, in serial mode, per valid
    event, and no other kernel."""
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.events.io import synthetic_translating_bar
    from farms_tpu_torch.pipeline.engine import FlowEngine, call_steps
    from farms_tpu_torch.pipeline.oracle import run_oracle
    from farms_tpu_torch.pipeline.serial import SerialFlowEngine

    ev = synthetic_translating_bar(width=64, height=64, bar_len=20,
                                   duration_us=30000, speed_px_per_sec=1000,
                                   jitter_us=20, seed=1)[:600]
    ref = run_oracle(ev, FlowConfig(width=64, height=64))
    n_valid = int((ref.r_local > 0).sum())
    cfg = FlowConfig(width=64, height=64, chunk_size=1, steps_per_scan=32)
    spc = call_steps(cfg)
    runs = (
        ("oracle chunk_size=1", None,
         lambda: FlowEngine(cfg, device=dev).process(ev)),
        ("oracle perevent chunk_size=1",
         {"integral": -(-len(ev) // spc) * spc},
         lambda: FlowEngine(dataclasses.replace(cfg, use_dense=False),
                            device=dev).process(ev)),
        ("oracle serial", {"integral": n_valid},
         lambda: SerialFlowEngine(cfg, device=dev).run(ev, quiet=True)[0]))
    for label, want, run in runs:
        t0 = time.perf_counter()
        if want is None:
            got, launches = run(), "not counted"
        else:
            got, launches = _counted(label, run, want)
        rl, rt, ang = _assert_oracle(label, ref, got)
        _phase(label, t0,
               f"{len(ev)} events, {n_valid} valid: valid, scale and t equal "
               f"to the float64 oracle; max rel err r_local {rl:.3g}, "
               f"r_true {rt:.3g}; max angle err {ang:.3g} deg; launches "
               f"{launches}")


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


def _counted(label, run, want_launches):
    """run() with every kernel's launch count set to 0 just before it;
    the counts it leaves must be want_launches (0 for a kernel not
    named). Returns (run's result, the counts)."""
    import torch
    from farms_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    result = run()
    launches = dict(kernels.LAUNCHES)
    want = {k: want_launches.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, expected "
                             f"{want}")
    return result, launches


def _cli_path(label, argv, base, n_events, want_launches, keep=None):
    """One main path through the CLI on the card, then on the CPU: the
    kernels' launch counts over the card's run and card vs CPU agreement.
    The card's output file is copied to `keep` if given. Returns
    (launches, rate)."""
    from farms_tpu_torch.events.io import read_flow_txt

    t0 = time.perf_counter()
    (_, rate), launches = _counted(label, lambda: _run_cli(argv),
                                   want_launches)
    if keep:
        shutil.copyfile(base + "_FARMSOut_batch.txt", keep)
    card = read_flow_txt(base + "_FARMSOut_batch.txt")
    if len(card) != n_events or not np.isfinite(card.r_true).all():
        raise AssertionError(f"{label}: card output has {len(card)} rows "
                             "or non-finite values")
    _phase(f"cli {label} cuda", t0,
           f"{len(card)} rows, launches {launches}, "
           f"[Benchmark Main] rate {rate:.1f} events/sec")

    t0 = time.perf_counter()
    _, cpu_rate = _run_cli(argv + ["--device", "cpu"])
    cpu = read_flow_txt(base + "_FARMSOut_batch.txt")
    vc, vg = cpu.r_local > 0, card.r_local > 0
    agree = float((vc == vg).mean())
    both = vc & vg
    scale_eq = float((cpu.scale[both] == card.scale[both]).mean())
    # the kernels are bitwise equal to the plain versions, so the card
    # must reproduce the CPU's valid flags and scale ids on every lane
    if agree != 1.0 or scale_eq != 1.0 or both.sum() < 1000:
        raise AssertionError(f"{label} card vs cpu: valid agreement "
                             f"{agree}, scale equal {scale_eq} on "
                             f"{both.sum()} lanes")
    _phase(f"cli {label} cpu", t0,
           f"valid agreement {agree:.6f} ({int(vg.sum())} valid on the "
           f"card, {int(vc.sum())} on the cpu); scale equal on "
           f"{scale_eq:.6f} of {int(both.sum())} commonly valid lanes; cpu "
           f"rate {cpu_rate:.1f} events/sec")
    return launches, rate


def write_stream(work) -> str:
    """The CLI phases' 1,048,576-event stream (320 x 320, 5e6 ev/s, seed
    0) as x y t p text in `work`; returns its base path."""
    from farms_tpu_torch.events.io import (synthetic_random_events,
                                           write_events_txt)

    t0 = time.perf_counter()
    ev = synthetic_random_events(STREAM_EVENTS, width=SENSOR, height=SENSOR,
                                 rate_hz=5e6, seed=0)
    base = os.path.join(work, "events")
    write_events_txt(ev, base)
    _phase("stream", t0, f"{len(ev)} events written as x y t p text")
    return base


def _stream_argv(base, preset):
    return ["--filename", base, "--width", str(SENSOR), "--height",
            str(SENSOR), "--preset", preset]


def _preset_launches(steps):
    """Launches of `steps` micro-steps at each preset: 2 sub-phases per
    step, each a local-flow and an aperture pass (an integral and a pool);
    the fidelity preset adds one correction-mode local-flow pass per
    step."""
    ap = {"aperture": 2 * steps, "integral": 2 * steps}
    return {"benchmark": {"local_flow": 2 * steps, **ap},
            "fidelity": {"local_flow": 3 * steps, **ap}}


def check_main_paths(base, work):
    """Phase 5: the benchmark and fidelity presets, and both at
    --filtersize 7 on a cut stream, through the CLI, card vs CPU. Returns
    ({label: (launches, rate)}, {preset: copy of the card's output
    file})."""
    steps = STREAM_EVENTS // 131072          # micro-steps at chunk 131072
    results, card_files = {}, {}
    for preset, want in _preset_launches(steps).items():
        card_files[preset] = os.path.join(work, f"single_{preset}.txt")
        results[preset] = _cli_path(preset, _stream_argv(base, preset), base,
                                    STREAM_EVENTS, want, card_files[preset])
    # the general kernel's paths on cut streams (a call at chunk 131072
    # holds one micro-step, so no step is padding)
    for preset, n_events in (("benchmark", K7_EVENTS),
                             ("fidelity", K7_FIDELITY_EVENTS)):
        want = _preset_launches(n_events // 131072)[preset]
        want["local_flow_general"] = want.pop("local_flow")
        label = f"{preset} k=7"
        results[label] = _cli_path(
            label, _stream_argv(base, preset) + [
                "--filtersize", "7", "--numEvents", str(n_events)],
            base, n_events, want)
    return results, card_files


def check_halo_paths(base, card_files):
    """Phase 6: `--engine halo --devices 1` through the CLI at both
    presets on the card: every halo mode of every kernel. Its launch
    counts, and its output file equal byte for byte to the single
    engine's card run (at one rank the bands hold the whole sensor's
    values and the band integral is the whole float64 integral).
    Returns {label: (launches, rate)}."""
    from farms_tpu_torch.events.io import read_flow_txt

    steps = STREAM_EVENTS // 131072
    results = {}
    for preset, want in _preset_launches(steps).items():
        label = f"halo {preset}"
        argv = _stream_argv(base, preset) + ["--engine", "halo",
                                             "--devices", "1"]
        t0 = time.perf_counter()
        (_, rate), launches = _counted(label, lambda: _run_cli(argv), want)
        out = base + "_FARMSOut_batch.txt"
        if not filecmp.cmp(out, card_files[preset], shallow=False):
            got, ref = read_flow_txt(out), read_flow_txt(card_files[preset])
            diff = (f"{len(got)} rows, not {len(ref)}" if len(got) != len(ref)
                    else {c: int((getattr(got, c) != getattr(ref, c)).sum())
                          for c in FLOW_COLUMNS})
            raise AssertionError(f"{label}: output differs from the single "
                                 f"engine's card run: {diff}")
        _phase(f"cli {label} cuda", t0,
               f"launches {launches}; output file equal byte for byte to "
               f"the single engine's card run; [Benchmark Main] rate "
               f"{rate:.1f} events/sec")
        results[label] = (launches, rate)
    return results


def _cli_process(argv):
    """The CLI in a process of its own, whose ranks are its children:
    returns its [Benchmark Main] rate. On a timeout its whole process
    group is killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "farms_tpu_torch.cli", *argv], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=NCCL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"cli exited {proc.returncode}:\n{out}\n{err}")
    return float(re.search(r"with rate of : (\S+) events/sec",
                           out).group(1))


def check_nccl(base, work):
    """Phase 7: `--engine halo --devices N` over NCCL (N = 2, and 4 with
    four cards) at the benchmark preset, against the single engine's run
    on cuda:0 (phase 6 shows one rank's output is that run's): its output
    file byte for byte on every line whose scale id is the single
    engine's, and scale ids that differ only at float64 ties. Returns
    {label: rate}; with fewer than two cards it prints why it did not
    run."""
    import torch
    from farms_tpu_torch import cli
    from farms_tpu_torch.events.io import (load_events_txt, read_flow_txt,
                                           write_flow_txt)
    from farms_tpu_torch.ops import kernels
    from farms_tpu_torch.pipeline.engine import FlowEngine
    from farms_tpu_torch.pipeline.ties import scale_ties

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[phase nccl] not run: `--engine halo --devices 2` over NCCL "
              f"needs 2 CUDA devices, this machine has {cards}", flush=True)
        return {}
    t0 = time.perf_counter()
    argv = _stream_argv(base, "benchmark")
    args = cli.build_parser().parse_args(argv)
    cfg = cli.build_config(args)
    ev = load_events_txt(base, args.num_events, layout=args.layout,
                         time_unit=args.time_unit)
    passes = []
    aperture = kernels.aperture

    def recording(flow_len, *a, **kw):
        passes.append(flow_len.clone())
        return aperture(flow_len, *a, **kw)

    kernels.aperture = recording
    try:
        single = FlowEngine(cfg, device="cuda").process(ev)
    finally:
        kernels.aperture = aperture
    ref_file = write_flow_txt(single, os.path.join(work, "nccl"))
    ref = read_flow_txt(ref_file)
    with open(ref_file) as fh:
        ref_lines = fh.readlines()
    _phase("nccl reference", t0, f"the single engine on cuda:0, "
           f"{int((ref.r_local > 0).sum())} valid of {len(ref)}; "
           f"{len(passes)} aperture inputs kept for the tie test")
    rates = {}
    for n in (2, 4):
        if n > cards:
            break
        t0 = time.perf_counter()
        rate = _cli_process(argv + ["--engine", "halo", "--devices", str(n)])
        out = base + "_FARMSOut_batch.txt"
        with open(out) as fh:
            lines = fh.readlines()
        if len(lines) != len(ref_lines):
            raise AssertionError(f"nccl devices={n}: {len(lines)} rows")
        got = read_flow_txt(out)
        differ = ref.scale != got.scale
        tied = differ & scale_ties(ref, got, passes, cfg)
        if (differ & ~tied).any():
            raise AssertionError(f"nccl devices={n}: {(differ & ~tied).sum()}"
                                 " scale ids differ off float64 ties")
        other = np.array([a != b for a, b in zip(lines, ref_lines)])
        if (other & ~differ).any():
            raise AssertionError(
                f"nccl devices={n}: {(other & ~differ).sum()} lines with "
                "the single engine's scale id differ from its output file")
        _phase(f"nccl halo devices={n}", t0,
               f"output file equal byte for byte to the single engine's on "
               f"{int((~other).sum())} of {len(ref)} lines; the other "
               f"{int(other.sum())} differ in the scale id, {int(tied.sum())}"
               f" float64 ties of {int(differ.sum())} scale differences; "
               f"[Benchmark Main] rate {rate:.1f} events/sec")
        rates[f"halo benchmark devices={n}"] = rate
    return rates


def check_perevent_cli(base):
    """`--backend perevent --preset benchmark` through the CLI on the
    card and the CPU: the per-event path runs the integral kernel once a
    phase (8 steps x 2 phases) and no other kernel. Returns (launches,
    rate)."""
    steps = STREAM_EVENTS // 131072
    return _cli_path("perevent benchmark",
                     _stream_argv(base, "benchmark") + ["--backend",
                                                        "perevent"],
                     base, STREAM_EVENTS, {"integral": 2 * steps})


def check_serial_cli(base, dev):
    """`--SERIAL 1 --numEvents 4096` through the CLI on the card and the
    CPU: one `Local` line per event and one `true` line per valid event
    (captured, not echoed), the [Benchmark Main] line, no output file, and
    one integral launch per valid event on the card. Then the serial
    engine in-process on the card and the CPU: valid flags and scale ids
    equal on every event. Returns (launches, rate)."""
    import torch
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.events.io import load_events_txt
    from farms_tpu_torch.ops import kernels
    from farms_tpu_torch.pipeline.serial import SerialFlowEngine

    out_file = base + "_FARMSOut_batch.txt"
    argv = ["--filename", base, "--width", str(SENSOR), "--height",
            str(SENSOR), "--SERIAL", "1", "--numEvents", str(SERIAL_EVENTS)]
    said = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if os.path.exists(out_file):
            os.remove(out_file)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out, rate = _run_cli(argv + ["--device", device])
        launches = dict(kernels.LAUNCHES)
        words = [ln.split()[:1] for ln in out.splitlines()]
        n_local, n_true = words.count(["Local"]), words.count(["true"])
        want = {k: 0 for k in launches}
        if device == "cuda":
            want["integral"] = n_true
        if (n_local != SERIAL_EVENTS or not n_true or launches != want
                or os.path.exists(out_file)
                or out.count("[Benchmark Main]") != 1):
            raise AssertionError(
                f"serial cli {device}: {n_local} Local and {n_true} true "
                f"lines, launches {launches}, output file written: "
                f"{os.path.exists(out_file)}")
        said[device] = (n_true, launches, rate)
        _phase(f"cli serial {device}", t0,
               f"{n_local} Local lines, {n_true} true lines, no output "
               f"file; launches {launches}; [Benchmark Main] rate "
               f"{rate:.1f} events/sec")
    if said["cuda"][0] != said["cpu"][0]:
        raise AssertionError(f"serial cli: {said['cuda'][0]} valid events "
                             f"on the card, {said['cpu'][0]} on the cpu")
    t0 = time.perf_counter()
    ev = load_events_txt(base, SERIAL_EVENTS)
    cfg = FlowConfig(width=SENSOR, height=SENSOR, chunk_size=1)
    card, cpu = (SerialFlowEngine(cfg, device=d).run(ev, quiet=True)[0]
                 for d in (dev, "cpu"))
    vg, vc = card.r_local > 0, cpu.r_local > 0
    if (vg != vc).any() or (card.scale != cpu.scale).any() or not vg.any():
        raise AssertionError(f"serial engine card vs cpu: {(vg != vc).sum()}"
                             f" valid flags, {(card.scale != cpu.scale).sum()}"
                             " scale ids differ")
    if not np.isfinite(card.r_true).all():
        raise AssertionError("serial engine: non-finite r_true on the card")
    _phase("serial engine card vs cpu", t0,
           f"{len(ev)} events, {int(vg.sum())} valid: valid flags and scale "
           f"ids equal on every event")
    return said["cuda"][1], said["cuda"][2]


def _busy_ms(fn) -> float:
    """Device-busy milliseconds of one call of fn: the sum of the device
    times of every kernel and copy it ran, from torch.profiler (one
    stream, so they do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation)
    if not busy:
        raise AssertionError("torch.profiler recorded no device time")
    return busy / 1e3


def check_rates(base, smi):
    """The per-event path against the dense path on the card (both at 2
    sub-phases and the f16 wire; one phase at chunk 1): events/s of a
    warmed FlowEngine.process over the stream (a 4096-event cut at chunk
    1), and device-busy ms per 1M events from torch.profiler over the
    first `profiled` events of a fresh run. No bound: a failed run fails
    the smoke. Returns {label: events/s}."""
    import torch
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.events.io import load_events_txt
    from farms_tpu_torch.pipeline.engine import FlowEngine

    ev = load_events_txt(base)
    rates = {}
    print(f"[rates] card: {smi}", flush=True)
    for chunk, n_events, profiled in RATE_RUNS:
        part = ev[:n_events]
        said = []
        for path in ("perevent", "dense"):
            t0 = time.perf_counter()
            cfg = FlowConfig(width=SENSOR, height=SENSOR, chunk_size=chunk,
                             sub_phases=1 if chunk == 1 else 2, wire="f16",
                             use_dense=path == "dense")
            eng = FlowEngine(cfg, device="cuda")
            eng.process(part[:2 * chunk])            # warm-up
            eng.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = eng.process(part)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            if len(out) != n_events or not np.isfinite(out.r_true).all():
                raise AssertionError(f"rates {path} chunk {chunk}: bad "
                                     "output")
            eng.reset()
            busy = _busy_ms(lambda: eng.process(part[:profiled]))
            per_m = busy * (1 << 20) / profiled
            rate = n_events / wall
            wall_m = wall * 1e3 * (1 << 20) / n_events
            rates[f"{path} chunk={chunk}"] = rate
            said.append(f"{path} {rate:.1f} events/s ({n_events} events in "
                        f"{wall:.3f} s), device busy {per_m:.3f} ms per 1M "
                        f"events ({busy:.3f} ms over {profiled} events; "
                        f"busy {100 * per_m / wall_m:.1f} % of the timed "
                        "wall time)")
            _phase(f"rates {path} chunk={chunk}", t0, said[-1])
        print(f"[rates] chunk={chunk}: {'; '.join(said)}; card {smi}",
              flush=True)
    return rates


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
    _phase("card", t0, f"nvidia-smi: {smi}; torch: {kind} x "
           f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    _phase("build", t0, f"{len(_build.SOURCES)} sources, one nvcc "
           f"{' '.join(_build.NVCC_FLAGS)} -c each, in parallel -> "
           f"{os.path.relpath(lib)}")

    timings = check_kernels(dev)
    halo_timings = check_halo_kernels(dev)
    check_oracle(dev)
    with tempfile.TemporaryDirectory() as work:
        base = write_stream(work)
        paths, card_files = check_main_paths(base, work)
        paths.update(check_halo_paths(base, card_files))
        rates = check_nccl(base, work)
        paths["perevent benchmark"] = check_perevent_cli(base)
        paths["serial"] = check_serial_cli(base, dev)
        path_rates = check_rates(base, smi)
    rates.update({label: rate for label, (_, rate) in paths.items()})
    entries = []
    for name, (src, line) in KERNEL_SOURCES.items():
        by_path = {label: counts[name]
                   for label, (counts, _) in paths.items()}
        halo = {f"halo{k}" if k.startswith("1_") else f"halo_{k}": v
                for k, v in halo_timings.get(name, {}).items()}
        entries.append(dict(
            name=name, route="cuda",
            source=f"farms_tpu_torch/csrc/{src}",
            replaces=f"farms_tpu/ops/pallas/kernels.py:{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            library_ms=None, **timings[name], **halo))
    print(f"[rates] [Benchmark Main] events/sec by path: {rates}")
    print(f"[rates] FlowEngine.process events/sec, per-event and dense: "
          f"{path_rates}")
    print(json.dumps({"kernels": entries}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its result and seconds:

1. the card (nvidia-smi name and power limit), the kernel build (one
   nvcc per source in farms_tpu_torch/csrc, all started together, into
   farms_tpu_torch/_build) and the native I/O library's (one g++ of
   native/fast_io.cpp into the same directory);
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
6. the halo, dp and multihost engines through the CLI at one rank
   (`--engine halo|dp|multihost --devices 1`: every halo mode of every
   kernel; the single engine's micro_step on one rank's event shard) at
   both presets on the same stream: their launch counts, and output files
   equal byte for byte to the single engine's card run;
7. the single engine on a padded array geometry (320 x 320 in 324 x 328
   arrays) at the benchmark preset on the first 262,144 events: launch
   counts, every column bitwise equal to the unpadded engine's, and the
   CPU's valid flags and scale ids on every event;
8. with two or more cards, over NCCL with each rank on its own card, at
   the benchmark preset against the single engine's run on cuda:0:
   `--engine dp --devices 2` (and 4) byte for byte, `--engine halo
   --devices 2` (and 4) byte for byte on every line but those whose scale
   id differs at a float64 tie of the per-scale mean lengths
   (farms_tpu_torch/pipeline/ties.py on the aperture inputs of the single
   engine's run); with four cards a (2, 2) multihost world launched the
   --multihost way (four processes of this script with a launcher's
   environment, two "hosts" of two cards) whose CLI file and
   write_flow_distributed file (the output all-gather made to raise) are
   held as halo's; then [rates] of the single engine and of dp and
   multihost at 2 and 4 ranks, and the benchmark harness's config 5
   (the halo engine's process_resident over every card). With
   one card it prints why it did not run (`--nccl-only` runs this phase
   alone, after the build);
9. `--backend perevent --preset benchmark` through the CLI on the same
   stream, card against CPU as in 5: 16 integral launches (8 steps x 2
   phases) and none of the other kernels;
10. `--SERIAL 1 --numEvents 4096` through the CLI on the card and the CPU:
   one `Local` line per event and one `true` line per valid event
   (captured), the [Benchmark Main] line and no output file; then the
   serial engine in-process, card against CPU on every valid flag and
   scale id;
11. rates: FlowEngine.process on the card, per-event against dense, at
   chunks 2048 and 131072 on the stream, chunk 256 on its first 131,072
   events and chunk 1 on its first 1,024; and the single, dp and
   multihost engines at one rank at both presets: events/s and
   device-busy ms per 1M events (torch.profiler), each line with the
   card's nvidia-smi name and power limit. No bound;
12. native I/O: the CLI paths of 5 parsed, packed and wrote through the
   native library; on the stream, parse, pack2 (benchmark preset) and
   write native and NumPy, equal bit for bit or byte for byte, with their
   host seconds;
13. events/stream.process_file_streaming at the benchmark preset: the
   stream in chunks of 262,144 events written byte for byte as the CLI's
   one-shot file of 5, and its first 262,144 events in chunks of 100,000
   with the CPU's valid flags and scale ids; launch counts;
14. `--wire sparse` through the CLI, its file byte for byte the `--wire
   f16` file of 5, with the device-to-host bytes per event of both wires
   and the events/s of a warmed process() on each;
15. FlowEngine.process_resident (the explicit 5-row layout) at both
   presets: launch counts, every column bit for bit equal to process(),
   a replay from its start state equal to the first run;
16. the benchmark harness (farms_tpu_torch/bench/harness.py) configs 1-4,
   each JSON line with the card's name and power limit and the kernels
   it launched.

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
RATE_RUNS = ((1, 1024, 64), (256, 131072, 4096),
             (2048, STREAM_EVENTS, 32768),
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


def _library_integral(flow_len, flow_vx, flow_vy):
    """The float64 integral by library calls: the gated fields, then
    torch.cumsum over both axes (CUDA's own scan order), zero-padded to
    [4, W + 1, H + 1]."""
    import torch
    gate = (flow_len > 0).to(torch.float32)
    stack = torch.stack([gate, flow_len * gate, flow_vx * gate,
                         flow_vy * gate]).to(torch.float64)
    return torch.nn.functional.pad(
        torch.cumsum(torch.cumsum(stack, 1), 2), (1, 0, 1, 0))


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
        library_ms = _median_ms(lambda: _library_integral(*ins))
        if (W, H) == (SENSOR, SENSOR):
            results["integral"] = dict(ms=ms, device_ms=device_ms,
                                       plain_ms=plain_ms,
                                       library_ms=library_ms,
                                       **integral_bound(W, H))
        _phase(f"kernel integral {W}x{H}", t0,
               f"equal bit for bit to plain on the card and on the cpu; "
               f"max_abs_err 0.0; on fields whose float64 sums round, "
               f"torch.cumsum over the innermost dimension on the card "
               f"departs from the sequential order in {departs} of "
               f"{inner.numel()} cells; kernel {ms:.4f} ms "
               f"(device {_fmt_ms(device_ms)}), plain {plain_ms:.4f} ms, "
               f"library (torch.cumsum over both axes, float64) "
               f"{library_ms:.4f} ms")

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


def check_engine_paths(base, card_files):
    """Phase 6: `--engine halo --devices 1` (every halo mode of
    every kernel on one card), then `--engine dp --devices 1` and
    `--engine multihost --devices 1` (the single engine's micro_step on
    the event shard of one rank), through the CLI at both presets on the
    card. Each one's launch counts, and its output file equal byte for
    byte to the single engine's card run (at one rank the bands hold the
    whole sensor's values and the band integral is the whole float64
    integral). Returns {label: (launches, rate)}."""
    from farms_tpu_torch.events.io import read_flow_txt

    steps = STREAM_EVENTS // 131072
    results = {}
    for engine in ("halo", "dp", "multihost"):
        for preset, want in _preset_launches(steps).items():
            label = f"{engine} {preset}"
            argv = _stream_argv(base, preset) + ["--engine", engine,
                                                 "--devices", "1"]
            t0 = time.perf_counter()
            (_, rate), launches = _counted(label, lambda: _run_cli(argv),
                                           want)
            out = base + "_FARMSOut_batch.txt"
            if not filecmp.cmp(out, card_files[preset], shallow=False):
                got = read_flow_txt(out)
                ref = read_flow_txt(card_files[preset])
                diff = (f"{len(got)} rows, not {len(ref)}"
                        if len(got) != len(ref) else
                        {c: int((getattr(got, c) != getattr(ref, c)).sum())
                         for c in FLOW_COLUMNS})
                raise AssertionError(f"{label}: output differs from the "
                                     f"single engine's card run: {diff}")
            _phase(f"cli {label} cuda", t0,
                   f"launches {launches}; output file equal byte for byte "
                   f"to the single engine's card run; [Benchmark Main] rate "
                   f"{rate:.1f} events/sec")
            results[label] = (launches, rate)
    return results


def check_padded(base):
    """The single engine on a padded array geometry (the 320 x 320 sensor
    in 324 x 328 arrays, as a sharded engine pads it) at the benchmark
    preset on the first 262,144 events, in-process: its launch counts, the
    same valid flags and scale ids as on the CPU on every event, and every
    column bitwise equal to the unpadded engine's card run. Returns
    (launches, events/s of the card run)."""
    from farms_tpu_torch.events.io import load_events_txt
    from farms_tpu_torch.pipeline.engine import FlowEngine

    t0 = time.perf_counter()
    cfg = _preset_config(base)
    padded = dataclasses.replace(cfg, padded_width=SENSOR + 4,
                                 padded_height=SENSOR + 8)
    ev = load_events_txt(base, K7_EVENTS)
    want = _preset_launches(K7_EVENTS // 131072)["benchmark"]
    eng = FlowEngine(padded, device="cuda")

    def run():
        start = time.perf_counter()
        out = eng.process(ev)
        return out, time.perf_counter() - start

    (card, wall), launches = _counted("padded", run, want)
    if tuple(eng.state.t_surf.shape) != (SENSOR + 4, SENSOR + 8):
        raise AssertionError(f"padded state {tuple(eng.state.t_surf.shape)}")
    _same_columns("padded (against the unpadded engine on the card)", card,
                  FlowEngine(cfg, device="cuda").process(ev))
    cpu = FlowEngine(padded, device="cpu").process(ev)
    vc, vg = cpu.r_local > 0, card.r_local > 0
    if (vc != vg).any() or (cpu.scale != card.scale).any() or vg.sum() < 1000:
        raise AssertionError(f"padded card vs cpu: {(vc != vg).sum()} valid "
                             f"flags, {(cpu.scale != card.scale).sum()} scale "
                             "ids differ")
    _phase("padded single engine", t0,
           f"324 x 328 arrays, {len(ev)} events: launches {launches}; every "
           f"column bitwise equal to the unpadded engine on the card; valid "
           f"flags ({int(vg.sum())} valid) and scale ids equal to the cpu on "
           f"every event; {len(ev) / wall:.1f} events/sec")
    return launches, len(ev) / wall


@contextlib.contextmanager
def _without_native(name):
    """nativeio.<name> answering as if the library were absent, so its
    caller takes the NumPy path."""
    from farms_tpu_torch.utils import nativeio
    real = getattr(nativeio, name)
    setattr(nativeio, name, lambda *a, **kw: None)
    try:
        yield
    finally:
        setattr(nativeio, name, real)


def _preset_config(base, preset="benchmark"):
    """The FlowConfig of the CLI at `preset` on the stream at `base`."""
    from farms_tpu_torch import cli
    return cli.build_config(cli.build_parser().parse_args(
        _stream_argv(base, preset)))


def _same_columns(label, got, want):
    """Every FlowOutput column bit for bit."""
    for col in FLOW_COLUMNS:
        a, b = np.asarray(getattr(got, col)), np.asarray(getattr(want, col))
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{label} {col}: differs")


def _timed(fn):
    start = time.perf_counter()
    result = fn()
    return result, time.perf_counter() - start


def check_native(base, work, card_files, cli_calls):
    """Phase 12: the native fast I/O (farms_tpu_torch/utils/nativeio.py,
    built from native/fast_io.cpp in phase 1) on the 1,048,576-event
    stream: the CLI's main paths of phase 5 went native (`cli_calls`);
    parse, pack2 (the compact pack inside it) and write each native and
    NumPy, equal bit for bit / byte for byte, with their host seconds;
    the native file equals the CLI's benchmark card file."""
    import torch
    from farms_tpu_torch.events.io import load_events_txt, write_flow_txt
    from farms_tpu_torch.pipeline.engine import FlowEngine
    from farms_tpu_torch.utils import nativeio

    t0 = time.perf_counter()
    if not nativeio.available() or min(cli_calls.values()) < 1:
        raise AssertionError(f"native I/O: library {nativeio.build_error()}"
                             f", the CLI's native calls {cli_calls}")
    nativeio.reset_calls()
    ev, parse_s = _timed(lambda: load_events_txt(base))
    with _without_native("parse_events"):
        ev_np, parse_np_s = _timed(lambda: load_events_txt(base))
    for col in ("x", "y", "t", "pol"):
        a, b = getattr(ev, col), getattr(ev_np, col)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"native parse {col} differs from NumPy")
    cfg = _preset_config(base)
    (packed, aux2, _), pack_s = _timed(
        lambda: FlowEngine(cfg, device="cuda").pack2(ev))
    with _without_native("pack_compact"):
        (packed_np, aux2_np, _), pack_np_s = _timed(
            lambda: FlowEngine(cfg, device="cuda").pack2(ev))
    for a, b in zip((packed, *aux2), (packed_np, *aux2_np)):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError("native pack2 differs from NumPy")
    out = FlowEngine(cfg, device="cuda").process(ev)
    torch.cuda.synchronize()
    path, write_s = _timed(lambda: write_flow_txt(
        out, os.path.join(work, "native")))
    with _without_native("write_flow"):
        path_np, write_np_s = _timed(lambda: write_flow_txt(
            out, os.path.join(work, "numpy")))
    if not filecmp.cmp(path, path_np, shallow=False):
        raise AssertionError("native write differs from NumPy")
    if not filecmp.cmp(path, card_files["benchmark"], shallow=False):
        raise AssertionError("native write differs from the CLI's file")
    calls = dict(nativeio.CALLS)
    if calls != {"parse": 1, "pack": 2, "write": 1}:
        raise AssertionError(f"native calls {calls}")
    _phase("native io", t0,
           f"the CLI paths' native calls {cli_calls}; on {len(ev)} events, "
           f"native / NumPy host seconds: parse {parse_s:.4f} / "
           f"{parse_np_s:.4f}, pack2 (benchmark preset) {pack_s:.4f} / "
           f"{pack_np_s:.4f}, write {write_s:.4f} / {write_np_s:.4f}; "
           f"each equal bit for bit (arrays) or byte for byte (files), the "
           f"file equal to the CLI's benchmark card file; native calls "
           f"{calls}")
    return dict(parse=(parse_s, parse_np_s), pack2=(pack_s, pack_np_s),
                write=(write_s, write_np_s))


def check_stream(base, work, card_files):
    """Phase 13: events/stream.process_file_streaming at the benchmark
    preset on the card: the stream in chunks of 262,144 events (whole
    calls) written byte for byte as the CLI's one-shot card file; its
    first 262,144 events in chunks of 100,000 (no chunk a whole
    micro-step) with the CPU's valid flags and scale ids on every event.
    Returns {label: (launches, events/s)}."""
    from farms_tpu_torch.events.io import read_flow_txt, write_flow_txt
    from farms_tpu_torch.events.stream import process_file_streaming
    from farms_tpu_torch.pipeline.engine import FlowEngine

    cfg = _preset_config(base)
    t0 = time.perf_counter()
    want = _preset_launches(STREAM_EVENTS // 131072)["benchmark"]
    eng = FlowEngine(cfg, device="cuda")
    (out, wall), launches = _counted(
        "stream aligned", lambda: _timed(lambda: process_file_streaming(
            eng, base, chunk_events=2 * 131072)), want)
    path = write_flow_txt(out, os.path.join(work, "stream"))
    if not filecmp.cmp(path, card_files["benchmark"], shallow=False):
        got, ref = read_flow_txt(path), read_flow_txt(card_files["benchmark"])
        raise AssertionError(
            "stream aligned: file differs from the one-shot run: "
            + str({c: int((getattr(got, c) != getattr(ref, c)).sum())
                   for c in FLOW_COLUMNS} if len(got) == len(ref)
                  else len(got)))
    results = {"stream aligned": (launches, len(out) / wall)}
    _phase("stream aligned", t0,
           f"{len(out)} events in chunks of 262144: launches {launches}; "
           f"output file equal byte for byte to the CLI's one-shot card "
           f"file; {len(out) / wall:.1f} events/s (parse included)")

    t0 = time.perf_counter()
    n_cut = K7_EVENTS
    want = _preset_launches(3)["benchmark"]   # 3 chunks, a step each
    (card, wall), launches = _counted(
        "stream unaligned", lambda: _timed(lambda: process_file_streaming(
            FlowEngine(cfg, device="cuda"), base, chunk_events=100000,
            max_events=n_cut)), want)
    cpu = process_file_streaming(FlowEngine(cfg, device="cpu"), base,
                                 chunk_events=100000, max_events=n_cut)
    vc, vg = cpu.r_local > 0, card.r_local > 0
    if (len(card) != n_cut or (vc != vg).any()
            or (cpu.scale != card.scale).any() or vg.sum() < 1000):
        raise AssertionError(f"stream unaligned card vs cpu: "
                             f"{int((vc != vg).sum())} valid flags, "
                             f"{int((cpu.scale != card.scale).sum())} scale "
                             "ids differ")
    results["stream unaligned"] = (launches, n_cut / wall)
    _phase("stream unaligned", t0,
           f"{n_cut} events in chunks of 100000: launches {launches}; "
           f"valid flags ({int(vg.sum())} valid) and scale ids equal to the "
           f"cpu's on every event")
    return results


def check_sparse(base, card_files, smi):
    """Phase 14: `--wire sparse` through the CLI at the benchmark preset,
    its file byte for byte the `--wire f16` card file of phase 5, with the
    device-to-host bytes per event of both wires; then events/s of a
    warmed process() on each wire, in turns (f16, sparse, sparse, f16).
    Returns (launches, events/s of the sparse CLI run)."""
    import dataclasses as dc

    import torch
    from farms_tpu_torch.events.io import load_events_txt
    from farms_tpu_torch.pipeline import engine as teng

    t0 = time.perf_counter()
    fetched = []
    fetch = teng._fetch_sparse

    def counting(out):
        aux_plus, pay = out
        got = fetch(out)
        R = (aux_plus.shape[0] - pay.shape[0] // 2 - 8) // 4
        k = got[1].size + got[2].size
        fetched.append(aux_plus.shape[0] + (4 * k if k > R else 0))
        return got

    argv = _stream_argv(base, "benchmark") + ["--wire", "sparse"]
    teng._fetch_sparse = counting
    try:
        (_, cli_rate), launches = _counted(
            "sparse", lambda: _run_cli(argv),
            _preset_launches(STREAM_EVENTS // 131072)["benchmark"])
    finally:
        teng._fetch_sparse = fetch
    if not filecmp.cmp(base + "_FARMSOut_batch.txt", card_files["benchmark"],
                       shallow=False):
        raise AssertionError("--wire sparse: file differs from --wire f16")
    sparse_b = sum(fetched) / STREAM_EVENTS
    f16_b = 9.0       # (2 int32 words + 1 aux byte) per lane, no padding
    ev = load_events_txt(base)
    cfg = _preset_config(base)
    rates = {"f16": [], "sparse": []}
    decode = {"f16": [], "sparse": []}
    for wire in ("f16", "sparse", "sparse", "f16"):
        eng = teng.FlowEngine(dc.replace(cfg, wire=wire), device="cuda")
        eng.process(ev[:2 * 131072])                 # warm-up
        eng.reset()
        unpack = eng._unpack_outputs

        def timed_unpack(*a):
            out, secs = _timed(lambda: unpack(*a))
            decode[wire].append(secs)
            return out

        eng._unpack_outputs = timed_unpack
        torch.cuda.synchronize()
        _, wall = _timed(lambda: eng.process(ev))
        rates[wire].append(len(ev) / wall)
    line = (f"[rates] wire f16 / sparse, benchmark, warmed process(): "
            f"{np.mean(rates['f16']):.1f} / {np.mean(rates['sparse']):.1f} "
            f"events/s (runs {rates}), of which host decode "
            f"{np.mean(decode['f16']):.4f} / {np.mean(decode['sparse']):.4f} "
            f"s; device-to-host {f16_b:.3f} / {sparse_b:.3f} bytes per "
            f"event; card {smi}")
    print(line, flush=True)
    _phase("cli sparse cuda", t0,
           f"launches {launches}; output file equal byte for byte to the "
           f"--wire f16 card file; {len(fetched)} calls fetched "
           f"{sum(fetched)} bytes ({sparse_b:.3f} B/event against "
           f"{f16_b:.0f}); [Benchmark Main] rate {cli_rate:.1f} events/sec")
    return launches, float(np.mean(rates["sparse"]))


def check_resident(base):
    """Phase 15: FlowEngine.process_resident at both presets on the card:
    the stream as one uploaded call of the explicit 5-row layout (the
    5-row decode on the card), its launch counts, its outputs decoded
    equal to process() on every column bit for bit, and a replay from the
    state before the first call equal to the first. Returns {label:
    (launches, events/s of a timed replay)}."""
    import torch
    from farms_tpu_torch.events.io import load_events_txt
    from farms_tpu_torch.pipeline.engine import FlowEngine

    ev = load_events_txt(base)
    results = {}
    for preset, want in _preset_launches(STREAM_EVENTS // 131072).items():
        t0 = time.perf_counter()
        cfg = _preset_config(base, preset)
        ref = FlowEngine(cfg, device="cuda").process(ev)
        eng = FlowEngine(cfg, device="cuda")
        fn, n = eng.process_resident(ev)
        start = eng.state
        (main, aux), launches = _counted(f"resident {preset}", fn, want)
        got = eng._unpack_outputs([(main.cpu().numpy(), aux.cpu().numpy())],
                                  ev, n)
        _same_columns(f"resident {preset}", got, ref)
        eng.state = start
        torch.cuda.synchronize()
        (main2, aux2), wall = _timed(lambda: (fn(), torch.cuda.synchronize())
                                     [0])
        if not (torch.equal(main, main2) and torch.equal(aux, aux2)):
            raise AssertionError(f"resident {preset}: replay differs")
        results[f"resident {preset}"] = (launches, n / wall)
        _phase(f"resident {preset}", t0,
               f"{n} events as one call of {main.shape[0]} micro-steps "
               f"(5-row batch): launches {launches}; every column equal bit "
               f"for bit to process(); the replay from its start state "
               f"equal, {n / wall:.1f} events/s")
    return results


def check_harness(smi, config_ids=("1", "2", "3", "4")):
    """Phase 16: the benchmark harness (farms_tpu_torch/bench/harness.py)
    configs 1-4 on this card: each JSON line with the card's nvidia-smi
    name and power limit, and the kernels each one launched (each expected
    kernel at least once). Returns {label: (launches, events/s)}."""
    import torch
    from farms_tpu_torch.bench import harness
    from farms_tpu_torch.ops import kernels

    # config 2 sweeps filter sizes 3, 5 and 7: the general kernel too
    expect = {"1": ("local_flow",), "2": ("local_flow", "local_flow_general"),
              "3": ("local_flow",), "4": ("local_flow",)}
    results = {}
    for cid in config_ids:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = harness.ALL_CONFIGS[cid]()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        needed = expect.get(cid, ("local_flow",)) + ("aperture", "integral")
        if min(launches[k] for k in needed) < 1:
            raise AssertionError(f"harness config {cid}: launches "
                                 f"{launches}")
        res = res if isinstance(res, list) else [res]
        for line in harness.result_lines(res):
            print(f"[harness] {line} card {smi}", flush=True)
        if min(r.events_per_sec for r in res) <= 0:
            raise AssertionError(f"harness config {cid}: {res}")
        results[f"harness config {cid}"] = (launches, res[0].events_per_sec)
        _phase(f"harness config {cid}", t0, f"launches {launches}")
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


def _compare_with_single(label, out, ref, ref_lines, passes, cfg,
                         exact=False):
    """The output file `out` against the single engine's run (ref, its
    file's lines, the aperture inputs `passes`): byte for byte on every
    line whose scale id is the single engine's, and scale ids that differ
    only at float64 ties of the per-scale mean lengths (none where
    `exact`). Returns a summary."""
    from farms_tpu_torch.events.io import read_flow_txt
    from farms_tpu_torch.pipeline.ties import scale_ties

    with open(out) as fh:
        lines = fh.readlines()
    if len(lines) != len(ref_lines):
        raise AssertionError(f"{label}: {len(lines)} rows")
    got = read_flow_txt(out)
    differ = ref.scale != got.scale
    tied = differ & scale_ties(ref, got, passes, cfg)
    if (differ & ~tied).any() or (exact and differ.any()):
        raise AssertionError(f"{label}: {int(differ.sum())} scale ids "
                             f"differ, {int(tied.sum())} at float64 ties")
    other = np.array([a != b for a, b in zip(lines, ref_lines)])
    if (other & ~differ).any():
        raise AssertionError(
            f"{label}: {(other & ~differ).sum()} lines with the single "
            "engine's scale id differ from its output file")
    return (f"output file equal byte for byte to the single engine's on "
            f"{int((~other).sum())} of {len(ref)} lines; the other "
            f"{int(other.sum())} differ in the scale id, {int(tied.sum())} "
            f"float64 ties of {int(differ.sum())} scale differences")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multihost_world(base, dist_base):
    """Four processes launched the --multihost way, each with the
    environment a launcher gives rank r of two hosts of two cards: RANK,
    WORLD_SIZE = 4, LOCAL_RANK = r % 2, LOCAL_WORLD_SIZE = 2,
    MASTER_ADDR, MASTER_PORT, and host h = r // 2's two cards visible. So
    the grid is (tx, ev) = (2, 2), each band group on one "host". Each
    runs `multihost_rank`; returns rank 0's output."""
    root = os.path.dirname(os.path.abspath(__file__))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible
             else [str(c) for c in range(4)])
    port = _free_port()
    procs = []
    for r in range(4):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="4",
                   LOCAL_RANK=str(r % 2), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   CUDA_VISIBLE_DEVICES=",".join(cards[2 * (r // 2):
                                                       2 * (r // 2) + 2]))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-rank",
             base, dist_base], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=NCCL_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise RuntimeError(f"multihost rank {r} exited "
                               f"{proc.returncode}:\n{out[-4000:]}")
    return outs[0]


def multihost_rank(base, dist_base) -> int:
    """One rank of `_multihost_world`: the CLI at the benchmark preset
    with --multihost --engine multihost (it joins the world from the
    environment; rank 0 writes the output file), then
    write_flow_distributed on a new engine, with the output all-gather
    made to raise, into `dist_base`."""
    from unittest import mock

    import torch.distributed as dist
    from farms_tpu_torch import cli
    from farms_tpu_torch.events.io import load_events_txt
    from farms_tpu_torch.parallel import multihost

    argv = _stream_argv(base, "benchmark") + ["--multihost", "--engine",
                                              "multihost"]
    rc = cli.main(argv)
    grid = multihost.make_global_mesh()
    if (grid.tx, grid.ev) != (2, 2):
        raise AssertionError(f"grid {grid.tx} x {grid.ev}, not 2 x 2")
    args = cli.build_parser().parse_args(argv)
    eng = multihost.MultiHostFlowEngine(cli.build_config(args), mesh=grid,
                                        device=args.device)
    with mock.patch.object(multihost, "gather_lanes", side_effect=(
            AssertionError("write_flow_distributed gathered outputs"))):
        eng.write_flow_distributed(load_events_txt(base), dist_base)
    dist.destroy_process_group()
    return rc


def _engine_rate(eng, ev):
    """(events/s of a warmed eng.process(ev), device-busy ms per 1M
    events of another run from torch.profiler, its wall s)."""
    import torch
    from farms_tpu_torch.parallel import mesh

    eng.process(ev[:2 * 131072])                     # warm-up
    eng.reset()
    mesh.barrier()
    torch.cuda.synchronize()
    start = time.perf_counter()
    eng.process(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    eng.reset()
    busy = _busy_ms(lambda: eng.process(ev))
    return len(ev) / wall, busy * (1 << 20) / len(ev), wall


def _make_engine(kind, cfg):
    """"single", "dp" (every rank), or a (tx, ev) multihost grid."""
    from farms_tpu_torch.parallel import (MultiHostFlowEngine,
                                          ShardedFlowEngine, mesh)
    from farms_tpu_torch.pipeline.engine import FlowEngine

    if kind == "single":
        return FlowEngine(cfg, device="cuda")
    if kind == "dp":
        return ShardedFlowEngine(cfg, device="cuda")
    return MultiHostFlowEngine(cfg, mesh=mesh.make_global_mesh(*kind),
                               device="cuda")


def rank_rate(kind, base, preset):
    """A rank's `_engine_rate` of engine `kind` on the stream (parallel/
    mesh.py `run` entry point; rank 0's is returned)."""
    from farms_tpu_torch.events.io import load_events_txt

    return _engine_rate(_make_engine(kind, _preset_config(base, preset)),
                        load_events_txt(base))


def _rate_line(label, preset, n, rate, per_m, wall, smi):
    line = (f"[rates] {label} {preset} ranks={n}: {rate:.1f} events/s "
            f"({STREAM_EVENTS} events in {wall:.3f} s), device busy "
            f"{per_m:.3f} ms per 1M events (rank 0's card); card {smi}")
    print(line, flush=True)


def check_engine_rates(base, smi):
    """The single, dp and multihost engines at one rank, in-process, at
    both presets: events/s of a warmed process() over the stream and
    device-busy ms per 1M events (torch.profiler). Returns {label:
    events/s}."""
    from farms_tpu_torch.events.io import load_events_txt

    ev = load_events_txt(base)
    rates = {}
    for preset in ("benchmark", "fidelity"):
        cfg = _preset_config(base, preset)
        for kind in ("single", "dp", (1, 1)):
            t0 = time.perf_counter()
            label = kind if isinstance(kind, str) else "multihost"
            rate, per_m, wall = _engine_rate(_make_engine(kind, cfg), ev)
            _rate_line(label, preset, 1, rate, per_m, wall, smi)
            rates[f"{label} {preset} ranks=1"] = rate
            _phase(f"rates {label} {preset}", t0, f"{rate:.1f} events/s")
    return rates


def config5_replay_rank():
    """One rank of harness config 5's halo engine (parallel/mesh.py `run`
    entry point): its process_resident call run once from the engine's
    start state, with every launch count set to 0 just before it, and
    that call's lanes gathered and decoded as process() decodes them.
    Returns (every rank's launch counts, the FlowOutput) on rank 0."""
    import torch
    import torch.distributed as dist
    from farms_tpu_torch.bench import harness
    from farms_tpu_torch.ops import kernels
    from farms_tpu_torch.parallel.halo import HaloFlowEngine

    cfg, ev = harness.config5_inputs()
    eng = HaloFlowEngine(cfg)
    fn, n = eng.process_resident(ev)
    perm = eng.pack_halo(ev, -(-n // cfg.chunk_size))[2]
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, dict(kernels.LAUNCHES))
    block = eng._gather(*out, perm is not None)
    return counts, (None if block is None
                    else eng._unpack([block], ev, n, perm))


def check_nccl(base, work, smi):
    """Over NCCL, each rank on its own card, against the single engine's
    run on cuda:0 (phase 6 shows one rank's output is that run's),
    at the benchmark preset: `--engine halo --devices N` and `--engine dp
    --devices N` through the CLI (N = 2, and 4 with four cards; dp byte
    for byte, halo byte for byte on every line whose scale id is the
    single engine's, and scale ids that differ only at float64 ties of the
    band integral); with four cards, a (2, 2) multihost world launched the
    --multihost way (`_multihost_world`: the CLI's file and
    write_flow_distributed's, each as halo's); then the [rates] of the
    single engine on cuda:0 and of dp and multihost at 2 and 4 ranks
    (mesh.run), on the same machine; and harness config 5 (the halo
    engine's process_resident over every card: each rank's launch counts
    over one replay, and that replay's output against the single
    engine's, as the CLI's). Returns ({label: rate}, {label: (launches,
    rate)}); with fewer than two cards it prints why it did not run."""
    import torch
    from farms_tpu_torch import cli
    from farms_tpu_torch.events.io import (load_events_txt, read_flow_txt,
                                           write_flow_txt)
    from farms_tpu_torch.ops import kernels
    from farms_tpu_torch.parallel import mesh
    from farms_tpu_torch.pipeline.engine import FlowEngine

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[phase nccl] not run: the NCCL phases (`--engine halo`, "
              f"`--engine dp` and a multihost world over 2 or 4 ranks) "
              f"need one CUDA device per rank, this machine has {cards}",
              flush=True)
        return {}, {}
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
    out = base + "_FARMSOut_batch.txt"
    rates, paths = {}, {}
    for n in (2, 4):
        if n > cards:
            break
        for engine in ("halo", "dp"):
            t0 = time.perf_counter()
            rate = _cli_process(argv + ["--engine", engine, "--devices",
                                        str(n)])
            said = _compare_with_single(f"nccl {engine} devices={n}", out,
                                        ref, ref_lines, passes, cfg,
                                        exact=engine == "dp")
            _phase(f"nccl {engine} devices={n}", t0,
                   f"{said}; [Benchmark Main] rate {rate:.1f} events/sec")
            rates[f"{engine} benchmark devices={n}"] = rate
    if cards >= 4:
        t0 = time.perf_counter()
        dist_base = os.path.join(work, "distributed")
        said = _multihost_world(base, dist_base)
        rate = float(re.search(r"with rate of : (\S+) events/sec",
                               said).group(1))
        cli_said = _compare_with_single("multihost world cli", out, ref,
                                        ref_lines, passes, cfg)
        dist_said = _compare_with_single(
            "multihost world write_flow_distributed",
            dist_base + "_FARMSOut_batch.txt", ref, ref_lines, passes, cfg)
        _phase("nccl multihost world (2, 2)", t0,
               f"4 processes, --multihost with a launcher's environment: "
               f"the CLI's {cli_said}; [Benchmark Main] rate {rate:.1f} "
               f"events/sec; write_flow_distributed (no output all-gather): "
               f"{dist_said}")
        rates["multihost world (2, 2) benchmark"] = rate
    else:
        print(f"[phase nccl multihost world] not run: a (2, 2) world needs "
              f"4 CUDA devices, this machine has {cards}", flush=True)
    t0 = time.perf_counter()
    from farms_tpu_torch.bench import harness
    res = harness.config5_sharded()
    print(f"[harness] {harness.result_lines(res)[0]} card {smi}", flush=True)
    if res.extra["engine"] != "HaloFlowEngine" or not res.events_per_sec > 0:
        raise AssertionError(f"harness config 5: {res}")
    counts, got = mesh.run(config5_replay_rank, cards, "cuda")
    cfg5, ev5 = harness.config5_inputs()
    steps = -(-len(ev5) // cfg5.chunk_size) * cfg5.sub_phases
    want = {k: steps if k in ("local_flow", "aperture", "integral") else 0
            for k in kernels.LAUNCHES}
    if any(c != want for c in counts):
        raise AssertionError(f"harness config 5: launch counts by rank "
                             f"{counts}, expected {want} on each")
    passes.clear()
    kernels.aperture = recording
    try:
        single5 = FlowEngine(cfg5, device="cuda").process(ev5)
    finally:
        kernels.aperture = aperture
    ref5_file = write_flow_txt(single5, os.path.join(work, "config5"))
    with open(ref5_file) as fh:
        ref5_lines = fh.readlines()
    said = _compare_with_single(
        "harness config 5 replay",
        write_flow_txt(got, os.path.join(work, "config5_halo")), single5,
        ref5_lines, passes, cfg5)
    launches = {k: sum(c[k] for c in counts) for k in want}
    rates["harness config 5"] = res.events_per_sec
    paths["harness config 5"] = (launches, res.events_per_sec)
    _phase("harness config 5", t0, f"the halo engine's process_resident "
           f"over {cards} ranks, one a card: launches {counts[0]} on each "
           f"rank; a replay from the start state gathered and decoded, "
           f"against the single engine's process(): {said}")
    t0 = time.perf_counter()
    rate, per_m, wall = _engine_rate(_make_engine("single", cfg), ev)
    _rate_line("single", "benchmark", 1, rate, per_m, wall, smi)
    rates["single benchmark ranks=1"] = rate
    _phase("rates single ranks=1", t0, f"{rate:.1f} events/s")
    for n in (2, 4):
        if n > cards:
            break
        for kind in ("dp", (2, n // 2)):
            t0 = time.perf_counter()
            label = "dp" if kind == "dp" else f"multihost {kind[0]}x{kind[1]}"
            rate, per_m, wall = mesh.run(rank_rate, n, "cuda", kind, base,
                                         "benchmark")
            _rate_line(label, "benchmark", n, rate, per_m, wall, smi)
            rates[f"{label} benchmark ranks={n}"] = rate
            _phase(f"rates {label} ranks={n}", t0, f"{rate:.1f} events/s")
    return rates, paths


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
    warmed FlowEngine.process over the stream (its first 131,072 events
    at chunk 256, 1,024 at chunk 1), and device-busy ms per 1M events
    from torch.profiler over the first `profiled` events of a fresh run.
    No bound: a failed run fails the smoke. Returns {label: events/s}."""
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


def _start():
    """The card and the kernel build (phase 1); returns (kind, smi)."""
    import torch
    from farms_tpu_torch.ops import _build
    from farms_tpu_torch.utils import nativeio

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
    t0 = time.perf_counter()
    native = nativeio.build()
    if not nativeio.available():
        raise AssertionError(f"native I/O: {nativeio.build_error()}")
    _phase("build native", t0, f"g++ {' '.join(nativeio.CXX_FLAGS)} "
           f"{os.path.relpath(nativeio.SOURCE)} -> {os.path.relpath(native)}")
    return kind, smi


def nccl_only() -> int:
    """The multi-card phases alone (`--nccl-only`): the card, the build,
    the stream and check_nccl, for a machine with 2 or 4 cards. Prints no
    result line."""
    import torch
    if torch.cuda.device_count() < 2:
        print("chip_smoke --nccl-only: needs 2 or more GPUs",
              file=sys.stderr)
        return 2
    _, smi = _start()
    with tempfile.TemporaryDirectory() as work:
        rates, paths = check_nccl(write_stream(work), work, smi)
    print(f"[rates] [Benchmark Main] events/sec by path: {rates}")
    print(f"[launches] by path: "
          f"{ {label: c for label, (c, _) in paths.items()} }")
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one GPU",
              file=sys.stderr)
        return 2

    from farms_tpu_torch.utils import nativeio
    dev = torch.device("cuda")
    kind, smi = _start()
    timings = check_kernels(dev)
    halo_timings = check_halo_kernels(dev)
    check_oracle(dev)
    with tempfile.TemporaryDirectory() as work:
        base = write_stream(work)
        nativeio.reset_calls()
        paths, card_files = check_main_paths(base, work)
        cli_calls = dict(nativeio.CALLS)
        paths.update(check_engine_paths(base, card_files))
        paths["padded benchmark"] = check_padded(base)
        check_native(base, work, card_files, cli_calls)
        paths.update(check_stream(base, work, card_files))
        paths["sparse benchmark"] = check_sparse(base, card_files, smi)
        paths.update(check_resident(base))
        paths.update(check_harness(smi))
        rates, nccl_paths = check_nccl(base, work, smi)
        paths.update(nccl_paths)
        paths["perevent benchmark"] = check_perevent_cli(base)
        paths["serial"] = check_serial_cli(base, dev)
        path_rates = check_rates(base, smi)
        path_rates.update(check_engine_rates(base, smi))
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
            library_ms=timings[name].pop("library_ms", None),
            **timings[name], **halo))
    print(f"[rates] [Benchmark Main] events/sec by path: {rates}")
    print(f"[rates] process() events/sec, per-event and dense, and the "
          f"single, dp and multihost engines: {path_rates}")
    print(json.dumps({"kernels": entries}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-rank"]:
        sys.exit(multihost_rank(*sys.argv[2:4]))
    if sys.argv[1:] == ["--nccl-only"]:
        sys.exit(nccl_only())
    sys.exit(main())

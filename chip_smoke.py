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
   the shape the library reports; the card's float64 add latency (one
   thread's chain of adds, clock64) and the float64 integral kernel
   against the plain integral, bit for bit on the card and on the CPU, at
   every shape its callers pass (INTEGRAL_SHAPES: 320 x 320, 260 x 346,
   1280 x 720, an 80-row band, tiles of 160 x 160, 80 x 160 and 260 x 87,
   1 x 17 and 33 x 1), one launch and one device kernel a call, with the
   cells where CUDA's own innermost-dimension cumsum departs from the
   sequential order and, at the first five, the device time beside the
   bytes bound and the chain bound; the aperture pass (integral and
   pool; the pool's own device time,
   bound and share beside it, and the L2 bytes its design reads a pass)
   with 11 scales and once at 260 x 346 with the y-clamp quirk; the wire
   decode (decode_wire) against decode_wire_columns on a 131,072-lane
   call of the f16 and the f32 wire and on an unaligned tail of it (the
   kernel's lane path), and on a 1,048,576-lane f16 wire its wrapper
   time, its device time with the L2 cache flushed, NumPy's host time and
   its bytes bound (9 bytes read, 28 written a lane);
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
3b. the kernels' tile modes (the 2-D tiles of the spatial engine,
   farms_tpu_torch/parallel/tiling.py) on the (2, 2) and (4, 2) tiles of
   320 x 320 and the (1, 4) tiles of 260 x 346 padded to 348 columns:
   local flow at k = 3, 5 and 7 in both fold modes on each tile plus its
   R exchanged rows and columns, the pool on each tile's band of the
   whole float64 integral (pre-clamped in y), with and without the
   y-clamp quirk; each bitwise against its plain tile mode on the card
   and the whole-sensor kernel's cells, its device time on one tile of
   each grid against its bound;
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
6. the halo, spatial, dp and multihost engines through the CLI at one
   rank (`--engine halo|spatial|dp|multihost --devices 1`: every halo and
   tile mode of every kernel; the single engine's micro_step on one
   rank's event shard) at both presets on the same stream: their launch
   counts, and output files equal byte for byte to the single engine's
   card run;
7. the single engine on a padded array geometry (320 x 320 in 324 x 328
   arrays) at the benchmark preset on the first 262,144 events: launch
   counts, every column bitwise equal to the unpadded engine's, and the
   CPU's valid flags and scale ids on every event; 7b. the spatial
   engine at one rank on the benchmark harness's config 5 (1280 x 720,
   262,144 events): the single engine's launch counts, each in tile
   mode, and every column bitwise equal to it;
8. with two or more cards, over NCCL with each rank on its own card, at
   the benchmark preset against the single engine's run on cuda:0:
   `--engine dp --devices 2` (and 4) byte for byte, `--engine halo
   --devices 2` (and 4) and `--engine spatial --devices 2` (and 4) byte
   for byte on every line but those whose scale id differs at a float64
   tie of the per-scale mean lengths
   (farms_tpu_torch/pipeline/ties.py on the aperture inputs of the single
   engine's run); with four cards a (2, 2) multihost world launched the
   --multihost way (four processes of this script with a launcher's
   environment, two "hosts" of two cards) whose CLI file and
   write_flow_distributed file (the output all-gather made to raise) are
   held as halo's, and the spatial engine's (2, 2) grid through the API
   at 320 x 320 and at config 5's 1280 x 720, each held as halo's (the
   tie count printed); then [rates] of the single engine and of dp,
   multihost and spatial (x tiles; and (2, 2)) at 2 and 4 ranks, and the
   benchmark harness's config 5 (the halo engine's process_resident over
   every card), and the scaling sweep of phase 20 at N = 2 (and 4). With
   one card it prints why it did not run (`--nccl-only` runs this phase
   alone, after the build);
9. `--backend perevent --preset benchmark` through the CLI on the same
   stream, card against CPU as in 5: 16 integral launches (8 steps x 2
   phases), 8 wire decodes (one a call) and none of the other kernels;
10. `--SERIAL 1 --numEvents 4096` through the CLI on the card and the CPU:
   one `Local` line per event and one `true` line per valid event
   (captured), the [Benchmark Main] line and no output file; then the
   serial engine in-process, card against CPU on every valid flag and
   scale id;
11. rates: FlowEngine.process on the card, per-event against dense, at
   chunks 2048 and 131072 on the stream, chunk 256 on its first 131,072
   events and chunk 1 on its first 1,024; and the single, dp, multihost
   and spatial engines at one rank at both presets: events/s and
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
   it launched;
17. the accuracy sweep (farms_tpu_torch/bench/accuracy.py) on its
   120,000-event bar stream, uncut: the float64 oracle's seconds, then the
   `benchmark` and `fidelity` rows on the card beside ACCURACY.json's
   rows (the same oracle valid count, validity agreement within
   ACCURACY_SLACK), with their launch counts;
18. the benchmark line (farms_tpu_torch/bench/driver.py) at reduced call
   counts (DRIVER_ENV): its JSON line with the card, the kernels it
   launched;
19. the device sweep (farms_tpu_torch/bench/device_sweep.py) on both
   presets' configs, a JSON line each;
20. the scaling sweep (farms_tpu_torch/bench/scaling.py) at N = 1 (the
   single engine's process_resident against process(), and its rate);
   the NCCL phase runs it at N = 2 and 4 (every engine) where the cards
   are there.

The line before the last is the card's nvidia-smi name and power limit;
the one before it a JSON summary of the kernels, with each kernel's bound
(the larger of the bytes it must move over 3.35 TB/s and its operations
over 67 TFLOP/s in f32 and 34 TFLOP/s in f64, the H100 SXM's data-sheet
peaks; the integral's also its chain bound, `chain_bound_ms`: rows +
cols dependent float64 adds at the measured add latency and the SM
clock's maximum) and its share (the larger bound over device time) for
its whole-sensor case,
(`halo_*`) for one 80-row band and (`halo1_*`) for the one band of 320
rows, and (`tile_*`) for one 160 x 160 tile of (2, 2); the aperture
entry adds the pool's own bound (`pool_bound_ms`: the
float64 integral read from device memory, not built on the chip) and its
share of the pool's device time (`pool_share`);
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
# each kernel's CUDA source and what it replaces in the JAX package: a
# Pallas kernel, the XLA cumsum that aperture_pallas runs before its
# Pallas kernel (the integral), or the host's NumPy decode of the wire
# (decode_wire)
_PALLAS = "farms_tpu/ops/pallas/kernels.py"
KERNEL_SOURCES = {"local_flow": ("local_flow.cu", f"{_PALLAS}:434"),
                  "local_flow_general": ("local_flow.cu", f"{_PALLAS}:171"),
                  "aperture": ("aperture.cu", f"{_PALLAS}:640"),
                  "integral": ("aperture.cu", f"{_PALLAS}:733"),
                  "decode_wire": ("wire.cu", "farms_tpu/pipeline/engine.py:"
                                  "1349 (decode_wire_columns, host)")}
# the decode_wire checks: lanes a call on the main path, the unaligned
# tail's offset and count (the kernel's lane path), the lanes of a
# gen4hd replay batch (8 calls) for its times; atan2f's largest error in
# the CUDA Math API, in ulps
WIRE_CALL_LANES = 131072
WIRE_TAIL = (3, 100003)
WIRE_TIMED_LANES = 1 << 20
ATAN2F_ULP = 3
BAND_COUNTS = (1, 2, 4)     # row shards of the halo-mode kernel checks
# (W, H, grids) of the tile-mode kernel checks: the sensor in (2, 2) and
# (4, 2) tiles, and 260 x 346 (where the quirk moves the pool's y clamp)
# in (1, 4)
TILE_GRIDS = ((SENSOR, SENSOR, ((2, 2), (4, 2))), (260, 346, ((1, 4),)))
# NVIDIA H100 SXM data-sheet peaks: HBM bytes/s, f32 and f64 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
# the shapes the integral's callers pass: the sensor, the quirk geometry,
# harness config 5's sensor, an 80-row band of 320 (4 shards), spatial
# tiles of (2, 2), (4, 2) and (1, 4) at 260 x 348, one row and one
# column; the first INTEGRAL_TIMED are timed
INTEGRAL_SHAPES = ((SENSOR, SENSOR), (260, 346), (1280, 720), (80, SENSOR),
                   (160, 160), (80, 160), (260, 87), (1, 17), (33, 1))
INTEGRAL_TIMED = 5
# the accuracy sweep's preset rows on the bar stream (chunk, P, A, S, C,
# coarse chain): farms_tpu/cli.py:182 and :188
ACCURACY_PRESETS = {"benchmark": (131072, 2, 2, 1, 0, False),
                    "fidelity": (131072, 2, 2, 8, 32768, True)}
# validity agreement the port may miss ACCURACY.json's row by before the
# phase fails: the accept flips of FMA and summation order that
# tests/test_torch_engine.py's _assert_engines_agree allows (0.1 % of
# lanes; PR 12's rows were equal)
ACCURACY_SLACK = 0.001
# the driver phase's reduced call counts
DRIVER_ENV = {"FARMS_BENCH_CALLS": "4", "FARMS_BENCH_E2E_REPS": "2"}
# the device sweep's configs the smoke runs: both presets' (P, A, S, C)
DEVICE_SWEEP_CONFIGS = ((2, 2, 1, 0), (2, 2, 8, 32768))
# events a timed round of the smoke's scaling sweeps replays
SCALING_REPLAY = 1 << 20

# One thread: a chain of 64 * n dependent float64 adds between two
# clock64() reads. The adds cannot be reassociated (no fast math), so the
# cycles grow by one add latency per add; the latency is the difference
# of two chain lengths over the difference of their adds.
_DADD_SRC = r"""
#include <cuda_runtime.h>
__global__ void dadd_chain(const double* x, int n, double* out,
                           long long* cycles) {
  double a = x[0];
  const double b = x[1];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < 64; ++u) a = a + b;
  }
  const long long t1 = clock64();
  out[0] = a;
  cycles[0] = t1 - t0;
}
extern "C" int farms_dadd_chain(const void* x, int n, void* out,
                                void* cycles) {
  dadd_chain<<<1, 1>>>(static_cast<const double*>(x), n,
                       static_cast<double*>(out),
                       static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}
"""


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _dadd_latency() -> dict:
    """The card's float64 add latency in SM cycles (median of 5 runs of
    chains of 64 * 100 and 64 * 1100 adds, compiled from _DADD_SRC into
    farms_tpu_torch/_build) and the SM clock's maximum (MHz, nvidia-smi):
    (rows + cols) adds at that latency and clock are the integral's chain
    bound."""
    import ctypes
    import hashlib

    import torch
    from farms_tpu_torch.ops import _build
    tag = hashlib.sha256(_DADD_SRC.encode()).hexdigest()[:12]
    lib_path = _build.BUILD_DIR / f"libdadd_{tag}.so"
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / f"dadd_{tag}.cu"
        src.write_text(_DADD_SRC)
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(lib_path),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.farms_dadd_chain.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.farms_dadd_chain.restype = ctypes.c_int
    x = torch.tensor([1.0, 1e-3], dtype=torch.float64, device="cuda")
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    cycles = torch.empty(1, dtype=torch.int64, device="cuda")

    def run(n):
        rc = lib.farms_dadd_chain(x.data_ptr(), n, out.data_ptr(),
                                  cycles.data_ptr())
        if rc:
            raise RuntimeError(f"dadd_chain launch failed: cudaError_t {rc}")
        torch.cuda.synchronize()
        return int(cycles.item())

    run(100)
    lat = [(run(1100) - run(100)) / (64 * 1000) for _ in range(5)]
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.split()[0]
    return {"dadd_latency_cycles": float(np.median(lat)),
            "dadd_latency_runs": lat, "sm_clock_max_mhz": float(clk)}


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
    """Bound over device time of a result entry, against the larger of its
    bytes-or-operations bound and, where it has one, its chain bound (None
    where the device time was not measured)."""
    ms = r.get(f"{prefix}device_ms")
    bound = max(r[f"{prefix}bound_ms"], r.get(f"{prefix}chain_bound_ms", 0))
    return None if not ms else bound / ms


def _bound(n_bytes: float, f32_ops: float, f64_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rates."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = f32_ops / PEAK_F32 + f64_ops / PEAK_F64
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def local_flow_bound(k: int, n_chain: int, band_rows: int, rows: int,
                     Ha: int, band_cols: int | None = None) -> dict:
    """Bound of one local-flow call: it reads the chain and the center
    (int32 [band_rows, band_cols] each; band_cols = Ha but for a tile)
    once and writes five 4-byte [rows, Ha] maps. Its f32 operations per pixel: for each of the 9 candidates, k^2
    cells of (d, sum), a division and a compare; k^2 cells of the winner's
    sums (d, yv, 5 products, 8 sums); 46 for the adjugate solve; k^2 cells
    of the inlier test (d, yv, 2 products, 2 sums, abs, compare). The
    chain fold's compares are integer and not counted."""
    per_pixel = 9 * (2 * k * k + 2) + 15 * k * k + 46 + 8 * k * k
    return _bound((n_chain + 1) * band_rows * (band_cols or Ha) * 4
                  + 5 * rows * Ha * 4, per_pixel * rows * Ha)


def aperture_bound(n_scales: int, rows: int, Ha: int,
                   integ_rows: int = 0, integ_cols: int = 0) -> dict:
    """Bound of one aperture call. Whole sensor: it reads flow_len, vx and
    vy and writes tvx, tvy and scale (4-byte [rows, Ha] maps each), and
    builds the float64 integral on the way (f32: 3 products and a compare
    per pixel; f64: 2 sums for each of 4 fields). Band mode: it reads the
    float64 band [4, integ_rows, integ_cols] (integ_cols = Ha + 1 but for
    a tile's band) and flow_vx/vy. Per pixel and scale: 4 fields x 3 f64
    corner sums; f32: a compare, 3 divisions and a compare; one more
    compare per pixel."""
    px = rows * Ha
    if integ_rows:
        return _bound(4 * integ_rows * (integ_cols or Ha + 1) * 8
                      + 5 * px * 4, (5 * n_scales + 1) * px,
                      12 * n_scales * px)
    return _bound(6 * px * 4, (4 + 5 * n_scales + 1) * px,
                  (8 + 12 * n_scales) * px)


def pool_l2_bytes(shape: dict, n_scales: int, rows: int, Ha: int,
                  n_won: int) -> tuple:
    """The bytes one pool call reads from L2 by its design (its tile and
    strips, kernels.aperture_shape): each block's copies, float64 count
    and length at 4 corner kinds, of the whole rectangle at the first
    scale and of the strip each later scale gains; and the vx and vy
    corners of the winning scale (8 float64) at each of the n_won pixels
    whose best mean length is > 0. Returns (slab bytes, winner bytes)."""
    tx, ty = shape["tile_rows"], shape["tile_cols"]
    jx, jy = shape["strip_rows"], shape["strip_cols"]
    cells = tx * ty + (n_scales - 1) * (jx * ty + (tx - jx) * jy)
    blocks = -(-rows // tx) * -(-Ha // ty)
    return blocks * 8 * cells * 8, n_won * 8 * 8


def integral_bound(rows: int, cols: int, dadd: dict | None = None) -> dict:
    """Bound of one integral call: it reads flow_len, vx and vy (4-byte
    [rows, cols] maps) and writes the float64 [4, rows + 1, cols + 1]
    integral; per pixel a compare and 3 products in f32 and, for each of 4
    fields, 2 sums in f64. With `dadd` (_dadd_latency) also its chain
    bound: the plain order's longest chain of dependent float64 adds,
    rows down a column then cols along a row, at the add's latency and
    the SM clock's maximum."""
    px = rows * cols
    out = _bound(3 * px * 4 + 4 * (rows + 1) * (cols + 1) * 8, 4 * px,
                 8 * px)
    if dadd:
        out["chain_bound_ms"] = ((rows + cols) * dadd["dadd_latency_cycles"]
                                 / (dadd["sm_clock_max_mhz"] * 1e3))
    return out


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


def _kernels_per_call(fn, calls: int = 10, traces: int = 5) -> int:
    """Device kernels of `calls` calls of fn in torch.profiler's
    device-side events: up to `traces` traces, until one holds one event
    a call or more (a trace now and then drops events), after checking
    that every kernel of every trace has one name. Returns the events of
    the fullest trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
        if len(set(names)) > 1:
            raise AssertionError(f"kernels of one call: {set(names)}")
        most = max(most, len(names))
        if most >= calls:
            break
    return most


def check_integral(dev) -> dict:
    """Phase 2's integral: the kernel against the plain integral at every
    shape of INTEGRAL_SHAPES, bit for bit on the card and on the CPU, on
    the main path's kind of fields and on fields whose float64 sums round,
    one launch counted and one device kernel a call; at the sensor and the
    quirk geometry, the cells where CUDA's own innermost-dimension cumsum
    departs from the sequential order; the device time of the first
    INTEGRAL_TIMED shapes beside the bytes bound and the chain bound (the
    card's float64 add latency, measured here). Returns the 320 x 320
    case's times and bounds."""
    import torch
    from farms_tpu_torch.ops import dense_flow as plain
    from farms_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    dadd = _dadd_latency()
    _phase("float64 add latency", t0,
           f"{dadd['dadd_latency_cycles']:.3f} cycles (runs "
           f"{dadd['dadd_latency_runs']}), SM clock max "
           f"{dadd['sm_clock_max_mhz']:.0f} MHz")
    result = None
    for i, (W, H) in enumerate(INTEGRAL_SHAPES):
        t0 = time.perf_counter()
        for arrays in (_flow_fields(W, H, 3), _wide_fields(W, H, 4)):
            cin = [torch.from_numpy(a) for a in arrays]
            din = [a.to(dev) for a in cin]
            kernels.reset_launches()
            got = kernels.integral(*din)
            if kernels.LAUNCHES["integral"] != 1 or sum(
                    kernels.LAUNCHES.values()) != 1:
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
        # one kernel name, never more events than calls (where a trace
        # drops events, fewer)
        n = _kernels_per_call(lambda: kernels.integral(*din), calls=10)
        if not 0 < n <= 10:
            raise AssertionError(f"integral {W}x{H}: {n} device kernels "
                                 f"in 10 calls")
        line = (f"equal bit for bit to plain on the card and on the cpu "
                f"(main-path and wide fields); max_abs_err 0.0; one device "
                f"kernel, {n} recorded in 10 calls")
        if (W, H) in ((SENSOR, SENSOR), (260, 346)):
            # CUDA's own cumsum over the innermost dimension (a parallel
            # scan) against the sequential order, on the wide fields
            gate = (din[0] > 0).to(torch.float32)
            stack = torch.stack([gate, din[0] * gate, din[1] * gate,
                                 din[2] * gate]).to(torch.float64)
            inner = torch.cumsum(torch.cumsum(stack, 1), 2)
            departs = int((inner.view(torch.int64)
                           != want[:, 1:, 1:].contiguous().view(torch.int64))
                          .sum())
            line += (f"; on fields whose float64 sums round, torch.cumsum "
                     f"over the innermost dimension on the card departs "
                     f"from the sequential order in {departs} of "
                     f"{inner.numel()} cells")
        if i < INTEGRAL_TIMED:
            ins = [torch.from_numpy(a).to(dev)
                   for a in _flow_fields(W, H, 3)]
            device_ms = _device_ms(lambda: kernels.integral(*ins))
            bound = integral_bound(W, H, dadd)
            line += (f"; device {_fmt_ms(device_ms)}, bytes bound "
                     f"{bound['bound_ms']:.6f} ms, chain bound "
                     f"{bound['chain_bound_ms']:.6f} ms")
            if (W, H) == (SENSOR, SENSOR):
                ms = _median_ms(lambda: kernels.integral(*ins))
                plain_ms = _median_ms(lambda: plain.build_integral(*ins))
                library_ms = _median_ms(lambda: _library_integral(*ins))
                result = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                              library_ms=library_ms, **bound,
                              dadd_latency_cycles=dadd["dadd_latency_cycles"],
                              sm_clock_max_mhz=dadd["sm_clock_max_mhz"])
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"library (torch.cumsum over both axes, float64) "
                         f"{library_ms:.4f} ms")
        _phase(f"kernel integral {W}x{H}", t0, line)
    return result


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

    results["integral"] = check_integral(dev)
    for (W, H, quirk) in ((SENSOR, SENSOR, False), (260, 346, True)):
        cfg = FlowConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
        ins = [torch.from_numpy(a).to(dev) for a in _flow_fields(W, H, 3)]
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
        # the pool alone reads the float64 integral from device memory
        pool_bound = aperture_bound(cfg.num_scales, W, H,
                                    integ_rows=W + 1)["bound_ms"]
        pool_share = pool_bound / pool_ms if pool_ms else None
        shape = kernels.aperture_shape(W, H, cfg.window_jump)
        n_won = int((plain.dense_aperture(*ins, cfg, want_ids=True)[3]
                     .amax(0) > 0).sum())
        slab_b, win_b = pool_l2_bytes(shape, cfg.num_scales, W, H, n_won)
        if (W, H) == (SENSOR, SENSOR):
            results["aperture"] = dict(
                ms=ms, device_ms=device_ms, pool_device_ms=pool_ms,
                plain_ms=plain_ms, **aperture_bound(cfg.num_scales, W, H),
                pool_bound_ms=pool_bound, pool_share=pool_share)
        _phase(f"kernel aperture {W}x{H} quirk={quirk}", t0,
               f"equal to plain ({cfg.num_scales} scales, {pooled} pixels "
               f"pooled past scale 0); max_abs_err {err}; kernel {ms:.4f} "
               f"ms (device: the pass {_fmt_ms(device_ms)}, its pool "
               f"{_fmt_ms(pool_ms)}), plain {plain_ms:.4f} ms; the pool's "
               f"own bound {pool_bound:.6f} ms (float64 integral from "
               f"device memory), share {pool_share}; its L2 reads a pass "
               f"by design ({shape}): slabs {slab_b / 1e6:.2f} MB + winner "
               f"corners {win_b / 1e6:.2f} MB ({n_won} pixels), against "
               f"{W * H * cfg.num_scales * 128 / 1e6:.2f} MB read corner by "
               f"corner for 4 fields")
    results["decode_wire"], errs["decode_wire"] = check_decode_wire(dev)
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        r["share"] = _share(r)
    return results


def _wire(rng, steps: int, k: int, C: int):
    """A seeded wire (int32 [steps, C, k], uint8 [steps, k]) of the main
    path's kind: flow components up to 3000 px/s in magnitude, zero at a
    third of the lanes, and a hundredth of them NaN, +-Inf, +-0 or
    subnormal; every aux byte. f16 halves packed in pairs (C = 2) or f32
    words (C = 4)."""
    n = steps * k
    comp = rng.uniform(-3000, 3000, (4, n)).astype(np.float32)
    comp[rng.random((4, n)) < 0.33] = 0
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-7, -3e-8],
                       np.float32)
    pick = rng.random((4, n)) < 0.01
    comp[pick] = special[rng.integers(0, special.size, int(pick.sum()))]
    if C == 2:
        h = comp.astype(np.float16).view(np.uint16).astype(np.uint32)
        words = np.stack([h[0] | h[1] << 16, h[2] | h[3] << 16])
    else:
        words = comp.view(np.uint32)
    main = np.ascontiguousarray(
        words.view(np.int32).reshape(C, steps, k).transpose(1, 0, 2))
    aux = rng.permutation(np.tile(np.arange(256, dtype=np.uint8),
                                  -(-n // 256))[:n])
    return main, aux.reshape(steps, k)


def _wire_columns_against(label, block, want, main, C):
    """decode_wire's [7, count] block (host) against decode_wire_columns'
    columns `want` of the same wire (main rows [C, count]): vx, vy and
    scale bit for bit, r_true and r_local bit for bit but for NaN payloads
    (the same lanes NaN), theta_true and theta_local within ATAN2F_ULP
    ulps of float64 atan2 with NumPy's NaNs and signs. Returns the largest
    absolute difference from NumPy's columns on lanes not NaN."""
    from farms_tpu_torch.ops import kernels
    got = {name: block[r].view(np.int32) if name == "scale" else block[r]
           for r, name in enumerate(kernels.WIRE_COLUMNS)}
    for name in ("vx", "vy", "scale"):
        if got[name].tobytes() != want[name].tobytes():
            raise AssertionError(f"{label} {name}: differs from "
                                 f"decode_wire_columns")
    if C == 2:
        u = main.view(np.uint32)
        comp = [(u[r // 2] >> (16 * (r % 2)) & 0xFFFF).astype(np.uint16)
                .view(np.float16).astype(np.float64) for r in range(4)]
    else:
        comp = [main[r].view(np.float32).astype(np.float64)
                for r in range(4)]
    err = 0.0
    for name, y, x in (("r_true", None, None), ("r_local", None, None),
                       ("theta_true", comp[3], comp[2]),
                       ("theta_local", comp[1], comp[0])):
        g, w = got[name], want[name]
        nan = np.isnan(w)
        if not (np.isnan(g) == nan).all():
            raise AssertionError(f"{label} {name}: NaN lanes differ")
        g, w = g[~nan], w[~nan]
        with np.errstate(invalid="ignore"):         # inf - inf where equal
            err = max(err, float(np.where(g == w, 0.0, np.abs(
                g.astype(np.float64) - w)).max(initial=0)))
        if y is None:
            if g.tobytes() != w.tobytes():
                raise AssertionError(f"{label} {name}: differs from "
                                     f"decode_wire_columns")
            continue
        if not (np.signbit(g) == np.signbit(w)).all():
            raise AssertionError(f"{label} {name}: signs differ")
        # theta_local is 0 on invalid lanes: held against 0 there
        with np.errstate(invalid="ignore"):
            ref = np.where(w == 0, 0.0, np.arctan2(y, x)[~nan])
        ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
        worst = float((np.abs(g - ref) / ulp).max(initial=0))
        if worst > ATAN2F_ULP:
            raise AssertionError(f"{label} {name}: {worst} ulps from "
                                 f"atan2")
    return err


def check_decode_wire(dev):
    """Phase 2's wire decode: decode_wire on the card against its plain
    version, decode_wire_columns (NumPy), on the same wire: a main-path
    call (WIRE_CALL_LANES lanes) of the f16 and the f32 wire, and an
    unaligned tail of it (WIRE_TAIL: the lane path), one launch and one
    device kernel a call; then, on the f16 wire of a replay batch
    (WIRE_TIMED_LANES in 8 calls' steps), the wrapper's CUDA-event time,
    the kernel's device time with the L2 cache flushed by a read before
    each launch, NumPy's time on the host, and the bytes bound (9 bytes
    read, 28 written a lane). Returns (that case's entry, the largest max
    abs error)."""
    import torch
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.ops import dense_flow as plain
    from farms_tpu_torch.ops import kernels

    rng = np.random.default_rng(17)
    err = 0.0
    for C in (2, 4):
        t0 = time.perf_counter()
        cfg = FlowConfig(wire="f32" if C == 4 else "f16")
        main, aux = _wire(rng, 1, WIRE_CALL_LANES, C)
        dm, da = (torch.from_numpy(a).to(dev) for a in (main, aux))
        flat = main.transpose(1, 0, 2).reshape(C, -1)
        for label, (offset, count) in (("call", (0, WIRE_CALL_LANES)),
                                       ("unaligned tail", WIRE_TAIL)):
            out = torch.full((7, offset + count), float("nan"), device=dev)
            kernels.reset_launches()
            kernels.decode_wire(dm, da, out, offset, count, cfg.window_jump)
            if kernels.LAUNCHES["decode_wire"] != 1 or sum(
                    kernels.LAUNCHES.values()) != 1:
                raise AssertionError(f"decode_wire: launches "
                                     f"{kernels.LAUNCHES}")
            want = plain.decode_wire_columns(flat[:, :count],
                                             aux.reshape(-1)[:count], cfg)
            block = out.cpu().numpy()
            if not np.isnan(block[:, :offset]).all():
                raise AssertionError("decode_wire wrote before its offset")
            err = max(err, _wire_columns_against(
                f"decode_wire {cfg.wire} {label}", block[:, offset:].copy(),
                want, flat[:, :count], C))
        n = _kernels_per_call(lambda: kernels.decode_wire(
            dm, da, out, 0, WIRE_TAIL[1], cfg.window_jump), calls=10)
        if not 0 < n <= 10:
            raise AssertionError(f"decode_wire: {n} device kernels in 10 "
                                 f"calls")
        _phase(f"kernel decode_wire {cfg.wire}", t0,
               f"a call of {WIRE_CALL_LANES} lanes and an unaligned tail "
               f"({WIRE_TAIL[1]} lanes at column {WIRE_TAIL[0]}): vx, vy, "
               f"scale, r_true, r_local equal to decode_wire_columns (NaN "
               f"lanes as NaN), theta within {ATAN2F_ULP} ulps of atan2; "
               f"max_abs_err {err}; one device kernel, {n} recorded in 10 "
               f"calls")
    t0 = time.perf_counter()
    cfg = FlowConfig(wire="f16")
    n = WIRE_TIMED_LANES
    main, aux = _wire(rng, 8, n // 8, 2)
    dm, da = (torch.from_numpy(a).to(dev) for a in (main, aux))
    out = torch.empty((7, n), device=dev)
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)

    def run():
        return kernels.decode_wire(dm, da, out, 0, n, cfg.window_jump)

    def flushed():
        flush.max()
        return run()

    ms = _median_ms(run)
    device_ms = _device_ms(flushed, "decode_wire")
    flat = main.transpose(1, 0, 2).reshape(2, -1)
    host = []
    for _ in range(5):
        s0 = time.perf_counter()
        plain.decode_wire_columns(flat, aux.reshape(-1), cfg)
        host.append(time.perf_counter() - s0)
    plain_ms = float(np.median(host)) * 1e3
    bound = _bound(37 * n, 0)
    _phase("kernel decode_wire timed", t0,
           f"{n} lanes of the f16 wire: kernel {ms:.4f} ms (CUDA events, "
           f"warm L2; device, L2 flushed {_fmt_ms(device_ms)}), NumPy "
           f"{plain_ms:.4f} ms on the host; bytes bound "
           f"{bound['bound_ms']:.6f} ms")
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, **bound), err


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


def _tile_cut(arr, tile, h):
    """Tile (row0, rows, col0, cols) of a [..., W, H] array with h cells
    more on each side in both axes, zero past the sensor edge (what the
    spatial engine's row and column exchanges give each rank)."""
    r0, rows, c0, cols = tile
    pad = [(0, 0)] * (arr.ndim - 2) + [(h, h), (h, h)]
    return np.ascontiguousarray(
        np.pad(arr, pad)[..., r0:r0 + rows + 2 * h, c0:c0 + cols + 2 * h])


def _tiles(W, H, shape):
    """(row0, rows, col0, cols) of each tile of a (tx, ty) grid, in rank
    order (tile (r % tx, r // tx))."""
    tx, ty = shape
    rows, cols = W // tx, H // ty
    return [((r % tx) * rows, rows, (r // tx) * cols, cols)
            for r in range(tx * ty)]


def _tile_geoms(make_cfg, make_inputs, whole_of):
    """For each sensor and grid of TILE_GRIDS: (cfg padded to the grid,
    shape, its tiles, the inputs padded to the array geometry (pad cells
    never written), whole_of(inputs, cfg): the whole-sensor outputs)."""
    geoms = []
    for W, H, shapes in TILE_GRIDS:
        for shape in shapes:
            cfg = make_cfg(W, H).padded_to(*shape)
            Wa, Ha = cfg.array_width, cfg.array_height
            ins = [np.ascontiguousarray(np.pad(
                a, [(0, 0)] * (a.ndim - 2) + [(0, Wa - W), (0, Ha - H)]))
                for a in make_inputs(W, H)]
            geoms.append((cfg, shape, _tiles(Wa, Ha, shape), ins,
                          whole_of(ins, cfg)))
    return geoms


def check_tile_kernels(dev):
    """Phase 3b: the kernels' tile modes (the 2-D tiles of the spatial
    engine, farms_tpu_torch/parallel/tiling.py) on the tiles of TILE_GRIDS:
    the 320 x 320 sensor in (2, 2) and (4, 2) tiles of 160 x 160 and 80 x
    160, and 260 x 346 (padded to 260 x 348, as the engine pads it) in
    (1, 4) tiles of 260 x 87. Local flow at k = 3, 5 and 7 in default mode
    (chains of 1 and, at k = 5, 8 surfaces) and correction mode (chains
    of 3), each tile with its R exchanged rows and columns (cut from the
    zero-padded surfaces); the pool on each tile's band of the whole
    float64 integral, pre-clamped in y (dense_flow.tile_band), with and
    without the y-clamp quirk (at 260 x 346 it clamps y at 260, inside
    the last tile's band). Each tile's kernel output must equal the plain
    tile mode on the card and the whole-sensor kernel's cells bitwise.
    Each case is timed on one tile of each grid (device ms, median of 30,
    against its bound). Returns, for each kernel, its main case's times,
    bound and share on a (2, 2) tile at 320 x 320, and the largest max abs
    error."""
    import torch
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.ops import dense_flow as plain
    from farms_tpu_torch.ops import kernels

    errs = {name: 0.0 for name in kernels.LAUNCHES}
    results = {}

    def tile_case(label, name, geoms, run, bound, names):
        """run(fn, ins, cfg, tile) computes a tile with the kernel (fn
        None) or its plain version. Returns the (2, 2) tile's times."""
        t0 = time.perf_counter()
        said, main = [], None
        for cfg, shape, tiles, ins, whole in geoms:
            for tile in tiles:
                r0, rows, c0, cols = tile
                kernels.reset_launches()
                got = run(None, ins, cfg, tile)
                if kernels.LAUNCHES[name] != 1 or sum(
                        kernels.LAUNCHES.values()) != 1:
                    raise AssertionError(f"{label} {shape} {tile}: "
                                         f"launches {kernels.LAUNCHES}")
                want = run(plain, ins, cfg, tile)
                torch.cuda.synchronize()
                what = f"{label} {cfg.width}x{cfg.height} {shape} {tile}"
                errs[name] = max(errs[name], _compare(what, got, want,
                                                      names))
                _compare(f"{what} vs whole-sensor cells", got,
                         [w[r0:r0 + rows, c0:c0 + cols].contiguous()
                          for w in whole], names)
            tile = tiles[min(1, len(tiles) - 1)]     # an interior tile
            device_ms = _device_ms(lambda: run(None, ins, cfg, tile))
            entry = dict(device_ms=device_ms, **bound(cfg, tile))
            entry["share"] = _share(entry)
            if (cfg.width, shape) == (SENSOR, (2, 2)):
                entry["ms"] = _median_ms(lambda: run(None, ins, cfg, tile))
                entry["plain_ms"] = _median_ms(lambda: run(plain, ins, cfg,
                                                           tile))
                main = entry
            said.append(f"{cfg.width}x{cfg.height} in {shape}: "
                        f"{len(tiles)} tiles of {tile[1]}x{tile[3]}, device "
                        f"{_fmt_ms(device_ms)}, bound "
                        f"{entry['bound_ms']:.6f} ms ({entry['bound_by']}), "
                        f"share {entry['share']}")
        _phase(f"tile kernel {label}", t0,
               f"every tile equal to the plain tile mode and to the "
               f"whole-sensor cells; max_abs_err {errs[name]}; "
               f"{'; '.join(said)}; the (2, 2) tile at {SENSOR}: kernel "
               f"{main['ms']:.4f} ms, plain {main['plain_ms']:.4f} ms")
        return main

    def put(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # a tile's kernel inputs on the card, built once outside the timed
    # calls; keyed by its case's input array, so cleared with each case
    cut = {}

    def tile_inputs(key, build):
        if key not in cut:
            cut[key] = build()
        return cut[key]

    for k, n, fold in ((3, 1, True), (5, 8, True), (7, 1, True),
                       (3, 3, False), (5, 3, False), (7, 3, False)):
        def inputs(W, H, k=k, n=n, fold=fold):
            surfs, t_post, rank2 = _stamp_chain(W, H, 300 + k + n, n)
            return surfs, t_post if fold else rank2

        def run(mod, ins, cfg, tile, fold=fold):
            R = cfg.support_radius
            fn = plain.local_flow_core if mod else kernels.local_flow
            bands = tile_inputs((id(ins[0]), tile), lambda: put(
                _tile_cut(a, tile, R) for a in ins))
            return fn(*bands, cfg, fold_center=fold, halo=R,
                      row_offset=tile[0], col_halo=R, col_offset=tile[2])

        def bound(cfg, tile, n=n):
            R = cfg.support_radius
            return local_flow_bound(cfg.filter_size, n, tile[1] + 2 * R,
                                    tile[1], tile[3], tile[3] + 2 * R)

        cut.clear()
        geoms = _tile_geoms(
            lambda W, H, k=k: FlowConfig(width=W, height=H, filter_size=k),
            inputs, lambda ins, cfg, fold=fold: kernels.local_flow(
                *put(ins), cfg, fold_center=fold))
        name = "local_flow" if k in (3, 5) else "local_flow_general"
        entry = tile_case(f"{name} k={k} chain={n} fold_center={fold}", name,
                          geoms, run, bound, LOCAL_NAMES)
        if n == 1 and fold:
            results[name] = entry

    for quirk in (False, True):
        def run_ap(mod, ins, cfg, tile):
            A = cfg.max_window + 1

            def build():
                r0, rows, c0, cols = tile
                dins = put(ins)
                band = plain.tile_band(plain.build_integral(*dins), *tile,
                                       A, plain.aperture_y_clip(cfg))
                return [a[r0:r0 + rows, c0:c0 + cols].contiguous()
                        for a in dins], band

            core, band = tile_inputs((id(ins[0]), tile), build)
            fn = plain.dense_aperture if mod else kernels.aperture
            return fn(*core, cfg, halo=A, col_halo=A, integ=band)

        def ap_bound(cfg, tile):
            A = cfg.max_window + 1
            return aperture_bound(cfg.num_scales, tile[1], tile[3],
                                  tile[1] + 2 * A + 1, tile[3] + 2 * A + 1)

        cut.clear()
        geoms = _tile_geoms(
            lambda W, H, quirk=quirk: FlowConfig(
                width=W, height=H, replicate_y_clamp_quirk=quirk),
            lambda W, H: _flow_fields(W, H, 8 + W),
            lambda ins, cfg: kernels.aperture(*put(ins), cfg))
        entry = tile_case(f"aperture tile quirk={quirk}", "aperture", geoms,
                          run_ap, ap_bound, APERTURE_NAMES)
        if not quirk:
            results["aperture"] = entry
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
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
    (the last call's padding steps too) and the per-event engine one wire
    decode a call, or, in serial mode, one integral launch per valid
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
         {"integral": -(-len(ev) // spc) * spc,
          "decode_wire": -(-len(ev) // spc)},
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


def _ran_on_card(label, run, want_launches, traces: int = 3):
    """run() inside a torch.profiler trace: the kernels the card ran, each
    counted by its name among the trace's device events
    (kernels.device_launches: a CUDA graph replay's kernels too), must be
    want_launches (0 for a kernel not named). Up to `traces` traces, as a
    trace now and then drops a device event. Returns (run's result, the
    counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from farms_tpu_torch.ops import kernels

    want = {k: want_launches.get(k, 0) for k in kernels.LAUNCHES}
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = run()
            torch.cuda.synchronize()
        seen = kernels.device_launches(prof.events())
        if seen == want:
            return result, seen
    raise AssertionError(f"{label}: the card ran kernels {seen}, expected "
                         f"{want}")


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
    """Launches of `steps` micro-steps at each preset through process():
    2 sub-phases per step, each a local-flow and an aperture pass (an
    integral and a pool), and the wire's decode on the card once a call
    (a call holds one step at chunk 131072); the fidelity preset adds one
    correction-mode local-flow pass per step."""
    ap = {"aperture": 2 * steps, "integral": 2 * steps,
          "decode_wire": steps}
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
    every kernel on one card), `--engine spatial --devices 1` (every tile
    mode: both column halos zero-filled), then `--engine dp --devices 1`
    and `--engine multihost --devices 1` (the single engine's micro_step
    on the event shard of one rank), through the CLI at both presets on
    the card. Each one's launch counts, and its output file equal byte for
    byte to the single engine's card run (at one rank the bands and the
    tile hold the whole sensor's values and the band and tile integrals
    are the whole float64 integral). Returns {label: (launches,
    rate)}."""
    from farms_tpu_torch.events.io import read_flow_txt

    steps = STREAM_EVENTS // 131072
    results = {}
    for engine in ("halo", "spatial", "dp", "multihost"):
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


def check_spatial_wide():
    """Phase 7b: the spatial engine at one rank (one tile, both halos
    zero-filled) in-process on harness config 5's 1280 x 720 sensor and
    stream (farms_tpu_torch/bench/harness.py `config5_inputs`): the same
    launches as the single engine's run, each in tile mode, and every
    column bit for bit equal. Returns (launches, events/s of the spatial
    run)."""
    from farms_tpu_torch.bench import harness
    from farms_tpu_torch.parallel import SpatialFlowEngine
    from farms_tpu_torch.pipeline.engine import FlowEngine, call_steps

    t0 = time.perf_counter()
    cfg, ev = harness.config5_inputs()
    ref = FlowEngine(cfg, device="cuda").process(ev)
    eng = SpatialFlowEngine(cfg, device="cuda")
    eng.process(ev[:2 * cfg.chunk_size])              # warm-up
    eng.reset()
    steps = -(-len(ev) // cfg.chunk_size)
    want = {"local_flow": steps * cfg.sub_phases,
            "aperture": steps * cfg.sub_phases,
            "integral": steps * cfg.sub_phases,
            "decode_wire": -(-steps // call_steps(cfg))}
    (got, wall), launches = _counted(
        "spatial 1280x720", lambda: _timed(lambda: eng.process(ev)), want)
    _same_columns("spatial 1280x720 (against the single engine)", got, ref)
    _phase("spatial 1280x720", t0,
           f"harness config 5's stream ({len(ev)} events, chunk "
           f"{cfg.chunk_size}) on one tile: launches {launches}, every "
           f"pass a tile-mode launch; every column bitwise equal to the "
           f"single engine; {len(ev) / wall:.1f} events/s")
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
        decode[wire].append(0.0)
        # the f16 wire decodes each call on the card, then builds the
        # output; the sparse wire re-expands its blocks on the host first
        for name in (("_unpack_outputs",) if wire == "sparse" else
                     ("_decode_call", "_flow_output")):
            def timed(*a, _fn=getattr(eng, name)):
                out, secs = _timed(lambda: _fn(*a))
                decode[wire][-1] += secs
                return out

            setattr(eng, name, timed)
        torch.cuda.synchronize()
        _, wall = _timed(lambda: eng.process(ev))
        rates[wire].append(len(ev) / wall)
    line = (f"[rates] wire f16 / sparse, benchmark, warmed process(): "
            f"{np.mean(rates['f16']):.1f} / {np.mean(rates['sparse']):.1f} "
            f"events/s (runs {rates}), of which decode "
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
    5-row decode on the card; on the card the call is one CUDA graph), its
    outputs decoded equal to process() on every column bit for bit, its
    launch counts (the engine's own, and the kernels a replay from the
    state before the first call ran on the card, counted from a profiler
    trace), and every replay equal to the first. Returns {label:
    (the card's launches in a replay, events/s of a timed replay)}."""
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
        want = {**want, "decode_wire": 0}
        (main, aux), _ = _counted(f"resident {preset}", fn, want)
        got = eng._unpack_outputs([(main, aux)], ev, n)
        _same_columns(f"resident {preset}", got, ref)

        def replay():
            eng.state = start
            return fn()

        (main1, aux1), launches = _ran_on_card(f"resident {preset}", replay,
                                               want)
        eng.state = start
        torch.cuda.synchronize()
        (main2, aux2), wall = _timed(lambda: (fn(), torch.cuda.synchronize())
                                     [0])
        if not all(torch.equal(a, b) for a, b in ((main, main1), (aux, aux1),
                                                  (main, main2), (aux, aux2))):
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


def _accuracy_reference(row) -> dict | None:
    """ACCURACY.json's bar row of the same (chunk, P, A, S, C, coarse
    chain); its early rows have no correction / coarse_chain key and ran
    with 0 / off."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ACCURACY.json")
    keys = ("chunk_size", "sub_phases", "aperture_sub_phases",
            "causal_snapshots")
    with open(path) as fh:
        rows = json.load(fh)["streams"]["bar"]["rows"]
    for r in rows:
        if (all(r[k] == row[k] for k in keys)
                and r.get("correction", 0) == row["correction"]
                and r.get("coarse_chain", False) == row["coarse_chain"]):
            return r
    return None


def check_accuracy(smi):
    """Phase 17: the accuracy sweep (farms_tpu_torch/bench/accuracy.py) on
    the 120,000-event bar stream: the float64 oracle's time, then the
    `benchmark` and `fidelity` rows through the port's FlowEngine on the
    card, each beside ACCURACY.json's row: the oracle's valid count must
    be the same and the validity agreement within ACCURACY_SLACK; the
    kernels launched. Returns {label: (launches, events/s)}."""
    from farms_tpu_torch.bench import accuracy
    from farms_tpu_torch.config import FlowConfig

    t0 = time.perf_counter()
    ev = accuracy.make_stream("bar", 120_000)
    orc = accuracy.oracle_cached(ev, FlowConfig(width=SENSOR, height=SENSOR),
                                 "bar")
    _phase("accuracy oracle", t0, f"{len(ev)} bar events, "
           f"{int((orc['r_local'] > 0).sum())} valid (float64 NumPy oracle, "
           f"cache {os.path.relpath(accuracy.CACHE_DIR)})")
    results = {}
    for preset, (m, P, A, S, C, coarse) in ACCURACY_PRESETS.items():
        t0 = time.perf_counter()
        (row, _, dt), launches = _counted(
            f"accuracy {preset}",
            lambda: accuracy.run_row(ev, orc, chunk_size=m, sub_phases=P,
                                     aperture_sub_phases=A,
                                     causal_snapshots=S, correction=C,
                                     coarse_chain=coarse, device="cuda"),
            _preset_launches(-(-len(ev) // m))[preset])
        ref = _accuracy_reference(row)
        if ref is None:
            raise AssertionError(f"accuracy {preset}: no ACCURACY.json row "
                                 f"for {row}")
        if row["n_valid_oracle"] != ref["n_valid_oracle"]:
            raise AssertionError(f"accuracy {preset}: the oracle has "
                                 f"{row['n_valid_oracle']} valid events, "
                                 f"ACCURACY.json {ref['n_valid_oracle']}")
        gap = row["valid_agreement"] - ref["valid_agreement"]
        print(f"[accuracy] {preset} port {json.dumps(row)} card {smi}",
              flush=True)
        print(f"[accuracy] {preset} ACCURACY.json (backend tpu) "
              f"{json.dumps(ref)}", flush=True)
        if not abs(gap) <= ACCURACY_SLACK:
            raise AssertionError(f"accuracy {preset}: validity agreement "
                                 f"{row['valid_agreement']} against "
                                 f"{ref['valid_agreement']}")
        results[f"accuracy {preset}"] = (launches, len(ev) / dt)
        _phase(f"accuracy {preset}", t0,
               f"validity agreement {row['valid_agreement']:.6f} against "
               f"ACCURACY.json's {ref['valid_agreement']:.6f} ({gap:+.6f}); "
               f"scale match {row['scale_match']:.6f} against "
               f"{ref['scale_match']:.6f}; AEE {row['aee_true_px_per_ms']} "
               f"against {ref['aee_true_px_per_ms']} px/ms; launches "
               f"{launches}")
    return results


def _with_env(env, fn):
    """fn() with the environment variables `env` set, then restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _launched(label, run, needed=("local_flow", "aperture", "integral")):
    """run() with every launch count set to 0 just before it; each
    `needed` kernel must launch. Returns (run's result, the counts)."""
    import torch
    from farms_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    result = run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if min(launches[k] for k in needed) < 1:
        raise AssertionError(f"{label}: launch counts {launches}")
    return result, launches


def check_driver(smi):
    """Phase 18: the benchmark line (farms_tpu_torch/bench/driver.py) at
    DRIVER_ENV's reduced call counts: one JSON line with the three lanes,
    printed with the card, every rate positive and the fidelity lane's
    agreement in (0, 1]. Returns {label: (launches, events/s)}."""
    from farms_tpu_torch.bench import driver

    t0 = time.perf_counter()
    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            return _with_env(DRIVER_ENV, lambda: driver.main([]))

    rc, launches = _launched("driver", run)
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"driver: rc {rc}, output {lines}")
    line = json.loads(lines[0])
    print(f"[driver] {lines[0]} card {smi}", flush=True)
    rates = ("value", "e2e_events_per_second", "fidelity_events_per_second")
    if (min(line[k] for k in rates) <= 0 or line["card"] != smi
            or not 0 < line["fidelity_validity_agreement"] <= 1):
        raise AssertionError(f"driver: {line}")
    _phase("driver", t0, f"{DRIVER_ENV}: device lane {line['value']} ev/s, "
           f"fidelity {line['fidelity_events_per_second']} ev/s (agreement "
           f"{line['fidelity_validity_agreement']}), e2e "
           f"{line['e2e_events_per_second']} ev/s; launches {launches}")
    return {"driver": (launches, line["value"])}


def check_device_sweep(smi):
    """Phase 19: the device sweep (farms_tpu_torch/bench/device_sweep.py)
    on DEVICE_SWEEP_CONFIGS, one JSON line each with the card. Returns
    {label: (launches, events/s)}."""
    from farms_tpu_torch.bench import device_sweep

    results = {}
    for config in DEVICE_SWEEP_CONFIGS:
        t0 = time.perf_counter()
        (line,), launches = _launched(
            f"device sweep {config}",
            lambda: list(device_sweep.sweep([config], device="cuda")))
        print(f"[device sweep] {json.dumps(line)}", flush=True)
        if line["device_ev_per_s"] <= 0 or line["card"] != smi:
            raise AssertionError(f"device sweep: {line}")
        label = "device sweep P={} A={} S={} C={}".format(*config)
        results[label] = (launches, line["device_ev_per_s"])
        _phase(label, t0, f"{line['device_ev_per_s']} events/s; launches "
               f"{launches}")
    return results


def _scaling_rows(devices, replay_events):
    """The scaling sweep (farms_tpu_torch/bench/scaling.py) at its default
    configuration on `devices` ranks, every engine; each row printed.
    Rows whose resident replay differs from process() raise in the
    sweep."""
    from farms_tpu_torch.bench import scaling
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.events.io import synthetic_random_events

    cfg = FlowConfig(width=1024, height=128, max_window=20, chunk_size=2048,
                     steps_per_scan=4)
    ev = synthetic_random_events(2048 * 4 * 8, width=1024, height=128,
                                 rate_hz=5e6)
    rows = scaling.sweep(cfg, ev, devices, device="cuda",
                         replay_events=replay_events)
    for name, rs in rows.items():
        for r in rs:
            if not r["events_per_sec"] > 0:
                raise AssertionError(f"scaling {name}: {r}")
    return rows


def check_scaling(smi):
    """Phase 20: the scaling sweep at N = 1 (the single engine, every
    engine's first row): its resident replay bit for bit its process(),
    its rate with the card. Returns {label: (launches, events/s)}."""
    t0 = time.perf_counter()
    rows, launches = _launched("scaling n=1",
                               lambda: _scaling_rows([1], SCALING_REPLAY))
    rate = rows["halo"][0]["events_per_sec"]
    print(f"[scaling] n=1 {json.dumps(rows['halo'][0])} card {smi}",
          flush=True)
    _phase("scaling n=1", t0, f"FlowEngine process_resident at 1024 x 128: "
           f"{rate} events/s, equal to process() bit for bit; launches "
           f"{launches}")
    return {"scaling n=1": (launches, rate)}


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
    """"single", "dp" (every rank), "spatial" (x tiles over every rank),
    ("spatial", (tx, ty)) tiles, or a (tx, ev) multihost grid."""
    from farms_tpu_torch.parallel import (MultiHostFlowEngine,
                                          ShardedFlowEngine,
                                          SpatialFlowEngine, mesh)
    from farms_tpu_torch.pipeline.engine import FlowEngine

    if kind == "single":
        return FlowEngine(cfg, device="cuda")
    if kind == "dp":
        return ShardedFlowEngine(cfg, device="cuda")
    if kind == "spatial":
        return SpatialFlowEngine(cfg, device="cuda")
    if kind[0] == "spatial":
        return SpatialFlowEngine(cfg, mesh_shape=kind[1], device="cuda")
    return MultiHostFlowEngine(cfg, mesh=mesh.make_global_mesh(*kind),
                               device="cuda")


def _kind_label(kind) -> str:
    if isinstance(kind, str):
        return kind
    if kind[0] == "spatial":
        return f"spatial {kind[1][0]}x{kind[1][1]}"
    return f"multihost {kind[0]}x{kind[1]}"


def spatial_rank(shape, base=None):
    """One rank of a (tx, ty) grid of the spatial engine (parallel/mesh.py
    `run` entry point) on the stream at `base` at the benchmark preset,
    or with base None on harness config 5's 1280 x 720 stream. Returns
    rank 0's FlowOutput."""
    from farms_tpu_torch.bench import harness
    from farms_tpu_torch.events.io import load_events_txt

    if base is None:
        cfg, ev = harness.config5_inputs()
    else:
        cfg, ev = _preset_config(base), load_events_txt(base)
    return _make_engine(("spatial", shape), cfg).process(ev)


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
    """The single, dp, multihost and spatial engines at one rank,
    in-process, at both presets: events/s of a warmed process() over the stream and
    device-busy ms per 1M events (torch.profiler). Returns {label:
    events/s}."""
    from farms_tpu_torch.events.io import load_events_txt

    ev = load_events_txt(base)
    rates = {}
    for preset in ("benchmark", "fidelity"):
        cfg = _preset_config(base, preset)
        for kind in ("single", "dp", (1, 1), "spatial"):
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
        for engine in ("halo", "spatial", "dp"):
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
        got = mesh.run(spatial_rank, 4, "cuda", (2, 2), base)
        said = _compare_with_single(
            "nccl spatial (2, 2)",
            write_flow_txt(got, os.path.join(work, "spatial22")), ref,
            ref_lines, passes, cfg)
        _phase("nccl spatial (2, 2)", t0, f"SpatialFlowEngine(mesh_shape=(2, "
               f"2)) on 4 cards, 160 x 160 tiles: {said}")
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
    if cards >= 4:
        t5 = time.perf_counter()
        got = mesh.run(spatial_rank, 4, "cuda", (2, 2))
        said5 = _compare_with_single(
            "spatial (2, 2) 1280x720",
            write_flow_txt(got, os.path.join(work, "config5_spatial")),
            single5, ref5_lines, passes, cfg5)
        _phase("nccl spatial (2, 2) 1280x720", t5,
               f"SpatialFlowEngine(mesh_shape=(2, 2)) on 4 cards, 640 x 360 "
               f"tiles, harness config 5's stream: {said5}")
    rates["harness config 5"] = res.events_per_sec
    paths["harness config 5"] = (launches, res.events_per_sec)
    _phase("harness config 5", t0, f"the halo engine's process_resident "
           f"over {cards} ranks, one a card: launches {counts[0]} on each "
           f"rank; a replay from the start state gathered and decoded, "
           f"against the single engine's process(): {said}")
    t0 = time.perf_counter()
    devices = [1] + [n for n in (2, 4) if n <= cards]
    rows = _scaling_rows(devices, SCALING_REPLAY)
    for name, rs in rows.items():
        for r in rs[1:]:
            print(f"[scaling] {name} n={r['devices']} {json.dumps(r)} card "
                  f"{smi}", flush=True)
            rates[f"scaling {name} n={r['devices']}"] = r["events_per_sec"]
    _phase("nccl scaling", t0, f"the scaling sweep at N = {devices}: every "
           f"engine's resident replay bit for bit its process(); lanes "
           f"unlike the single engine "
           f"{ {n: [r['lanes_unlike_single'] for r in rs] for n, rs in rows.items()} }")
    t0 = time.perf_counter()
    rate, per_m, wall = _engine_rate(_make_engine("single", cfg), ev)
    _rate_line("single", "benchmark", 1, rate, per_m, wall, smi)
    rates["single benchmark ranks=1"] = rate
    _phase("rates single ranks=1", t0, f"{rate:.1f} events/s")
    for n in (2, 4):
        if n > cards:
            break
        kinds = ["dp", (2, n // 2), ("spatial", (n, 1))]
        if n == 4:
            kinds.append(("spatial", (2, 2)))
        for kind in kinds:
            t0 = time.perf_counter()
            label = _kind_label(kind)
            rate, per_m, wall = mesh.run(rank_rate, n, "cuda", kind, base,
                                         "benchmark")
            _rate_line(label, "benchmark", n, rate, per_m, wall, smi)
            rates[f"{label} benchmark ranks={n}"] = rate
            _phase(f"rates {label} ranks={n}", t0, f"{rate:.1f} events/s")
    return rates, paths


def check_perevent_cli(base):
    """`--backend perevent --preset benchmark` through the CLI on the
    card and the CPU: the per-event path runs the integral kernel once a
    phase (8 steps x 2 phases), the wire's decode once a call, and no
    other kernel. Returns (launches, rate)."""
    steps = STREAM_EVENTS // 131072
    return _cli_path("perevent benchmark",
                     _stream_argv(base, "benchmark") + ["--backend",
                                                        "perevent"],
                     base, STREAM_EVENTS, {"integral": 2 * steps,
                                           "decode_wire": steps})


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
    tile_timings = check_tile_kernels(dev)
    check_oracle(dev)
    with tempfile.TemporaryDirectory() as work:
        base = write_stream(work)
        nativeio.reset_calls()
        paths, card_files = check_main_paths(base, work)
        cli_calls = dict(nativeio.CALLS)
        paths.update(check_engine_paths(base, card_files))
        paths["padded benchmark"] = check_padded(base)
        paths["spatial 1280x720"] = check_spatial_wide()
        check_native(base, work, card_files, cli_calls)
        paths.update(check_stream(base, work, card_files))
        paths["sparse benchmark"] = check_sparse(base, card_files, smi)
        paths.update(check_resident(base))
        paths.update(check_harness(smi))
        paths.update(check_accuracy(smi))
        paths.update(check_driver(smi))
        paths.update(check_device_sweep(smi))
        paths.update(check_scaling(smi))
        rates, nccl_paths = check_nccl(base, work, smi)
        paths.update(nccl_paths)
        paths["perevent benchmark"] = check_perevent_cli(base)
        paths["serial"] = check_serial_cli(base, dev)
        path_rates = check_rates(base, smi)
        path_rates.update(check_engine_rates(base, smi))
    rates.update({label: rate for label, (_, rate) in paths.items()})
    entries = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        by_path = {label: counts[name]
                   for label, (counts, _) in paths.items()}
        halo = {f"halo{k}" if k.startswith("1_") else f"halo_{k}": v
                for k, v in halo_timings.get(name, {}).items()}
        halo.update({f"tile_{k}": v
                     for k, v in tile_timings.get(name, {}).items()})
        entries.append(dict(
            name=name, route="cuda",
            source=f"farms_tpu_torch/csrc/{src}",
            replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            library_ms=timings[name].pop("library_ms", None),
            **timings[name], **halo))
    print(f"[rates] [Benchmark Main] events/sec by path: {rates}")
    print(f"[rates] process() events/sec, per-event and dense, and the "
          f"single, dp, multihost and spatial engines: {path_rates}")
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

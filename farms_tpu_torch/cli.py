"""Command-line interface mirroring the reference FARMS_Flow executable.

Same flags, defaults, prints and output file as `farms_tpu.cli` in batch
mode on one device (reference flags: main.cpp:36-47; output and the
closing benchmark line: vFlow.cpp:433-442, main.cpp:201-209), plus
`--device`. The default device is `cuda`; a run that asks for CUDA where
there is none fails rather than running on the CPU, so CPU runs pass
`--device cpu`. The tensor's device picks the kernels (cuda) or their plain
versions (cpu).

Modes, as in the reference (main.cpp:193-209):

- `--SERIAL 0` (default): batch processing with the chunked engine; writes
  `<filename>_FARMSOut_batch.txt` and times the whole processing call.
- `--SERIAL 1`: event-serial streaming (pipeline/serial.py): per-event
  `Local <us> <cum>` / `true <us> <cum>` prints, no output file, a
  compute-only benchmark duration, and at most filesize / 18 events.

`--backend perevent` runs the per-event formulation (use_dense=False);
auto, pallas and dense all run the dense path, whose kernels the device
picks.

Engines (parallel/), each on N = `--devices` ranks: N processes that this
command spawns, over NCCL with one card each on `--device cuda`, or over
gloo on `--device cpu`. `--devices 0` means every visible card on cuda and
one rank on the CPU; one rank runs in this process.

- `--engine single`: one device; with `--devices N > 1` it means dp, as
  in farms_tpu.
- `--engine dp`: event-data parallel (parallel/dp.py), surfaces
  replicated, each micro-batch's lanes split over the ranks.
- `--engine halo`: row bands of every surface (parallel/halo.py).
- `--engine multihost`: both over a (tx, ev) grid of ranks
  (parallel/multihost.py); the N spawned ranks are tx = N, ev = 1.
- `--multihost`: this process is one rank of a world that a launcher
  started (`torchrun` and the like: RANK, WORLD_SIZE, LOCAL_RANK,
  LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), joined before any device
  use (mesh.init_distributed); `--devices` is then not read. The engine
  runs on the whole world, the single engine as dp; the multihost engine
  takes tx = the ranks of one host. Without a launcher it is one rank.

Every rank reads the stream; rank 0 prints and writes the output.
`--wire sparse` compacts the output on the device to the lanes that carry
flow; the sharded engines refuse it with farms_tpu's ValueError. Refused
with NotImplementedError: `--engine spatial` (not ported, GSPMD tiling has
no torch counterpart) and `--SERIAL 1` on more than one rank (serial mode
has no multi-rank form).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import load_events_txt, write_flow_txt
from farms_tpu_torch.ops import _build
from farms_tpu_torch.parallel import (HaloFlowEngine, MultiHostFlowEngine,
                                      ShardedFlowEngine, mesh)
from farms_tpu_torch.pipeline.engine import FlowEngine
from farms_tpu_torch.pipeline.serial import SerialFlowEngine


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="farms-flow-torch",
        description="aperture-robust multi-scale event optical flow "
                    "(PyTorch / CUDA)",
    )
    # reference flags (main.cpp:36-47)
    p.add_argument("--filename", type=str, required=True,
                   help="events file name without extension (.txt)")
    p.add_argument("--height", type=int, default=320, help="sensor height")
    p.add_argument("--width", type=int, default=320, help="sensor width")
    p.add_argument("--filtersize", type=int, default=3,
                   help="neighborhood size for plane fitting")
    p.add_argument("--inlierCheck", type=int, default=5,
                   help="minimum inliers to validate a plane")
    p.add_argument("--numEvents", "--numevents", "--NUMEVENTS",
                   dest="num_events", type=int, default=None,
                   help="max number of events to process")
    p.add_argument("--SERIAL", type=int, default=0,
                   help="1 = event-serial streaming mode with per-event "
                        "phase timing, no output file (reference run()); "
                        "0 = batched processing (default, runFileCopy)")
    p.add_argument("--v", type=int, default=0, help="verbose mode")
    # engine flags
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    p.add_argument("--preset", type=str, default=None,
                   choices=["benchmark", "fidelity", "exact"],
                   help="validated operating points (ACCURACY.md): "
                        "benchmark = 131072 @ P=2, f16 wire; fidelity = "
                        "131072 @ P=2, 2 aperture phases, 8 snapshots, "
                        "rank-2 correction of 32768 lanes on the coarse "
                        "chain, f16 wire; exact = chunk 1 (reference "
                        "semantics). Explicit flags override preset "
                        "members")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="events per micro-batch (1 = exact serial "
                        "semantics; default: the benchmark preset's 131072 "
                        "on cuda, 4096 on cpu)")
    p.add_argument("--steps-per-scan", type=int, default=8,
                   help="micro-steps per host->device call")
    p.add_argument("--window-jump", type=int, default=5,
                   help="aperture scale stride")
    p.add_argument("--max-window", type=int, default=50,
                   help="largest aperture half-window")
    p.add_argument("--kill-old-flow-us", type=int, default=500,
                   help="freshness gate for aperture pooling (us)")
    p.add_argument("--sub-phases", type=int, default=None,
                   help="causal groups per micro-batch: the accuracy "
                        "granularity is chunk-size/sub-phases (default: "
                        "the benchmark preset's 2 on cuda, 1 on cpu)")
    p.add_argument("--aperture-sub-phases", type=int, default=None,
                   help="aperture pooling phases per chunk (0 = one per "
                        "sub-phase; a divisor of --sub-phases pools once "
                        "per group of sub-phases, a multiple pools several "
                        "times per sub-phase)")
    p.add_argument("--correction", type=int, default=None,
                   help="rank-2 center-correction budget: lanes per "
                        "micro-batch re-fitted at their own stamp (0 = off)")
    p.add_argument("--correction-chain", type=str, default=None,
                   choices=("full", "coarse"),
                   help="correction-pass visibility chain: every "
                        "snapshot boundary (full) or every sub-phase end "
                        "(coarse)")
    p.add_argument("--snapshots", type=int, default=None,
                   help="causal visibility snapshots per sub-phase")
    p.add_argument("--wire", type=str, default=None,
                   choices=["f32", "f16", "sparse"],
                   help="device->host output precision: f16 = 9 B/event, "
                        "f32 = 17 B/event, sparse = f16 compacted on the "
                        "device to the lanes that carry flow (1 B/event "
                        "plus 4 B per flow word; single engine only). "
                        "Default: f16 on cuda (the benchmark preset), f32 "
                        "on cpu")
    p.add_argument("--layout", type=str, default="xytp",
                   choices=["xytp", "txyp"],
                   help="input column order: xytp = reference layout, "
                        "txyp = Event Camera Dataset / DAVIS events.txt")
    p.add_argument("--time-unit", type=str, default="us",
                   choices=["us", "s"],
                   help="input timestamp unit (DAVIS txyp files use "
                        "float seconds)")
    p.add_argument("--y-clamp-quirk", action="store_true",
                   help="replicate the reference's y-clamped-by-width bug")
    p.add_argument("--no-output", action="store_true",
                   help="skip writing the output txt (benchmarking)")
    p.add_argument("--engine", type=str, default="single",
                   choices=["single", "dp", "spatial", "halo", "multihost"],
                   help="sharding strategy: single device, event-batch data "
                        "parallel (dp), row bands with halo exchanges "
                        "(halo), or both over a (tx, ev) grid of ranks "
                        "(multihost; tx = --devices, ev = 1 when this "
                        "command spawns the ranks); spatial is not ported")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks of the dp, halo and multihost engines, one "
                        "card each on cuda (0 = every visible card on cuda, "
                        "one rank on cpu; one rank runs in this process); "
                        "with --engine single, >1 means --engine dp")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "pallas", "dense", "perevent"],
                   help="compute formulation: auto/pallas/dense all run the "
                        "dense path (the device picks kernel or plain "
                        "version); perevent = the per-event gather "
                        "formulation")
    p.add_argument("--multihost", action="store_true",
                   help="join the world of an external launcher (RANK, "
                        "WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, "
                        "MASTER_ADDR, MASTER_PORT, as torchrun sets them) "
                        "before any device use: this process is one rank; "
                        "without them, a world of one")
    return p


# (chunk_size, sub_phases, aperture_sub_phases, causal_snapshots,
#  center_correction, coarse_chain, wire), as in farms_tpu.cli
_PRESETS = {
    "benchmark": (131072, 2, 0, 1, 0, False, "f16"),
    "fidelity": (131072, 2, 2, 8, 32768, True, "f16"),
    "scale-faithful": (256, 1, 0, 1, 0, False, "f16"),
    "exact": (1, 1, 0, 1, 0, False, "f32"),
}


def _resolve_operating_point(args):
    """Fill unset operating-point flags from the preset.

    With no --preset, the default is `benchmark` on cuda - a bare run on
    the card uses the validated benchmark operating point - and the small
    (4096, 1, f32) point on the CPU, where the 131072 chunk would be slow.
    Explicit flags always win; preset members that conflict with them
    reset to neutral instead of failing validation.
    """
    preset = args.preset
    if preset is None:
        preset = "benchmark" if args.device.startswith("cuda") else None
    chunk, phases, ap, snaps, corr, cchain, wire = _PRESETS.get(
        preset, (4096, 1, 0, 1, 0, False, "f32"))
    user_p = args.sub_phases is not None
    user_ap = args.aperture_sub_phases is not None
    user_s = args.snapshots is not None
    chunk = args.chunk_size if args.chunk_size is not None else chunk
    phases = args.sub_phases if user_p else phases
    ap = args.aperture_sub_phases if user_ap else ap
    snaps = args.snapshots if user_s else snaps
    corr = args.correction if args.correction is not None else corr
    if args.correction_chain is not None:
        cchain = args.correction_chain == "coarse"
    wire = args.wire if args.wire is not None else wire
    if chunk % max(1, phases * snaps):
        if not user_p:
            phases = 1
        if not user_s:
            snaps = 1
    if ap and not user_ap and (
            (ap % phases and phases % ap) or chunk % ap):
        ap = 0
    return chunk, phases, ap, snaps, corr, cchain, wire


def _spawned_ranks(args) -> int:
    """The ranks this command starts: `--devices` for the sharded engines
    (0: every visible card on cuda, one rank on the CPU), one for the
    single engine with `--devices` 0 or 1 and under `--multihost`."""
    if args.multihost:
        return 1
    n = args.devices
    if n == 0 and args.engine != "single":
        n = (torch.cuda.device_count() if args.device.startswith("cuda")
             else 1)
    return max(1, n)


def _refuse_unported(args) -> None:
    world = (int(os.environ.get("WORLD_SIZE", "1")) if args.multihost
             else _spawned_ranks(args))
    if args.SERIAL == 1 and world > 1:
        raise NotImplementedError(
            "--SERIAL 1 runs one event at a time on one device; it has no "
            "multi-rank form")
    if args.engine == "spatial":
        raise NotImplementedError(
            "--engine spatial is not ported (ROADMAP Queue 1, \"Do not "
            "port\": GSPMD tiling has no torch counterpart; --engine halo "
            "shards the rows explicitly)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if args.multihost:
        # this process is one rank of the launcher's world
        mesh.init_distributed(device=args.device)
        return _run(args)
    n = _spawned_ranks(args)
    if n > 1:
        if args.device.startswith("cuda"):
            # one build before the ranks start, not one per rank
            _build.build()
        return mesh.run(_run, n, args.device, args)
    return _run(args)


def build_config(args) -> FlowConfig:
    """The FlowConfig of parsed CLI arguments (operating point resolved).

    `--SERIAL 1` runs one event at a time: chunk 1, one phase, no
    aperture phasing, snapshots or correction, whatever the preset says
    (farms_tpu/cli.py:273-278)."""
    (chunk_size, sub_phases, ap_phases, snapshots, correction,
     coarse_chain, wire) = _resolve_operating_point(args)
    if args.SERIAL == 1:
        chunk_size, sub_phases, ap_phases, snapshots, correction = (
            1, 1, 0, 1, 0)
    return FlowConfig(
        width=args.width,
        height=args.height,
        filter_size=args.filtersize,
        min_evts_on_plane=args.inlierCheck,
        window_jump=args.window_jump,
        max_window=args.max_window,
        kill_old_flow_time_us=args.kill_old_flow_us,
        chunk_size=chunk_size,
        steps_per_scan=args.steps_per_scan,
        sub_phases=sub_phases,
        aperture_sub_phases=ap_phases,
        causal_snapshots=snapshots,
        center_correction=correction,
        correction_coarse_chain=coarse_chain,
        wire=wire,
        use_dense=args.backend != "perevent",
        replicate_y_clamp_quirk=args.y_clamp_quirk,
    )


def _serial_cap(args) -> int | None:
    """The event cap of serial mode: at most filesize / 18 events, the
    reference's rough bytes-per-line estimate (vFlow.cpp:511); batch mode
    has none (its cap is commented out, vFlow.cpp:164)."""
    path = (args.filename if args.filename.endswith(".txt")
            else args.filename + ".txt")
    try:
        cap = os.path.getsize(path) // 18
    except OSError:
        return args.num_events
    return cap if args.num_events is None else min(args.num_events, cap)


def _run(args) -> int:
    """The run of one rank: every rank reads the stream and processes it;
    rank 0 prints, times and writes the output."""
    rank, _ = mesh.rank_and_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = build_config(args)
    serial = args.SERIAL == 1
    if args.preset is None and not serial:
        say(
            f"[farms-flow] operating point: chunk_size={cfg.chunk_size} "
            f"sub_phases={cfg.sub_phases} "
            f"aperture_sub_phases={cfg.aperture_sub_phases} "
            f"snapshots={cfg.causal_snapshots} "
            f"correction={cfg.center_correction} wire={cfg.wire} "
            "(implicit; pin with --preset or explicit flags)",
            file=sys.stderr)
    if serial:
        engine = SerialFlowEngine(cfg, device=args.device)
    elif args.engine == "halo":
        engine = HaloFlowEngine(cfg, device=args.device)
    elif args.engine == "multihost":
        engine = MultiHostFlowEngine(cfg, device=args.device)
    elif args.engine == "dp" or mesh.rank_and_size()[1] > 1:
        engine = ShardedFlowEngine(cfg, device=args.device)
    else:
        engine = FlowEngine(cfg, device=args.device)

    say(args.filename + ".txt")
    say("Reading input file ")
    ev = load_events_txt(args.filename,
                         _serial_cap(args) if serial else args.num_events,
                         layout=args.layout, time_unit=args.time_unit)
    say(f"Done reading {len(ev)} Events.")
    if len(ev) == 0:
        say("Unable to open file")  # vFlow.cpp:802
        return 1
    say(f"First time = {int(ev.t[0])}")

    if serial:
        # the reference's serial mode (main.cpp:159-161, vFlow.cpp:465-826)
        print("Running serially ")
        print("Processing events ")
        out, duration_us = engine.run(ev)
        print()
        print("Done processing!")
    else:
        say("Running batch ")
        say("Processing events ")
        t_start = time.perf_counter()
        out = engine.process(ev)
        duration_us = int((time.perf_counter() - t_start) * 1e6)
        if rank:
            return 0
        print()
        print("Done processing!")
    # serial mode writes no file (the reference's writes are commented
    # out, vFlow.cpp:488-489, 730-737)
    if not serial and not args.no_output:
        print()
        print("Writing output file.")
        write_flow_txt(out, args.filename)

    duration_sec = duration_us / 1e6
    n = len(ev)
    rate = (n - 1) / duration_sec if duration_sec > 0 else float("inf")
    # benchmark line format follows main.cpp:201
    print(
        f"[Benchmark Main] : Processing time   : {duration_us} usec "
        f"{duration_sec} sec  with rate of : {rate} events/sec"
    )
    if args.v:
        valid = np.asarray(out.r_local) > 0
        print(f"[debug Main] : valid flow fraction {valid.mean():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

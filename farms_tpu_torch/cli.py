"""Command-line interface mirroring the reference FARMS_Flow executable.

Same flags, defaults, prints and output file as `farms_tpu.cli` in batch
mode on one device (reference flags: main.cpp:36-47; output and the
closing benchmark line: vFlow.cpp:433-442, main.cpp:201-209), plus
`--device`. The default device is `cuda`; a run that asks for CUDA where
there is none fails rather than running on the CPU, so CPU runs pass
`--device cpu`. The tensor's device picks the kernels (cuda) or their plain
versions (cpu).

`--SERIAL 1`, sharded engines, `--backend perevent` and `--multihost` are
not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import load_events_txt, write_flow_txt
from farms_tpu_torch.pipeline.engine import FlowEngine


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
                   help="0 = batched processing (runFileCopy); 1 = "
                        "event-serial streaming (not ported yet)")
    p.add_argument("--v", type=int, default=0, help="verbose mode")
    # engine flags
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    p.add_argument("--preset", type=str, default=None,
                   choices=["benchmark", "fidelity", "exact"],
                   help="validated (chunk-size, sub-phases, wire) bundles "
                        "(ACCURACY.md): benchmark = 131072 @ P=2, f16 wire; "
                        "fidelity = snapshots + correction (not ported "
                        "yet); exact = chunk 1 (reference semantics). "
                        "Explicit --chunk-size/--sub-phases/--wire flags "
                        "override preset members")
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
                   help="aperture pooling phases per chunk (0 = coupled; "
                        "other values are not ported yet)")
    p.add_argument("--correction", type=int, default=None,
                   help="center-correction budget (0 = off; not ported "
                        "yet)")
    p.add_argument("--correction-chain", type=str, default=None,
                   choices=("full", "coarse"),
                   help="correction-pass visibility chain (not ported yet)")
    p.add_argument("--snapshots", type=int, default=None,
                   help="causal visibility snapshots per sub-phase (1; "
                        "more are not ported yet)")
    p.add_argument("--wire", type=str, default=None,
                   choices=["f32", "f16", "sparse"],
                   help="device->host output precision: f16 = 9 B/event, "
                        "f32 = 17 B/event (sparse is not ported yet). "
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
                   help="sharding strategy (only single is ported)")
    p.add_argument("--devices", type=int, default=0,
                   help="number of devices (only 0 or 1 is ported)")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "pallas", "dense", "perevent"],
                   help="compute formulation: auto/pallas/dense all run the "
                        "dense path (the device picks kernel or plain "
                        "version); perevent is not ported yet")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host run (not ported yet)")
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


def _refuse_unported(args) -> None:
    if args.SERIAL == 1:
        raise NotImplementedError(
            "--SERIAL 1 is not ported yet (ROADMAP Queue 1 item 9)")
    if args.engine != "single" or args.devices > 1:
        raise NotImplementedError(
            "sharded engines are not ported yet (ROADMAP Queue 1 item 11)")
    if args.backend == "perevent":
        raise NotImplementedError(
            "--backend perevent is not ported yet (ROADMAP Queue 1 item 9)")
    if args.multihost:
        raise NotImplementedError(
            "--multihost is not ported yet (ROADMAP Queue 1 item 11)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    (chunk_size, sub_phases, ap_phases, snapshots, correction,
     coarse_chain, wire) = _resolve_operating_point(args)
    if args.preset is None:
        print(
            f"[farms-flow] operating point: chunk_size={chunk_size} "
            f"sub_phases={sub_phases} aperture_sub_phases={ap_phases} "
            f"snapshots={snapshots} correction={correction} wire={wire} "
            "(implicit; pin with --preset or explicit flags)",
            file=sys.stderr)

    cfg = FlowConfig(
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
        replicate_y_clamp_quirk=args.y_clamp_quirk,
    )
    engine = FlowEngine(cfg, device=args.device)

    print(args.filename + ".txt")
    print("Reading input file ")
    ev = load_events_txt(args.filename, args.num_events,
                         layout=args.layout, time_unit=args.time_unit)
    print(f"Done reading {len(ev)} Events.")
    if len(ev) == 0:
        print("Unable to open file")  # vFlow.cpp:802
        return 1
    print(f"First time = {int(ev.t[0])}")

    print("Running batch ")
    print("Processing events ")
    t_start = time.perf_counter()
    out = engine.process(ev)
    duration_us = int((time.perf_counter() - t_start) * 1e6)
    print()
    print("Done processing!")
    if not args.no_output:
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

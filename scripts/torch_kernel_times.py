#!/usr/bin/env python3
"""Device times of every kernel case of the PyTorch port, for one tree.

Times each hand-written kernel at the shapes of `chip_smoke.py`'s phases 2
and 3 (320 x 320; one interior 80-row band and the one 320-row band for
the halo modes): the median device time of one wrapper call over 30 calls,
from torch.profiler (the sum of every device kernel the call launches, so
the aperture pass counts its integral), and the aperture pool kernel's own.
The inputs and the timing helper are `chip_smoke.py`'s, taken from this
script's checkout; the kernels are those of `--tree`, a checkout of the
repository (default: this one), so that two trees can be timed in one call
on one card, in turns:

    python scripts/torch_kernel_times.py --tree . --label new
    python scripts/torch_kernel_times.py --tree <parent> --label parent

`--ptxas` also prints each kernel instance's registers, spill bytes and
static shared memory from `nvcc -Xptxas -v`, and, where the tree has
ops/kernels.local_flow_shape, the local-flow kernel's tile rows, slab
rows and shared bytes (the general kernel's ring and slots are dynamic
shared memory) at each filter size timed; where it has
ops/kernels.aperture_shape, the pool's tile, slabs and dynamic shared
bytes at 320 x 320, 260 x 346 and an 80-row band (window jump 5).
The integral is timed alone at `chip_smoke.py`'s timed integral shapes
(320 x 320, 260 x 346, harness config 5's 1280 x 720, an 80-row band of
320 and a 160 x 160 tile), with the device time of each kernel it
launches.
`--dadd-latency` also prints the card's float64 add latency and the SM
clock's maximum (`chip_smoke._dadd_latency`: one thread's chains of
dependent adds timed with clock64()); (rows + cols) adds at that latency
and clock are the integral's chain bound.
`--match REGEX` times only the cases whose name matches. Prints one JSON
line per case and a summary line; a case that the tree refuses
(NotImplementedError) prints what it raised.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENSOR = 320


def _helpers():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(_build) -> list:
    """Registers, spill bytes and static shared memory of every kernel
    instance, from -Xptxas -v."""
    out = []
    nvcc = _build._nvcc()
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    for src in _build.SOURCES:
        proc = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.devnull, str(_build._PKG / "csrc" / src)],
            capture_output=True, text=True, check=True)
        name = spill = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                if os.path.exists(filt):
                    name = subprocess.run([filt, name], capture_output=True,
                                          text=True).stdout.strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                smem = re.search(r"(\d+) bytes smem", line)
                out.append({"source": src, "kernel": name,
                            "registers": int(m.group(1)),
                            "spill_bytes": spill,
                            "static_smem_bytes":
                                int(smem.group(1)) if smem else 0})
                name = None
    return out


def kernel_ms(fn, reps: int = 30) -> dict:
    """Median device ms of one call of fn, by kernel name (torch.profiler's
    device-side events, times each kernel's launches per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name.setdefault(e.name, []).append(e.self_device_time_total)
    return {name: float(np.median(t)) * max(1, round(len(t) / reps)) / 1e3
            for name, t in by_name.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--label", default="")
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--match", default="")
    p.add_argument("--dadd-latency", action="store_true")
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.ops import _build, kernels
    from farms_tpu_torch.ops import dense_flow as plain
    if not kernels.__file__.startswith(tree):
        raise RuntimeError(f"imported {kernels.__file__}, not from {tree}")
    cs = _helpers()
    dev = torch.device("cuda")
    label = args.label or tree
    smi = cs._nvidia_smi()
    _build.load()
    if args.dadd_latency:
        print(json.dumps({"tree": label, "card": smi, **cs._dadd_latency()}),
              flush=True)
    if args.ptxas:
        for row in ptxas(_build):
            print(json.dumps({"tree": label, "ptxas": row}), flush=True)
        if hasattr(kernels, "local_flow_shape"):
            for k in (3, 5, 7, 9, 11, 21):
                print(json.dumps({"tree": label, "filter_size": k,
                                  "shape": kernels.local_flow_shape(k)}),
                      flush=True)
        if hasattr(kernels, "aperture_shape"):
            for rows, Ha in ((SENSOR, SENSOR), (260, 346), (SENSOR // 4,
                                                            SENSOR)):
                print(json.dumps({"tree": label, "pool": [rows, Ha],
                                  "shape": kernels.aperture_shape(rows, Ha,
                                                                  5)}),
                      flush=True)

    def T(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    rows = []

    def case(name, fn, pool=False, split=False):
        if not re.search(args.match, name):
            return
        try:
            fn()
        except NotImplementedError as e:
            row = {"case": name, "raises": str(e)}
        else:
            row = {"case": name, "device_ms": cs._device_ms(fn)}
            if pool:
                row["pool_device_ms"] = cs._device_ms(fn, "aperture_kernel")
            if split:
                row["kernels"] = kernel_ms(fn)
        rows.append(row)
        print(json.dumps({"tree": label, **row}), flush=True)

    # phase 2: the whole-sensor local-flow modes
    chains = [(k, n, True, SENSOR, SENSOR) for k in (3, 5)
              for n in (1, 8, 96)]
    chains += [(k, n, False, SENSOR, SENSOR) for k in (3, 5)
               for n in (3, 17, 96)]
    chains += [(k, n, fold, SENSOR, SENSOR) for k, n in
               ((7, 1), (7, 9), (9, 1), (9, 9), (7, 129), (9, 96))
               for fold in (True, False)]
    # the general kernel at 260 x 346, and on sensors a few rows short of
    # 320 whose grids fill the card's block slots (two blocks per SM) a
    # whole number of times: 790 blocks at k = 7 (2.99 rounds of 264, 800
    # at 320 rows), 1560 at k = 9 (5.91, 1600 at 320)
    chains += [(7, 9, True, 260, 346), (7, 1, True, 316, 320),
               (9, 1, True, 312, 320)]
    # the general kernel at a run-time radius, the support in slabs of
    # rows (5 at k = 11, 14 at k = 21)
    chains += [(k, n, fold, SENSOR, SENSOR) for k in (11, 21)
               for n in (1, 9) for fold in (True, False)]
    for k, n, fold, W, H in chains:
        cfg = FlowConfig(width=W, height=H, filter_size=k)
        surfs, t_post, rank2 = cs._stamp_chain(W, H, 100 + k + n, n)
        chain, center = T(surfs, t_post if fold else rank2)
        geom = "" if (W, H) == (SENSOR, SENSOR) else f" {W}x{H}"
        case(f"local_flow k={k} chain={n} fold_center={fold}{geom}",
             lambda cfg=cfg, chain=chain, center=center, fold=fold:
             kernels.local_flow(chain, center, cfg, fold_center=fold))

    # phase 2: the integral and the aperture pass (the parent's integral is
    # the plain version's eager ops, which its wrapper ran)
    integral = getattr(kernels, "integral", plain.build_integral)
    for W, H in cs.INTEGRAL_SHAPES[:cs.INTEGRAL_TIMED]:
        ins = T(*cs._flow_fields(W, H, 3))
        case(f"integral {W}x{H}", lambda ins=ins: integral(*ins), split=True)
    for (W, H, quirk) in ((SENSOR, SENSOR, False), (260, 346, True)):
        cfg = FlowConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
        ins = T(*cs._flow_fields(W, H, 3))
        case(f"aperture {W}x{H}",
             lambda ins=ins, cfg=cfg: kernels.aperture(*ins, cfg), pool=True)

    # phase 3: halo modes, band 1 of 4 (80 rows) and the one 320-row band
    for k, n, fold in [(3, 1, True), (3, 8, True), (5, 1, True),
                       (5, 8, True), (3, 3, False), (5, 3, False),
                       (7, 1, True), (7, 3, False)]:
        cfg = FlowConfig(width=SENSOR, height=SENSOR, filter_size=k)
        R = cfg.support_radius
        surfs, t_post, rank2 = cs._stamp_chain(SENSOR, SENSOR, 200 + k + n, n)
        center = t_post if fold else rank2
        for nb, i in ((4, 1), (1, 0)):
            ch, ce = T(cs._band(surfs, nb, i, R), cs._band(center, nb, i, R))
            case(f"halo local_flow k={k} chain={n} fold_center={fold} "
                 f"rows={SENSOR // nb}",
                 lambda cfg=cfg, ch=ch, ce=ce, fold=fold, R=R, o=i * SENSOR
                 // nb: kernels.local_flow(ch, ce, cfg, fold_center=fold,
                                           halo=R, row_offset=o))
    cfg = FlowConfig(width=SENSOR, height=SENSOR)
    A = cfg.max_window + 1
    ins = T(*cs._flow_fields(SENSOR, SENSOR, 6))
    integ = plain.build_integral(*ins)
    full = torch.cat([torch.zeros_like(integ[:, :A]), integ,
                      integ[:, -1:].expand(-1, A, -1)], 1)
    for nb, i in ((4, 1), (1, 0)):
        n_rows = SENSOR // nb
        core = [a[i * n_rows:(i + 1) * n_rows] for a in ins]
        band = full[:, i * n_rows:(i + 1) * n_rows + 2 * A + 1].contiguous()
        case(f"halo aperture rows={n_rows}",
             lambda core=core, band=band: kernels.aperture(
                 *core, cfg, halo=A, integ=band))
    print(json.dumps({"tree": label, "card": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "cases": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

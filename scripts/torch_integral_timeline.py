#!/usr/bin/env python3
"""Timeline of one float64 integral call on the card, phase by phase.

Builds a copy of `farms_tpu_torch/csrc/aperture.cu` in which the integral
kernel writes the global timer (`%globaltimer`, ns, one clock for every
SM) into a device array at its hand-offs: a block's start (its role
known), each ring slot's data ready for the fold warp, each slot summed,
a column block's strips-done release, a row block's producers seeing
every strip done. The copy goes to `farms_tpu_torch/_build/` (one nvcc,
the package's flags), its `farms_integral` runs one call at each shape
after warm-up calls, and one JSON line a shape gives, in us from the
first block's start: the first column chunk ready for the fold, the
column phase's end (its last slot summed), the last release, the row
blocks' polls (first, median, last), the first row tile ready, the row
phase's end, and each phase's median time from one slot summed to the
next. The timer writes slow the kernel: the line also gives the call's
device time with and without them (torch.profiler).

    python scripts/torch_integral_timeline.py [--shape 320x320 ...]

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TMAX_BLOCKS, TMAX_SLOTS = 1024, 64
# event rows: 0 block start, 1 slot k ready for the fold, 2 slot k summed,
# 3 the column block's release, 4 the row block's poll done
_PRELUDE = f"""
constexpr int TMAXB = {TMAX_BLOCKS}, TMAXK = {TMAX_SLOTS};
__device__ long long g_timeline[TMAXB][5][TMAXK];
__device__ __forceinline__ long long global_ns() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define MARK(ev, k)                                                    \\
  do {{                                                                 \\
    if (threadIdx.x % 32 == 0 && sh.role < TMAXB && (k) < TMAXK)       \\
      g_timeline[sh.role][ev][k] = global_ns();                        \\
  }} while (0)
"""
_EPILOGUE = """
extern "C" int farms_timeline(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline, sizeof(g_timeline));
}
extern "C" int farms_timeline_clear() {
  static long long zero[TMAXB][5][TMAXK];
  return (int)cudaMemcpyToSymbol(g_timeline, zero, sizeof(g_timeline));
}
"""
# (anchor in the source, text put after it)
_MARKS = (
    ("struct IntegralShared {", None),
    ("    if (i % 2 == 0) farms::mbar_wait(&sh.full[s], round_parity(k));",
     "    if (i % 2 == 0) MARK(1, k);"),
    ("    if (i % 2) farms::mbar_arrive(&sh.done[s]);",
     "    if (i % 2) MARK(2, k);"),
    ("farms::add_release(&g_strips_done[slot], 1);",
     "    if (sw == 0) MARK(3, 0);"),
    ("      farms::fence_acq_rel();  // with the relaxed load: an acquire",
     "      MARK(4, 0);"),
    ("  const int role = sh.role;", "  if (threadIdx.x == 0) MARK(0, 0);"),
)


def instrumented_source() -> str:
    src = (ROOT / "farms_tpu_torch" / "csrc" / "aperture.cu").read_text()
    for anchor, text in _MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in aperture.cu: "
                               f"{anchor!r}")
        if text is None:
            src = src.replace(anchor, _PRELUDE + anchor)
        else:
            src = src.replace(anchor, anchor + "\n" + text)
    return src + _EPILOGUE


def build():
    from farms_tpu_torch.ops import _build
    src = instrumented_source()
    csrc = ROOT / "farms_tpu_torch" / "csrc"
    tag = hashlib.sha256((src + (csrc / "async_copy.cuh").read_text())
                         .encode()).hexdigest()[:12]
    lib = _build.BUILD_DIR / f"libintegral_timeline_{tag}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = _build.BUILD_DIR / f"integral_timeline_{tag}.cu"
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-I", str(csrc), "-o", str(lib), str(cu)],
                       check=True)
    out = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    out.farms_integral.argtypes = [P, P, P, I, I, P, P]
    out.farms_integral.restype = I
    out.farms_timeline.argtypes = [P]
    out.farms_timeline.restype = I
    out.farms_timeline_clear.argtypes = []
    out.farms_timeline_clear.restype = I
    return out


def timeline(lib, rows: int, cols: int) -> dict:
    import torch

    from farms_tpu_torch.ops import kernels
    cs = _helpers()
    dev = torch.device("cuda")
    ins = [torch.from_numpy(a).to(dev)
           for a in cs._flow_fields(rows, cols, 3)]
    integ = torch.empty((4, rows + 1, cols + 1), dtype=torch.float64,
                        device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call():
        rc = lib.farms_integral(*(a.data_ptr() for a in ins), rows, cols,
                                integ.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"integral launch failed: cudaError_t {rc}")

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    traced_ms = cs._device_ms(call)
    real_ms = cs._device_ms(lambda: kernels.integral(*ins))
    if lib.farms_timeline_clear():
        raise RuntimeError("clearing the timeline failed")
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    buf = np.zeros((TMAX_BLOCKS, 5, TMAX_SLOTS), np.int64)
    if lib.farms_timeline(buf.ctypes.data_as(ctypes.c_void_p)):
        raise RuntimeError("reading the timeline failed")
    n_strips = (cols + 8) // 8
    n_blocks = n_strips + -(-rows // 8)
    n_chunks, n_tiles = -(-rows // 32), -(-cols // 32)
    if n_blocks > TMAX_BLOCKS or max(n_chunks, n_tiles) > TMAX_SLOTS:
        raise ValueError(f"{rows} x {cols} has more blocks or slots than "
                         f"the timeline holds")
    t0 = buf[:n_blocks, 0, 0].min()
    us = (buf[:n_blocks] - t0) / 1e3
    col, row = us[:n_strips], us[n_strips:]

    def period(t, n):
        step = t[:, 2, 1:n] - t[:, 2, :n - 1]
        return float(np.median(step)) if step.size else None

    return {
        "shape": [rows, cols], "blocks": int(n_blocks),
        "device_ms": real_ms, "device_ms_with_timer": traced_ms,
        "first_chunk_ready_us": float(np.median(col[:, 1, 0])),
        "column_phase_end_us": float(col[:, 2, n_chunks - 1].max()),
        "last_release_us": float(col[:, 3, 0].max()),
        "poll_done_us": [float(row[:, 4, 0].min()),
                         float(np.median(row[:, 4, 0])),
                         float(row[:, 4, 0].max())],
        "first_tile_ready_us": float(np.median(row[:, 1, 0])),
        "row_phase_end_us": float(row[:, 2, n_tiles - 1].max()),
        "column_slot_us": period(col, n_chunks),
        "row_slot_us": period(row, n_tiles),
    }


def _helpers():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", nargs="*",
                   default=["320x320", "80x320", "1280x720"])
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    lib = build()
    smi = _helpers()._nvidia_smi()
    for shape in args.shape:
        rows, cols = (int(v) for v in re.fullmatch(r"(\d+)x(\d+)",
                                                   shape).groups())
        print(json.dumps({"card": smi, **timeline(lib, rows, cols)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and bind the CUDA kernels of farms_tpu_torch/csrc.

Each source compiles with its own `nvcc` process, all started together,
and the objects link into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds). The
library is built on first use into `farms_tpu_torch/_build/`, named by a
hash of the sources, their headers and the flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = ("local_flow.cu", "aperture.cu", "wire.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # chain, S, fold_center, center, band_rows, rows, halo, row_offset,
    # band_cols, cols, col_halo, col_offset, W, H, filter_size, min_evts,
    # det_threshold, neg_ts, accept, a, b, dtdp, cand, stream
    "farms_local_flow": (_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P),
    # filter_size, tile_rows, slab_rows, shared_bytes (out)
    "farms_local_flow_shape": (_I, _IP, _IP, _IP),
    # integ, integ_rows, rows, halo, cols, col_halo, y_clip, n_scales,
    # jump, flow_vx, flow_vy, tvx, tvy, scale, stream
    "farms_aperture": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                       _P, _P),
    # rows, Ha, jump, tile_rows, tile_cols, slab_rows, slab_cols,
    # strip_rows, strip_cols, shared_bytes (out)
    "farms_aperture_shape": (_I, _I, _I, _IP, _IP, _IP, _IP, _IP, _IP,
                             _IP),
    # flow_len, flow_vx, flow_vy, rows, cols, integ, stream
    "farms_integral": (_P, _P, _P, _I, _I, _P, _P),
    # main, aux, rows, lanes, count, jump, out, stride, offset, stream
    "farms_decode_wire": (_P, _P, _I, _I, _I, _I, _P, _I, _I, _P),
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted((_PKG / "csrc").iterdir()):   # sources and headers
        h.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"libfarms_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds) -> None:
    """Start every command at once, wait for all; raise with the output
    of a failed one."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}\n"
                          f"{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library go to private names, then the library is
    # renamed: a concurrent build never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(_PKG / "csrc" / s)]
              for s, o in zip(SOURCES, objs)])
        tmp = os.path.join(work, out.name)
        _run([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out


def load():
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib

"""Build and bind the CUDA kernels of farms_tpu_torch/csrc.

The sources compile with `nvcc` into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library is built on first use into `farms_tpu_torch/_build/`,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused. Nothing here runs at import time.
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
SOURCES = ("local_flow.cu", "aperture.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # chain, S, center, W, H, filter_size, min_evts, det_threshold,
    # neg_ts, accept, a, b, dtdp, cand, stream
    "farms_local_flow": (_P, _I, _P, _I, _I, _I, _I, _F, _F,
                         _P, _P, _P, _P, _P, _P),
    # integ, W, H, y_clip, n_scales, jump, flow_vx, flow_vy,
    # tvx, tvy, scale, stream
    "farms_aperture": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
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
    for name in SOURCES:
        h.update((_PKG / "csrc" / name).read_bytes())
    return BUILD_DIR / f"libfarms_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(_PKG / "csrc" / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
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

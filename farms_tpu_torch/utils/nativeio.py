"""ctypes bindings of the native fast I/O library (native/fast_io.cpp).

Counterpart of `farms_tpu.utils.nativeio`: parsing `x y t p` text,
formatting the 11-column output and the compact device-layout pack run in
C++ (mmap'd input, an arena-buffered writer, one linear pass for the
winner bits). The library is built on first use from the repository's
`native/fast_io.cpp`, unchanged, by one `g++` with native/Makefile's flags,
into `farms_tpu_torch/_build/libfarmsio_<hash>.so` (the hash covers the
source, the flags and the host's -march=native target, so each CPU gets a
library of its own): under a private name, then renamed, so a concurrent
build never loads a half-written library. Nothing is built at import time.

Every entry point returns None / False where the library is absent (no
source, no compiler), so the NumPy paths run; `build_error()` says why,
and `CALLS` counts the calls that went native.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "fast_io.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile's CXXFLAGS (less -Wall) and its -shared
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

# calls served by the library, by entry point
CALLS = {"parse": 0, "pack": 0, "write": 0}

_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_ll = ctypes.c_longlong
_SIGNATURES = {
    # path -> lines, or -1
    "farms_count_lines": (_ll, [ctypes.c_char_p]),
    # path, cap, x, y, t, p -> events parsed, or -1
    "farms_parse_events": (_ll, [ctypes.c_char_p, _ll, _i32p, _i32p, _u32p,
                                 _i32p]),
    # path, n, rows[11 n] -> 0
    "farms_write_flow": (ctypes.c_int, [ctypes.c_char_p, _ll,
                                        ctypes.POINTER(ctypes.c_double)]),
    # n, x, y, t, t0, W, H, m, steps, K, out[steps, 2, m] -> 0
    "farms_pack_compact": (ctypes.c_int, [_ll, _i32p, _i32p, _u32p,
                                          ctypes.c_uint32, ctypes.c_int32,
                                          ctypes.c_int32, _ll, _ll,
                                          ctypes.c_int32, _i32p]),
}

_lib = None
_tried = False
_error: str | None = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX)")
    return cxx


@functools.lru_cache(maxsize=None)
def _target(cxx: str) -> bytes:
    """What -march=native means to `cxx` on this host (the CPU and its
    instruction-set options), so that a library built for another CPU is
    never loaded here."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} -march=native -Q --help=target exited "
                           f"{proc.returncode}")
    return proc.stdout


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """The library's path: its name hashes the source, the flags and this
    host's -march=native target."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()
                       + _target(_compiler()))
    return Path(build_dir) / f"libfarmsio_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile native/fast_io.cpp for this host unless a library of it
    exists; returns its path. Raises where the source or the compiler is
    missing or the compile fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found")
    cxx = _compiler()
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        tmp = os.path.join(work, out.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} exited {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load():
    """The bound library, built on first call; None (and build_error()
    set) where it cannot be built or loaded."""
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
    except (OSError, RuntimeError, AttributeError,
            subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the library is absent (None where it loaded or was not asked
    for yet)."""
    _load()
    return _error


def reset_calls() -> None:
    for key in CALLS:
        CALLS[key] = 0


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_events(path: str, max_events: int | None) -> np.ndarray | None:
    """`x y t p` text as a float64 [N, 4] matrix (polarity clamped to
    >= 0), or None where the library or the file is absent."""
    lib = _load()
    if lib is None or not os.path.exists(path):
        return None
    cap = lib.farms_count_lines(path.encode())
    if cap < 0:
        return None
    if max_events is not None:
        cap = min(cap, max_events)
    x = np.empty(cap, dtype=np.int32)
    y = np.empty(cap, dtype=np.int32)
    t = np.empty(cap, dtype=np.uint32)
    p = np.empty(cap, dtype=np.int32)
    n = lib.farms_parse_events(path.encode(), cap, _ptr(x, ctypes.c_int32),
                               _ptr(y, ctypes.c_int32),
                               _ptr(t, ctypes.c_uint32),
                               _ptr(p, ctypes.c_int32))
    if n < 0:
        return None
    CALLS["parse"] += 1
    out = np.empty((n, 4), dtype=np.float64)
    out[:, 0] = x[:n]
    out[:, 1] = y[:n]
    out[:, 2] = t[:n]
    out[:, 3] = p[:n]
    return out


def pack_compact(x: np.ndarray, y: np.ndarray, t: np.ndarray, t0: int,
                 width: int, height: int, m: int, steps: int,
                 subphases: int = 1) -> np.ndarray | None:
    """The compact device layout (FlowEngine.pack(compact=True)): int32
    [steps, 2, m], row 0 the clipped flat pixel index | winner << 30 (the
    last event at its pixel within each of `subphases` blocks of a step),
    row 1 the stamp normalized to t0; lanes past the stream hold the
    sentinel W*H and the last stamp. None where the library is absent or
    refuses the shape (W*H >= 2^30, m >= 2^21)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.int32)
    y = np.ascontiguousarray(y, dtype=np.int32)
    t = np.ascontiguousarray(t, dtype=np.uint32)
    if x.ndim != 1 or x.shape != y.shape or x.shape != t.shape:
        raise ValueError(f"x, y, t must be equal 1-d arrays, got "
                         f"{x.shape}, {y.shape}, {t.shape}")
    if x.shape[0] > steps * m:
        raise ValueError(f"{x.shape[0]} events exceed {steps} steps of {m}")
    out = np.empty((steps, 2, m), dtype=np.int32)
    rc = lib.farms_pack_compact(
        int(x.shape[0]), _ptr(x, ctypes.c_int32), _ptr(y, ctypes.c_int32),
        _ptr(t, ctypes.c_uint32), ctypes.c_uint32(int(t0) & 0xFFFFFFFF),
        width, height, m, steps, subphases, _ptr(out, ctypes.c_int32))
    if rc != 0:
        return None
    CALLS["pack"] += 1
    return out


def write_flow(path: str, mat: np.ndarray) -> bool:
    """Write the float64 [N, 11] output matrix as the reference's text;
    False where the library is absent or the write failed."""
    lib = _load()
    if lib is None:
        return False
    mat = np.ascontiguousarray(mat, dtype=np.float64)
    if mat.ndim != 2 or mat.shape[1] != 11:
        raise ValueError(f"the output matrix must be [N, 11], got "
                         f"{mat.shape}")
    if lib.farms_write_flow(path.encode(), mat.shape[0],
                            _ptr(mat, ctypes.c_double)) != 0:
        return False
    CALLS["write"] += 1
    return True

"""The port's native fast I/O (farms_tpu_torch/utils/nativeio.py) against
farms_tpu's I/O and packer and against the port's own NumPy paths.

The port builds native/fast_io.cpp itself, into farms_tpu_torch/_build/
(never native/libfarmsio.so); these tests need g++, which the CPU machine
has. Every comparison is exact: parsed arrays and packed words bitwise,
written files byte for byte.
"""
import ctypes
import subprocess
import sys

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.utils import nativeio

torch.set_num_threads(1)

_REPO = nativeio.SOURCE.parent.parent


@pytest.fixture(scope="module")
def jio():
    pytest.importorskip("jax")
    from farms_tpu.events import io
    return io


def test_library_builds_into_the_port_build_dir():
    assert nativeio.available(), nativeio.build_error()
    assert nativeio.build_error() is None
    path = nativeio.library_path()
    assert path.exists() and path.parent == nativeio.BUILD_DIR
    assert path.name.startswith("libfarmsio_")


def _event_file(tmp_path, name, n=5000, seed=4):
    ev = tio.synthetic_random_events(n, width=320, height=320, seed=seed)
    return ev, tio.write_events_txt(ev, str(tmp_path / name))


@pytest.mark.parametrize("max_events", [None, 13])
def test_parse_matches_jax_and_numpy(jio, tmp_path, max_events,
                                     monkeypatch):
    """load_events_txt's native path equals farms_tpu's load_events_txt
    and the port's NumPy path, with a negative polarity clamped and a
    fractional stamp truncated as both parsers do."""
    ev, path = _event_file(tmp_path, "ev")
    with open(path, "a") as fh:
        fh.write("3 4 5000000 -1\n7 8 5000001.000 1\n")
    nativeio.reset_calls()
    got = tio.load_events_txt(path, max_events)
    assert nativeio.CALLS["parse"] == 1
    want = jio.load_events_txt(path, max_events)
    with monkeypatch.context() as mp:
        mp.setattr(nativeio, "parse_events", lambda *a: None)
        plain = tio.load_events_txt(path, max_events)
    n = max_events or len(ev) + 2
    assert len(got) == n
    for ref in (want, plain):
        for col in ("x", "y", "t", "pol"):
            a, b = getattr(got, col), getattr(ref, col)
            assert a.dtype == b.dtype and np.array_equal(a, b), col
    if max_events is None:
        assert list(got.pol[-2:]) == [0, 1]
        assert list(got.t[-2:]) == [5000000, 5000001]


def _pack_cases():
    return [
        dict(width=64, height=48, chunk_size=256, steps_per_scan=2,
             sub_phases=1),
        dict(width=64, height=48, chunk_size=256, steps_per_scan=2,
             sub_phases=4),
        # the fidelity point: P * S = 16 winner blocks a micro-step
        dict(width=64, height=48, chunk_size=256, steps_per_scan=2,
             sub_phases=2, causal_snapshots=8),
    ]


@pytest.mark.parametrize("kw", _pack_cases(), ids=["P1", "P4", "P2S8"])
def test_native_pack_matches_jax_and_numpy(kw, monkeypatch):
    """FlowEngine.pack(compact=True) through the library is bitwise equal
    to farms_tpu's pack(compact=True) and to the port's NumPy path, over
    two packs of one stream (t0 latched by the first)."""
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.pipeline.engine import FlowEngine as JEngine

    ev = tio.synthetic_random_events(1500, width=64, height=48,
                                     rate_hz=2e6, seed=5)
    parts = (ev[:700], ev[700:])
    jeng = JEngine(JConfig(**kw))
    want = [jeng.pack(p, compact=True) for p in parts]
    nativeio.reset_calls()
    eng = teng.FlowEngine(TConfig(**kw), device="cpu")
    got = [eng.pack(p, compact=True) for p in parts]
    assert nativeio.CALLS["pack"] == 2
    with monkeypatch.context() as mp:
        mp.setattr(nativeio, "pack_compact", lambda *a, **k: None)
        eng = teng.FlowEngine(TConfig(**kw), device="cpu")
        plain = [eng.pack(p, compact=True) for p in parts]
    for (g, gn), (w, wn), (p, pn) in zip(got, want, plain):
        assert gn == wn == pn
        assert g.shape == np.asarray(w).shape and g.shape[2] == 2
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def _flow_output(n, seed, nonfinite=False):
    rng = np.random.default_rng(seed)
    cols = rng.normal(size=(6, n)) * 10.0 ** rng.integers(-8, 8, (6, n))
    cols[:, ::7] = np.round(cols[:, ::7])       # integral values
    cols[:, 3::11] = 0.0
    cols[:, 5::13] = -0.0
    if nonfinite:
        bad = np.array([np.inf, -np.inf, np.nan, -np.nan])
        cols[:, ::3] = bad[rng.integers(0, 4, (6, cols[:, ::3].shape[1]))]
    return tio.FlowOutput(
        x=rng.integers(0, 320, n).astype(np.int32),
        y=rng.integers(0, 320, n).astype(np.int32),
        t=rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32),
        pol=rng.integers(0, 2, n).astype(np.int32),
        r_true=cols[0].astype(np.float32), theta_true=cols[1],
        vx=cols[2].astype(np.float32), vy=cols[3],
        r_local=cols[4].astype(np.float32), theta_local=cols[5],
        scale=(rng.integers(0, 11, n) * 5).astype(np.int32))


def _write_bytes(out, base, monkeypatch, native):
    with monkeypatch.context() as mp:
        if not native:
            mp.setattr(nativeio, "write_flow", lambda *a: False)
        with open(tio.write_flow_txt(out, base), "rb") as fh:
            return fh.read()


def test_writer_byte_equal_to_jax_on_finite_rows(jio, tmp_path,
                                                 monkeypatch):
    """write_flow_txt, native and NumPy, byte for byte equal to
    farms_tpu's write_flow_txt on 20,000 rows of finite values."""
    out = _flow_output(20000, 1)
    jbase = str(tmp_path / "jax")
    jio.write_flow_txt(jio.FlowOutput(**vars(out)), jbase)
    with open(jbase + tio.OUTPUT_SUFFIX, "rb") as fh:
        want = fh.read()
    nativeio.reset_calls()
    got = _write_bytes(out, str(tmp_path / "port"), monkeypatch, True)
    assert nativeio.CALLS["write"] == 1
    plain = _write_bytes(out, str(tmp_path / "plain"), monkeypatch, False)
    assert got == want
    assert plain == want


def test_writer_nonfinite_rows_match_native(tmp_path, monkeypatch):
    """Rows with inf, -inf, NaN and negative NaN: the NumPy writer prints
    what the native writer prints (glibc's %.6g, the sign of a NaN
    shown)."""
    out = _flow_output(3000, 2, nonfinite=True)
    native = _write_bytes(out, str(tmp_path / "n"), monkeypatch, True)
    plain = _write_bytes(out, str(tmp_path / "p"), monkeypatch, False)
    assert b"-nan" in native and b" inf" in native and b"-inf" in native
    assert plain == native


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Two processes building at once into an empty directory leave one
    library of the source's hash and no partial file, and it loads."""
    code = ("import sys; from pathlib import Path; "
            "from farms_tpu_torch.utils import nativeio; "
            "print(nativeio.build(Path(sys.argv[1])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=_REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    files = sorted(tmp_path.iterdir())
    assert [f.name for f in files] == [nativeio.library_path(tmp_path).name]
    lib = ctypes.CDLL(str(files[0]))
    for name in ("farms_count_lines", "farms_parse_events",
                 "farms_write_flow", "farms_pack_compact"):
        assert hasattr(lib, name)


def test_library_of_another_cpu_is_not_loaded(tmp_path, monkeypatch):
    """The library's name hashes the host's -march=native target: a
    library built for another CPU (another target, same source and flags)
    sits under another name, and build() makes this host its own."""
    here = nativeio.build(tmp_path)
    monkeypatch.setattr(nativeio, "_target",
                        lambda cxx: b"-march=  some-other-cpu")
    there = nativeio.library_path(tmp_path)
    assert there != here and not there.exists()
    assert nativeio.build(tmp_path) == there and there.exists()


def test_missing_source_reports_and_falls_back(tmp_path, monkeypatch):
    """Without its source the library is absent: every entry point says
    so (None / False), build_error() says why, and the I/O runs in NumPy."""
    monkeypatch.setattr(nativeio, "SOURCE", tmp_path / "absent.cpp")
    monkeypatch.setattr(nativeio, "_lib", None)
    monkeypatch.setattr(nativeio, "_tried", False)
    monkeypatch.setattr(nativeio, "_error", None)
    assert not nativeio.available()
    assert "absent.cpp" in nativeio.build_error()
    ev, path = _event_file(tmp_path, "ev", n=50)
    assert nativeio.parse_events(path, None) is None
    assert nativeio.pack_compact(ev.x, ev.y, ev.t, 0, 320, 320, 64, 1) is None
    nativeio.reset_calls()
    back = tio.load_events_txt(path)
    np.testing.assert_array_equal(back.t, ev.t)
    assert nativeio.CALLS == {"parse": 0, "pack": 0, "write": 0}

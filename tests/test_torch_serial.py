"""The port's serial mode (`SerialFlowEngine`, `--SERIAL 1`).

The cases of tests/test_serial.py on the port, and the port against
`farms_tpu`'s SerialFlowEngine and CLI: the serial engine is the per-event
ops at one event, so it equals the port's chunk_size=1 per-event engine
(up to r_local/theta_local, which the engine's wire decode computes with
NumPy on the host and the serial engine with torch: 2 ulps), reproduces the float64
oracle as tests/test_golden.py asserts it, and carries its t0 latch and
surfaces across calls. Against JAX (XLA contracts products into sums, the
port does not; ops/local_flow.py) the magnitudes agree to 1e-4 relative,
the components to 1e-4 of the magnitude and the angles to 1e-4 rad, and
every integer column and valid flag is equal.
"""
import os

import numpy as np
import pytest
import torch

from farms_tpu_torch import cli as tcli
from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.pipeline.oracle import run_oracle
from farms_tpu_torch.pipeline.serial import SerialFlowEngine
from test_torch_engine import _assert_matches_oracle, _golden_bar
from test_torch_perevent import _past_2e31

torch.set_num_threads(1)

_CFG = dict(width=48, height=48, chunk_size=1, steps_per_scan=1,
            max_window=10)


def _bar48(n):
    # tests/test_serial.py:26
    return tio.synthetic_translating_bar(width=48, height=48, bar_len=10,
                                         duration_us=8000, jitter_us=10)[:n]


_INTS = ("x", "y", "t", "pol", "scale")
_EXACT = ("r_true", "theta_true", "vx", "vy")


def _assert_same(a, b, what, local_ulps=0):
    """Integer columns and the shipped floats equal (NaN too); the host-
    or device-derived r_local/theta_local within `local_ulps`."""
    for col in _INTS + _EXACT:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=f"{what} {col}")
    np.testing.assert_array_equal(a.r_local > 0, b.r_local > 0)
    for col in ("r_local", "theta_local"):
        x = np.asarray(getattr(a, col), np.float32)
        y = np.asarray(getattr(b, col), np.float32)
        assert (np.abs(x - y) <= local_ulps * np.spacing(np.abs(x))).all(), (
            what, col)


def test_serial_matches_chunk1_engine():
    """tests/test_serial.py:18: the serial engine equals the per-event
    engine at chunk_size=1 (the same ops, one event at a time)."""
    cfg = TConfig(**_CFG, use_dense=False)
    ev = _bar48(60)
    ref = teng.FlowEngine(cfg, device="cpu").process(ev)
    got, compute_us = SerialFlowEngine(cfg, device="cpu").run(ev, quiet=True)
    assert compute_us > 0 and (ref.r_local > 0).sum() > 10
    _assert_same(got, ref, "serial vs chunk 1", local_ulps=2)


def test_serial_continuation():
    """tests/test_serial.py:34: a stream fed in two calls equals one call
    (the t0 latch and the surfaces carry across)."""
    cfg = TConfig(**_CFG)
    ev = _bar48(40)
    one, _ = SerialFlowEngine(cfg, device="cpu").run(ev, quiet=True)
    eng = SerialFlowEngine(cfg, device="cpu")
    a, _ = eng.run(ev[:17], quiet=True)
    b, _ = eng.run(ev[17:], quiet=True)
    assert eng.state.step == len(ev)
    np.testing.assert_array_equal(
        np.concatenate([a.as_matrix(), b.as_matrix()]), one.as_matrix())


@pytest.mark.parametrize("stream", ["bar", "past_2e31"])
def test_serial_engine_matches_oracle(stream):
    """tests/test_golden.py:44 and :121's asserts on the serial engine."""
    ev = _golden_bar() if stream == "bar" else _past_2e31()
    ref = run_oracle(ev, TConfig(width=64, height=64))
    got, _ = SerialFlowEngine(TConfig(width=64, height=64, chunk_size=1),
                              device="cpu").run(ev, quiet=True)
    _assert_matches_oracle(ref, got)


def test_serial_matches_jax_serial():
    """Against farms_tpu's SerialFlowEngine on the same stream, in one
    call and then continued, with the phase prints."""
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.pipeline.serial import SerialFlowEngine as JSerial

    ev = _bar48(120)
    lines = {"jax": [], "port": []}
    je = JSerial(JConfig(**_CFG), print_fn=lines["jax"].append)
    te = SerialFlowEngine(TConfig(**_CFG), device="cpu",
                          print_fn=lines["port"].append)
    n_valid = 0
    for part in (ev[:50], ev[50:]):
        want, _ = je.run(part)
        got, _ = te.run(part)
        for col in _INTS:
            np.testing.assert_array_equal(getattr(got, col),
                                          getattr(want, col), err_msg=col)
        valid = want.r_local > 0
        np.testing.assert_array_equal(got.r_local > 0, valid)
        n_valid += valid.sum()
        mag = {"vx": want.r_local, "vy": want.r_local,
               "r_true": want.r_true, "r_local": want.r_local}
        for col in _EXACT + ("r_local", "theta_local"):
            err = np.abs(getattr(got, col) - getattr(want, col))[valid]
            bound = 1e-4 * (mag[col][valid] if col in mag else 1.0)
            assert (err <= bound).all(), (col, err.max())
    assert n_valid > 20
    assert int(je.state.step) == te.state.step == len(ev)
    np.testing.assert_array_equal(te.state.t_surf.numpy(),
                                  np.asarray(je.state.t_surf))
    # the same phase lines in the same order: one `Local` per event, one
    # `true` per valid event
    kinds = {k: [ln.split()[0] for ln in v] for k, v in lines.items()}
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"].count("Local") == len(ev)
    assert kinds["port"].count("true") == n_valid


def _events_file(tmp_path, n=900):
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=24,
                                       duration_us=40000, jitter_us=15,
                                       seed=2)[:n]
    base = str(tmp_path / "serial_events")
    tio.write_events_txt(ev, base)
    return ev, base


@pytest.mark.parametrize("num_events", [None, 300])
def test_cli_serial_matches_jax_cli(tmp_path, capsys, num_events):
    """`--SERIAL 1` against farms_tpu.cli: the filesize / 18 event cap (or
    --numEvents below it), the same prints line for line up to the
    measured times, one `Local` line per event and one `true` line per
    valid one, and no output file."""
    pytest.importorskip("jax")
    from farms_tpu import cli as jcli

    ev, base = _events_file(tmp_path)
    argv = ["--filename", base, "--width", "64", "--height", "64",
            "--SERIAL", "1"]
    if num_events:
        argv += ["--numEvents", str(num_events)]
    cap = os.path.getsize(base + ".txt") // 18
    want_n = min(cap, num_events or cap)
    assert want_n < len(ev)
    out_file = base + "_FARMSOut_batch.txt"

    def words(out):
        return [ln.split()[0] if ln.split()[:1] in (["Local"], ["true"])
                else ln for ln in out.splitlines()
                if "[Benchmark Main]" not in ln]

    assert jcli.main(argv) == 0
    jax_out = capsys.readouterr().out
    assert not os.path.exists(out_file)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert not os.path.exists(out_file)
    assert words(out) == words(jax_out)
    assert f"Done reading {want_n} Events." in out
    assert "Running serially " in out.splitlines()
    said = words(out)
    assert said.count("Local") == want_n
    ref, _ = SerialFlowEngine(TConfig(width=64, height=64, chunk_size=1),
                              device="cpu").run(ev[:want_n], quiet=True)
    assert said.count("true") == (ref.r_local > 0).sum() > 50
    bench = [ln for ln in out.splitlines() if "[Benchmark Main]" in ln]
    assert len(bench) == 1 and "events/sec" in bench[0]

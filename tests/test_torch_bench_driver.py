"""The port's benchmark line (`farms_tpu_torch.bench.driver`) and device
sweep (`farms_tpu_torch.bench.device_sweep`) against `bench.py`.

- `device_batches` uploads the host arrays of `bench.device_batches` on
  the same stream (compact events, rank-2 lanes), without bench.py's
  equal-stamp escapes: the port's step takes the epoch scatter.
- `main` on the CPU at a 32 x 32 sensor and chunk 2048 prints one JSON line
  with bench.py's keys of the three lanes and the card's, none of the
  dropped ones, and a `fidelity_validity_agreement` equal to a direct
  comparison of the fidelity engine's process() with the oracle on the
  same first chunk.
- `device_sweep` prints one line per config.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from farms_tpu_torch.bench import accuracy, device_sweep, driver
from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.pipeline.engine import FlowEngine
from farms_tpu_torch.pipeline.oracle import run_oracle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a 32 x 32 sensor, where the random stream's first chunk of 2048 events
# has flow (about 100 valid oracle lanes)
_SENSOR = (32, 32)
_TINY = {"FARMS_BENCH_CHUNK": "2048", "FARMS_BENCH_STEPS": "1",
         "FARMS_BENCH_CALLS": "2", "FARMS_BENCH_E2E_CALLS": "2",
         "FARMS_BENCH_E2E_REPS": "2", "FARMS_BENCH_F_CORRECTION": "512"}
_KEPT = {"metric", "value", "unit", "chunk_size", "sub_phases",
         "e2e_events_per_second", "e2e_wire_MBps", "e2e_passes",
         "e2e_wall_s_per_pass", "fidelity_events_per_second",
         "fidelity_validity_agreement", "fidelity_agreement_events",
         "device", "device_name", "card"}
_DROPPED = {"vs_baseline", "e2e_vs_baseline", "fidelity_vs_baseline",
            "e2e_fetches_per_process_call", "e2e_rtt_ms",
            "e2e_fetch_wall_s_per_pass", "e2e_1thread_fetch_frac",
            "e2e_1thread_events_per_second"}


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setattr(driver, "SENSOR", _SENSOR)
    monkeypatch.setattr(accuracy, "CACHE_DIR", str(tmp_path))
    for k, v in _TINY.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("correction", [0, 64])
def test_device_batches_equal_bench(correction):
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.pipeline.engine import FlowEngine as JEngine

    kw = dict(width=64, height=64, chunk_size=256, sub_phases=2,
              causal_snapshots=2, center_correction=correction, wire="f16")
    spc, n_calls = 2, 3
    ev = tio.synthetic_random_events(256 * spc, width=64, height=64,
                                     rate_hz=5e6, seed=0)
    span = int(ev.t[-1]) + 1
    want, wevs = bench.device_batches(JEngine(JConfig(**kw)), JConfig(**kw),
                                      ev, spc, n_calls, np.int32(span))
    cfg = TConfig(**kw)
    got, gevs = driver.device_batches(FlowEngine(cfg, device="cpu"), cfg, ev,
                                      spc, n_calls, span, "cpu")
    assert len(got) == n_calls
    # bench.py ships the JAX step's equal-stamp escapes; the port's step
    # finds each phase's written pixels by the epoch scatter
    assert any("wesc" in b for b in want)
    assert not any("wesc" in b for b in got)
    for w, g, we, ge in zip(want, got, wevs, gevs):
        assert sorted(k for k in w if k != "wesc") == sorted(g)
        for k in g:
            a, b = np.asarray(w[k]), g[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        assert we.t.tobytes() == ge.t.tobytes()


def test_main_prints_bench_line(tiny, capsys):
    assert driver.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == _KEPT and not set(out) & _DROPPED
    assert out["metric"] == "events_per_second_single_chip"
    assert out["chunk_size"] == 2048 and out["sub_phases"] == 2
    assert out["device"] == "cpu" and out["card"] is None
    for key in ("value", "e2e_events_per_second",
                "fidelity_events_per_second", "e2e_wall_s_per_pass"):
        assert out[key] > 0, key
    assert len(out["e2e_passes"]) == 2
    # the same first chunk, directly: the fidelity engine's process() on
    # the fidelity lane's stream from a fresh state, against the oracle
    m = 2048
    cfg_f = TConfig(width=32, height=32, chunk_size=m, wire="f16",
                    sub_phases=2, aperture_sub_phases=2, causal_snapshots=8,
                    center_correction=512, correction_coarse_chain=True)
    ev_f = tio.synthetic_random_events(m, width=32, height=32, rate_hz=5e6,
                                       seed=100)
    got = FlowEngine(cfg_f, device="cpu").process(ev_f).r_local > 0
    want = run_oracle(ev_f, cfg_f).r_local > 0
    assert want.sum() > 50
    assert out["fidelity_agreement_events"] == m
    assert out["fidelity_validity_agreement"] == round(
        float((got == want).mean()), 4)


def test_device_sweep_prints_one_line_per_config(tiny, monkeypatch, capsys):
    monkeypatch.setenv("SWEEP_CHUNK", "256")
    monkeypatch.setenv("SWEEP_STEPS", "1")
    monkeypatch.setenv("SWEEP_CALLS", "2")
    assert device_sweep.main(["--device", "cpu"]) == 0
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert [(r["P"], r["A"], r["S"], r["C"]) for r in lines] \
        == device_sweep.CONFIGS
    for r in lines:
        assert r["device_ev_per_s"] > 0 and r["card"] is None

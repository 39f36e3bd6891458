"""The dense step finds each phase's written pixels on the device by the
epoch scatter (pipeline/engine.py `micro_step`), once a phase, with no
equal-stamp escapes packed on the host.

A phase that rewrites a pixel at the stamp it already holds leaves
`t_surf` unchanged there; the pixel is written all the same (its flow is
refitted). The streams below plant such rewrites at phase boundaries,
more of them in one phase than the JAX engine's 32 escape slots, and
rewrites whose refit sees new neighbours at the same stamp (there a step
that misses the rewrite keeps a stale flow, which the reference counts).

On the CPU:
- process() on both streams against the plain reference
  (flowbench/reference/dense.py, which scatters a boolean `written`), at
  the benchmark and fidelity presets' shapes: every number 0;
- the same streams against the JAX engine, which finds the written set
  as `t_surf != t_pre` plus the host's equal-stamp escapes;
- at 8 snapshots a phase, the epoch surface after one micro-step is
  bitwise what one scatter per sub-group gives;
- a traced process() counts every dense call as an epoch call, and no
  per-event call.

On the card (marked `cuda`; skips without one; no JAX): process() of the
equal-stamp stream against the CPU engine, and no escapes in any call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.state.surfaces import init_state
from farms_tpu_torch.utils import tracing
from flowbench import harness
from flowbench.reference.compare import judge

from test_torch_engine import (_assert_engines_agree, _equal_stamp_stream,
                               _overflow_stream,
                               _process_recording_aperture)

torch.set_num_threads(1)

# the presets' shapes on a 64 x 64 sensor, one micro-step a call (the
# reference knows no calls, and a call padded by whole micro-steps runs
# their staleness kill)
_BENCH = dict(width=64, height=64, sub_phases=2, wire="f16",
              steps_per_scan=1)
_FIDELITY = dict(_BENCH, aperture_sub_phases=2, causal_snapshots=8,
                 correction_coarse_chain=True)


def _burst_edge_stream():
    """An edge that fires a whole column (rows 10-39) at one stamp, 250 us
    a column, sweeping columns 4-59 twice, each pixel firing twice at the
    same microsecond; one event before it puts the pairs off the phase
    grid. A pair that straddles a phase boundary rewrites its pixel at an
    unchanged stamp, and the rest of its column follows at that stamp in
    the same phase: the pixel's refit sees them, so its flow changes
    where a phase that missed the rewrite would keep the old one."""
    x, y, t = [0], [63], [500]
    stamp = 1000
    for _ in range(2):
        for col in range(4, 60):
            x += [col] * 60
            y += list(np.repeat(np.arange(10, 40), 2))
            t += [stamp] * 60
            stamp += 250
    n = len(x)
    return tio.EventBatch(np.array(x, np.int32), np.array(y, np.int32),
                          np.array(t, np.uint32), np.ones(n, np.int32))


# (stream, its micro-step): the equal-stamp pairs sit at every 256th
# lane, the phase boundaries of 512-lane steps; the overflow block
# straddles lane 256, a step boundary at 256 lanes
_STREAMS = {"equal_stamp": (_equal_stamp_stream, 512),
            "overflow": (_overflow_stream, 256),
            "burst_edge": (_burst_edge_stream, 512)}


def _config(preset: str, stream: str) -> FlowConfig:
    m = _STREAMS[stream][1]
    if preset == "benchmark":
        return FlowConfig(chunk_size=m, **_BENCH)
    return FlowConfig(chunk_size=m, center_correction=m // 4, **_FIDELITY)


@pytest.fixture(autouse=True)
def clean_totals():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("stream", sorted(_STREAMS))
@pytest.mark.parametrize("preset", ["benchmark", "fidelity"])
def test_process_matches_the_reference(preset, stream):
    ev = _STREAMS[stream][0]()
    cfg = _config(preset, stream)
    eng = teng.FlowEngine(cfg, device="cpu")
    out = eng.process(ev)
    assert (out.r_local > 0).sum() > 20
    sample = harness.sample_record(ev, None, out, eng.whole_state())
    nums = judge([sample], dataclasses.asdict(cfg), int(ev.t[0]), "cpu")
    assert nums == dict.fromkeys(nums, 0.0), nums


@pytest.fixture(scope="module")
def jax_engine():
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.pipeline.engine import FlowEngine as JEngine
    return JConfig, JEngine


@pytest.mark.parametrize("stream", sorted(_STREAMS))
def test_process_matches_the_jax_engine(jax_engine, stream, monkeypatch):
    JConfig, JEngine = jax_engine
    ev = _STREAMS[stream][0]()
    cfg = _config("benchmark", stream)
    je = JEngine(JConfig(**dataclasses.asdict(cfg)))
    want = je.process(ev)
    got, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), ev, monkeypatch)
    _assert_engines_agree(want, got, passes, cfg, stream)


def test_one_epoch_scatter_a_phase_equals_one_a_sub_group():
    """At S = 8, a micro-step's epoch surface equals the one that S
    scatters of the phase's value, one a sub-group, give; it marks the
    pixel a phase rewrote at an unchanged stamp."""
    cfg = _config("fidelity", "equal_stamp")
    ev = _equal_stamp_stream()
    eng = teng.FlowEngine(cfg, device="cpu")
    chunks = eng.device_calls(ev, 1)
    state = init_state(cfg, "cpu")
    states = []
    for _ in range(2):
        batch = {k: v[0] for k, v in next(chunks).items()}
        batch["step"] = torch.tensor(state.step, dtype=torch.int32)
        new, _ = teng.micro_step(state, batch, cfg)
        x, y, _, win = teng._decode_batch(batch, cfg)
        W, H = cfg.array_width, cfg.array_height
        wpix = torch.where(win, x.to(torch.int64) * H + y, W * H)
        P, S, _ = teng._phasing(cfg.chunk_size, cfg)
        assert (P, S) == (2, 8)
        ms = cfg.chunk_size // (P * S)
        want = state.epoch
        for p in range(P):
            for si in range(S):
                lo = (p * S + si) * ms
                want = teng._scatter(want, wpix[lo:lo + ms],
                                     state.step * P + p)
        assert new.epoch.numpy().tobytes() == want.numpy().tobytes()
        state = new
        states.append(new)
    # the pair at lanes 255 / 256, across the phases of step 0, shares
    # pixel (60, 0) and its stamp: phase 1 rewrote the pixel unchanged,
    # and its epoch says so
    first = states[0]
    assert (ev.x[255], ev.y[255], ev.t[255]) == (60, 0, ev.t[256])
    assert (ev.x[256], ev.y[256]) == (60, 0)
    assert int(first.t_surf[60, 0]) == int(ev.t[256] - ev.t[0]) + 1
    assert int(first.epoch[60, 0]) == 1


@pytest.mark.parametrize("dense", [True, False])
def test_every_dense_call_is_an_epoch_call(dense):
    cfg = dataclasses.replace(_config("benchmark", "overflow"),
                              chunk_size=128, use_dense=dense)
    ev = _overflow_stream()[:640]
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        out = teng.FlowEngine(cfg, device="cpu").process(ev)
    assert len(out) == len(ev)
    counters = tracing.totals()["counters"]
    assert counters["engine.calls"] == 5
    assert counters.get("engine.epoch_calls", 0) == (5 if dense else 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_process_equal_stamps_equals_cpu(cuda):
    """The card's process() of the equal-stamp stream at both presets:
    no call carries escapes; the surfaces' stamps and epochs, each lane's
    validity and scale id equal the CPU engine's, the flow within the
    card-against-CPU tolerance of tests/test_torch_cuda.py."""
    ev = _equal_stamp_stream()
    for preset in ("benchmark", "fidelity"):
        cfg = _config(preset, "equal_stamp")
        card = teng.FlowEngine(cfg, device=cuda)
        assert not any("wesc" in c for c in card.device_calls(ev, 1))
        card.reset()
        cpu = teng.FlowEngine(cfg, device="cpu")
        got, want = card.process(ev), cpu.process(ev)
        for f in ("t_surf", "epoch"):
            a = getattr(card.state, f).cpu().numpy()
            b = getattr(cpu.state, f).numpy()
            assert a.tobytes() == b.tobytes(), (preset, f)
        np.testing.assert_array_equal(got.r_local > 0, want.r_local > 0)
        np.testing.assert_array_equal(got.scale, want.scale)
        assert (want.r_local > 0).sum() > 100
        valid = want.r_local > 0
        for col in ("vx", "vy", "r_local", "r_true"):
            err = np.abs(getattr(got, col) - getattr(want, col))[valid]
            assert (err <= 1e-5 * want.r_local[valid] + 1e-6).all(), col

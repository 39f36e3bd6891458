"""Stage spans and counters of the port's engines (utils/tracing.py) and
the benchmark's readers of them.

- Without a profiler, process() keeps no totals; under one, every stage
  span of FlowEngine.process is a profiler range and a total with the
  expected count, at both presets' shapes, and the outputs are bitwise
  those of an untraced run.
- A call whose equal-stamp write escapes overflow counts as an epoch
  call.
- flowbench/metrics/_spans.py and its readers turn totals into readings,
  and give None where the program kept none.
- The halo engine's spans on 2 gloo ranks.

Imports no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, synthetic_rotating_shapes
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.pipeline.engine import _W_ESCAPES, FlowEngine
from farms_tpu_torch.utils import tracing
from flowbench import harness

from test_torch_halo_ranks import traced_process

torch.set_num_threads(1)

COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
           "r_local", "theta_local", "scale")

_BENCH = dict(width=64, height=64, chunk_size=256, sub_phases=2,
              wire="f16")
_FIDELITY = dict(width=64, height=64, chunk_size=256, sub_phases=2,
                 aperture_sub_phases=2, causal_snapshots=4,
                 center_correction=64, correction_coarse_chain=True,
                 wire="f16")
_PRESETS = {"benchmark": _BENCH, "fidelity": _FIDELITY}
# one micro-step a call: a profiled step on the CPU records thousands of
# ops, so the streams stay a few steps long
_SPC = 1
_CALL = _SPC * 256


@pytest.fixture(scope="module")
def stream():
    """700 events of a rotating scene: three calls, the last one
    padded."""
    ev = synthetic_rotating_shapes(width=64, height=64,
                                   duration_us=100_000)[:700]
    assert 2 * _CALL < len(ev) < 3 * _CALL
    return ev


@pytest.fixture(autouse=True)
def clean_totals():
    tracing.reset()
    yield
    tracing.reset()


def _traced(fn):
    """fn() under a CPU profiler: (its result, the port's range names)."""
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events()
             if e.name.startswith(tracing.PREFIX)]
    return out, names


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for col in COLUMNS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col


def test_untraced_process_keeps_no_totals(stream):
    assert not torch.autograd.profiler._is_profiler_enabled
    FlowEngine(FlowConfig(**_BENCH), device="cpu").process(stream, _SPC)
    with tracing.span("engine.pack"):
        tracing.count("engine.calls")
    assert tracing.totals() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_traced_process_opens_every_stage_span(stream, preset):
    """Each stage once a stream or once a call, as a profiler range and
    a total; counters count the calls and the decoded lanes."""
    cfg = FlowConfig(**_PRESETS[preset])
    out, names = _traced(
        lambda: FlowEngine(cfg, device="cpu").process(stream, _SPC))
    assert len(out) == len(stream)
    calls = -(-len(stream) // _CALL)
    want = {"engine.pack": 1, "engine.pack_wesc": 1, "engine.upload": calls,
            "engine.launch": calls, "engine.fetch": calls,
            "engine.decode": 1}
    if cfg.center_correction:
        want["engine.pack_r2"] = 1
    t = tracing.totals()
    assert {k: v[0] for k, v in t["spans"].items()} == want
    assert all(v[1] > 0 for v in t["spans"].values())
    # a CPU engine decodes every lane on the host
    assert t["counters"] == {"engine.calls": calls,
                             "engine.decoded_lanes": len(stream)}
    assert sorted(names) == sorted(
        tracing.PREFIX + k for k, v in want.items() for _ in range(v))


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_traced_process_outputs_are_bitwise_untraced(stream, preset):
    cfg = FlowConfig(**_PRESETS[preset])
    plain = FlowEngine(cfg, device="cpu").process(stream, _SPC)
    traced, _ = _traced(
        lambda: FlowEngine(cfg, device="cpu").process(stream, _SPC))
    _assert_bitwise(plain, traced)


def test_overflowing_escapes_count_one_epoch_call():
    """Call 1 rewrites every pixel of its first phase at the same stamp
    in its second phase: more equal-stamp escapes than _W_ESCAPES, so
    the call takes the epoch scatter. Call 2 has distinct stamps."""
    cfg = FlowConfig(**_BENCH)
    mp = cfg.chunk_size // cfg.sub_phases
    assert mp > _W_ESCAPES
    pix = np.arange(mp, dtype=np.int32)
    x = np.concatenate([pix, pix, 8 + pix % 32, 8 + pix % 32]) % 64
    y = np.concatenate([pix // 64, pix // 64, pix // 32 + 20,
                        pix // 32 + 40])
    t = np.concatenate([np.full(2 * mp, 1000),
                        1001 + np.arange(2 * mp)]).astype(np.uint32)
    ev = EventBatch(x.astype(np.int32), y.astype(np.int32), t,
                    np.ones(4 * mp, np.int32))
    eng = FlowEngine(cfg, device="cpu")
    wesc, ok = eng.pack_wesc(ev, steps_per_call=1)
    assert ok.tolist() == [False, True]
    eng = FlowEngine(cfg, device="cpu")
    out, _ = _traced(lambda: eng.process(ev, steps_per_call=1))
    assert len(out) == len(ev)
    assert tracing.totals()["counters"] == {"engine.calls": 2,
                                            "engine.epoch_calls": 1,
                                            "engine.decoded_lanes": len(ev)}


def test_span_records_when_the_body_raises():
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with tracing.span("engine.decode"):
                raise ValueError
        tracing.count("engine.calls", 3)
    t = tracing.totals()
    assert t["spans"]["engine.decode"][0] == 1
    assert t["counters"] == {"engine.calls": 3}
    tracing.reset()
    assert tracing.totals() == {"spans": {}, "counters": {}}


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "flowbench_metric_" + name.replace(".", "_"))


def _reading(events, traced):
    calls = [{"events": events, "traced": i < traced, "due": None,
              "start": 0.0, "end": 0.0} for i in range(traced + 2)]
    return {"calls": calls, "trace": None, "flow": {}, "traffic": {},
            "config": {}}


_FILLED = ({"engine.pack": [4, 0.5], "engine.launch": [8, 0.25]},
           {"engine.calls": 8, "engine.epoch_calls": 2})


@pytest.mark.parametrize("name,events,traced,want", [
    # 0.5 s over 4 x 262,144 = 1,048,576 traced events
    ("pack_ms_per_mevent", 262144, 4, 500.0),
    # 0.25 s over 2 replays of 4,194,304 events
    ("launch_ms_per_mevent.resident", 4194304, 2, 31.25),
    ("launch_ms_per_call.live", 131072, 8, 31.25),
    ("epoch_call_pct", 1048576, 4, 25.0),
    ("wesc_ms_per_mevent", 262144, 4, None),   # a span not opened
])
def test_span_readers_read_the_totals(monkeypatch, name, events, traced,
                                      want):
    monkeypatch.setattr(tracing, "_spans", {k: list(v) for k, v in
                                            _FILLED[0].items()})
    monkeypatch.setattr(tracing, "_counters", dict(_FILLED[1]))
    got = _reader(name).read(_reading(events, traced))
    assert got == pytest.approx(want) if want is not None else got is None
    # no traced call: no reading
    assert _reader(name).read(_reading(events, 0)) is None


@pytest.mark.parametrize("name", ["pack_ms_per_mevent", "epoch_call_pct",
                                  "decode_ms_per_call.live",
                                  "launch_ms_per_mevent.resident"])
def test_span_readers_give_none_without_totals(name):
    assert _reader(name).read(_reading(131072, 4)) is None


def test_halo_spans_on_two_gloo_ranks(stream):
    """Rank 0's spans of HaloFlowEngine.process: the pack, the layout
    vote, and per call the upload, the launches and the gather; the
    base decode nested in the halo decode. Its output equals the single
    engine's."""
    cfg = FlowConfig(**_BENCH)
    out, t, names = mesh.run(traced_process, 2, "cpu", cfg, stream, _SPC)
    _assert_bitwise(FlowEngine(cfg, device="cpu").process(stream, _SPC), out)
    calls = -(-len(stream) // _CALL)
    assert {k: v[0] for k, v in t["spans"].items()} == {
        "halo.pack": 1, "halo.vote": 1, "halo.upload": calls,
        "halo.launch": calls, "halo.gather": calls, "halo.decode": 1,
        "engine.decode": 1}
    assert t["spans"]["halo.decode"][1] >= t["spans"]["engine.decode"][1]
    assert names == sorted(tracing.PREFIX + k for k in t["spans"])

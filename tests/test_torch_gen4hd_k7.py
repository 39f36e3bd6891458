"""The gen4hd-k7 configuration (the Gen4 HD sensor with 7 x 7 plane fits,
flowbench/configs/gen4hd-k7.json) through the port's normal path, its
span and counter, and the benchmark's readers of them.

On the CPU:
- the configuration, read through flowbench.harness and cut to a small
  sensor (every other field kept), through FlowEngine.process() and the
  gen4hd-k7.resident cell's process_resident replays
  (flowbench.drivers.resident), judged by the benchmark's comparison under
  the cell's limits; the reference one precision down fails those limits;
- local_flow's card path run on CPU tensors (its library call computed
  by the plain version into the outputs' memory): the span
  kernels.local_flow once a launch and the counter
  kernels.local_flow_general_launches once a general launch, outputs
  bitwise those of the plain path, traced or not;
- the readers local_flow_roofline_pct.k7 and fit_launch_us.k7.

On the card (marked `cuda`; skips without one; no JAX): process() at the
configuration's full size over 1,048,576 events against the reference.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from farms_tpu_torch.events.io import EventBatch
from farms_tpu_torch.ops import kernels as tk
from farms_tpu_torch.ops.dense_flow import local_flow_core
from farms_tpu_torch.utils import tracing
from flowbench import control, harness, roofline
from flowbench.drivers import resident
from flowbench.reference.compare import compare_states, judge, lower_program
from flowbench.reference.dense import LOWER, Reference, Semantics

torch.set_num_threads(1)

CELL = "gen4hd-k7.resident"
SEED = 2**31 + 18
COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
           "r_local", "theta_local", "scale")
# a 96 x 64 sensor at 4096 lanes a micro-step; a stream of one whole
# process() call (min(steps_per_scan 8, 131072 / 4096) micro-steps), as
# the cells' calls are whole
SMALL = dict(width=96, height=64, chunk_size=4096)
EVENTS = 32768


@pytest.fixture(autouse=True)
def clean_totals():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _small_cell():
    """The cell as its files state it, on a 96 x 64 sensor with 4096-lane
    micro-steps and a 32,768-event stream; every other field kept."""
    c = harness.load_cell(CELL)
    assert c.flow["filter_size"] == 7 and c.traffic["driver"] == "resident"
    cfg = copy.deepcopy(c.config)
    cfg["flow"].update(SMALL)
    return dataclasses.replace(c, config=cfg, traffic={
        **c.traffic, "stream_events": EVENTS, "rate": 2e5})


def _events(cell, n=EVENTS, device="cpu"):
    return EventBatch(*harness.make_pool(cell, SEED, device,
                                         n_events=n).take(0, n))


def _within(nums, limits):
    return all(nums[k] <= v for k, v in limits.items())


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for col in COLUMNS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col


# ---- the configuration on the CPU -------------------------------------------

def test_k7_process_matches_the_reference():
    cell = _small_cell()
    ev = _events(cell)
    eng = harness.make_engine(cell, torch.device("cpu"))
    assert eng.cfg.filter_size == 7 and eng.cfg.support_radius == 6
    out = eng.process(ev)
    # enough fits pass for the comparison to mean something
    assert np.mean(np.asarray(out.r_local) > 0) > 0.05
    sample = harness.sample_record(ev, None, out, eng.whole_state())
    nums = judge([sample], cell.flow, int(ev.t[0]), "cpu")
    assert _within(nums, cell.limits), nums


def test_k7_padded_call_state_is_the_reference_state_killed_at_its_end():
    """A call padded by whole micro-steps runs their staleness kill at its
    last stamp (the padded lanes carry it): the state after it is the
    reference's with flow_len zeroed where the age at that stamp reaches
    the kill time, entries that no later event can read."""
    cell = _small_cell()
    ev = _events(cell, EVENTS // 2)
    eng = harness.make_engine(cell, torch.device("cpu"))
    eng.process(ev)
    got = harness.state_arrays(eng.whole_state())
    ref = Reference(Semantics.from_dict(cell.flow), "cpu")
    t0 = int(ev.t[0])
    ref.run(ev.x, ev.y, ev.t, t0)
    want = ref.state()
    t_now = np.int32(np.uint32(ev.t[-1]) - np.uint32(t0))
    age = (t_now + np.int32(1)) - want["t_surf"]
    stale = (age >= cell.flow["kill_old_flow_time_us"]) | (age < 0)
    assert np.any(stale & (want["flow_len"] != 0))
    want["flow_len"] = np.where(stale, np.float32(0), want["flow_len"])
    assert compare_states(got, want) == 0.0


def test_k7_resident_cell_is_correct():
    """The cell's own window (flowbench.drivers.resident: process_resident's
    fn() replayed, its last replay judged) at the small size."""
    cell = _small_cell()
    r = resident.run(cell, SEED, 0.3, False, "cpu")
    assert r["attempted"] >= 1 and len(r["samples"]) == 1
    nums = judge(r["samples"], cell.flow, r["t0"], "cpu")
    assert _within(nums, cell.limits), nums


def test_k7_control_is_not_correct():
    """The reference in bfloat16 (its integral in float32), in the
    program's place on the cell's stream, fails the cell's limits."""
    cell = _small_cell()
    samples, t0 = control.samples_of(cell, SEED, "cpu")
    nums = judge(samples, cell.flow, t0, "cpu",
                 program=lower_program(cell.flow, t0, "cpu", LOWER))
    assert not _within(nums, cell.limits), nums


# ---- the card path's span and counter on CPU tensors ------------------------

def _at(ptr: int, dtype, shape) -> torch.Tensor:
    """The CPU memory at `ptr` as a tensor, without a copy."""
    ctype = {torch.int32: ctypes.c_int32, torch.float32: ctypes.c_float}
    arr = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype[dtype])), shape=shape)
    return torch.from_numpy(arr)


class _PlainLibrary:
    """The kernel library's farms_local_flow, computed by the plain
    version (local_flow_core) into the outputs' memory."""

    def __init__(self, cfg):
        self.cfg = cfg

    def farms_local_flow(self, chain, S, fold, center, Xb, rows, halo,
                         row_offset, Yb, cols, col_halo, col_offset, width,
                         height, k, min_evts, det, neg_ts, accept, a, b,
                         dtdp, cand, stream):
        assert (width, height, k) == (self.cfg.width, self.cfg.height,
                                      self.cfg.filter_size)
        got = local_flow_core(_at(chain, torch.int32, (S, Xb, Yb)),
                              _at(center, torch.int32, (Xb, Yb)), self.cfg,
                              bool(fold), halo, row_offset, col_halo,
                              col_offset)
        for ptr, t in zip((accept, a, b, dtdp, cand), got):
            _at(ptr, t.dtype, (rows, cols)).copy_(t)
        return 0


def _card_path_on_cpu(monkeypatch, cfg):
    """Route the engine's plane fits through local_flow's card path with
    CPU tensors."""
    monkeypatch.setattr(tk._build, "load", lambda: _PlainLibrary(cfg))
    monkeypatch.setattr(tk, "_stream", lambda device: None)

    def card_path(chain, center, cfg, fold_center=True, halo=0,
                  row_offset=0, col_halo=0, col_offset=0):
        return tk._launch_local_flow(chain, center, cfg, fold_center, halo,
                                     row_offset, col_halo, col_offset)

    monkeypatch.setattr(tk, "local_flow", card_path)


@pytest.mark.parametrize("k", [7, 3])
def test_card_path_span_and_counter_on_cpu_tensors(monkeypatch, k):
    """One kernels.local_flow span a launch, and one
    kernels.local_flow_general_launches a general launch (none at k = 3);
    the outputs bitwise the plain path's, traced and untraced."""
    cell = _small_cell()
    # two micro-steps a call: a profiled step on the CPU records
    # thousands of ops
    cell.config["flow"].update(filter_size=k, steps_per_scan=2)
    ev = _events(cell, 2 * SMALL["chunk_size"])
    plain = harness.make_engine(cell, "cpu").process(ev)
    eng = harness.make_engine(cell, "cpu")
    _card_path_on_cpu(monkeypatch, eng.cfg)
    tk.reset_launches()
    untraced = harness.make_engine(cell, "cpu").process(ev)
    assert tracing.totals() == {"spans": {}, "counters": {}}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = eng.process(ev)
    general = k >= 7
    launches = tk.LAUNCHES["local_flow_general" if general else "local_flow"]
    # two sub-phases a micro-step, one fit each, two micro-steps; two runs
    assert launches == 2 * 2 * 2
    assert tk.LAUNCHES["local_flow" if general else "local_flow_general"] == 0
    t = tracing.totals()
    assert t["spans"]["kernels.local_flow"][0] == launches // 2
    assert t["counters"].get("kernels.local_flow_general_launches", 0) == (
        launches // 2 if general else 0)
    names = [e.name for e in prof.events()
             if e.name == tracing.PREFIX + "kernels.local_flow"]
    assert len(names) == launches // 2
    _assert_bitwise(untraced, plain)
    _assert_bitwise(traced, plain)


# ---- the readers ------------------------------------------------------------

def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "flowbench_metric_" + name.replace(".", "_"))


def _reading(traced, kernels):
    """Two traced replays of the full cell's 4,194,304 events (64
    micro-steps) and an untraced one, with the kernels' device time."""
    flow = harness.load_cell(CELL).flow
    calls = [{"events": 4194304, "traced": i < traced, "due": None,
              "start": 0.0, "end": 0.0} for i in range(traced + 1)]
    trace = {"kernels": kernels, "busy_s": 0.1, "window_s": 0.2}
    return {"calls": calls, "trace": trace, "flow": flow, "traffic": {},
            "config": {}}


_GENERAL = {"void local_flow_general<3>(int const*, int)": (64, 0.024)}
_FIT = [64, 0.0032]


@pytest.mark.parametrize("name,spans,counters,traced,want", [
    # 57.03 us a micro-step (2 passes of 2,073 f32 operations a pixel at
    # 921,600 pixels over 67 TFLOP/s) x 64 micro-steps over 24 ms
    ("local_flow_roofline_pct.k7", {"kernels.local_flow": _FIT},
     {"kernels.local_flow_general_launches": 64}, 2,
     100.0 * 64 * 2 * 2073 * 921600 / 67e12 / 0.024),
    # 3.2 ms over 64 spans
    ("fit_launch_us.k7", {"kernels.local_flow": _FIT},
     {"kernels.local_flow_general_launches": 64}, 2, 50.0),
    # no general launch counted: spans of the streamed kernel only
    ("local_flow_roofline_pct.k7", {"kernels.local_flow": _FIT}, {}, 2,
     None),
    ("fit_launch_us.k7", {"kernels.local_flow": _FIT}, {}, 2, None),
    # no traced replay
    ("local_flow_roofline_pct.k7", {"kernels.local_flow": _FIT},
     {"kernels.local_flow_general_launches": 64}, 0, None),
    ("fit_launch_us.k7", {"kernels.local_flow": _FIT},
     {"kernels.local_flow_general_launches": 64}, 0, None),
])
def test_k7_readers_read_the_totals(monkeypatch, name, spans, counters,
                                    traced, want):
    monkeypatch.setattr(tracing, "_spans", {k: list(v) for k, v in
                                            spans.items()})
    monkeypatch.setattr(tracing, "_counters", dict(counters))
    got = _reader(name).read(_reading(traced, _GENERAL))
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("name", ["local_flow_roofline_pct.k7",
                                  "fit_launch_us.k7"])
def test_k7_readers_give_none_without_totals(name):
    assert _reader(name).read(_reading(2, _GENERAL)) is None


def test_k7_bound_is_ops_bound():
    """The work counted at k = 7: 2,073 f32 operations a pixel, 28.5 us a
    pass at 921,600 pixels, above the pass's bytes bound."""
    flow = harness.load_cell(CELL).flow
    px = flow["width"] * flow["height"]
    ops_s = 2073 * px / roofline.PEAK_F32
    assert ops_s == pytest.approx(28.5e-6, rel=1e-3)
    assert (1 + 1 + 5) * px * 4 / roofline.PEAK_BYTES < ops_s
    assert roofline.local_flow_pass(7, 1, px) == pytest.approx(ops_s)
    assert roofline.local_flow_step(flow) == pytest.approx(2 * ops_s)


# ---- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_k7_process_at_full_size_matches_the_reference(cuda):
    """process() at the configuration as its file states it (1280 x 720,
    k = 7, chunk 131,072) over 1,048,576 events, one call of 8
    micro-steps, through the general kernel; judged under the cell's
    limits."""
    cell = harness.load_cell(CELL)
    n = 1 << 20
    ev = _events(cell, n, cuda)
    eng = harness.make_engine(cell, cuda)
    tk.reset_launches()
    out = eng.process(ev)
    assert tk.LAUNCHES["local_flow_general"] == 2 * (n // 131072)
    assert tk.LAUNCHES["local_flow"] == 0
    sample = harness.sample_record(ev, None, out, eng.whole_state())
    del eng
    torch.cuda.empty_cache()
    nums = judge([sample], cell.flow, int(ev.t[0]), cuda)
    assert _within(nums, cell.limits), nums

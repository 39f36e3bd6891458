"""The gen4hd-fidelity configuration (the Gen4 HD sensor at the `fidelity`
operating point, flowbench/configs/gen4hd-fidelity.json) through the
port's normal path, the counter of its correction pass, and the
benchmark's reader of it.

On the CPU:
- the configuration, read through flowbench.harness and cut to a small
  sensor (the chunk cut with it, the correction keeping its quarter of
  the chunk; every other field kept), through FlowEngine.process() and
  the resident cells' process_resident replays
  (flowbench.drivers.resident: gen4hd-fidelity.resident and
  davis240c.resident), judged by the benchmark's comparison under the
  cells' limits; the reference one precision down fails those limits;
- local_flow's card path run on CPU tensors (its library call computed
  by the plain version into the outputs' memory): the counter
  kernels.local_flow_correction_launches once a correction-mode launch
  and never for a phase fit, in kernels.COUNTERS always and in the
  tracing totals while a profiler records; outputs bitwise those of the
  plain path, traced or not;
- a resident graph's bookkeeping: the capture's counts taken back and
  added again at each replay, counters included;
- the reader local_flow_roofline_pct.fid and the bound it reads.

On the card (marked `cuda`; skips without one; no JAX): the cell's
process_resident at full size (1280 x 720, 4,194,304 events, 32
micro-steps) against the reference, its fn() a graph replay that carries
the correction counter.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from farms_tpu_torch.events.io import EventBatch
from farms_tpu_torch.ops import kernels as tk
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.utils import tracing
from flowbench import control, harness, roofline
from flowbench.drivers import resident
from flowbench.reference.compare import judge, lower_program
from flowbench.reference.dense import LOWER
from test_torch_gen4hd_k7 import (_assert_bitwise, _card_path_on_cpu,
                                  _PlainLibrary, _within)

torch.set_num_threads(1)

CELL = "gen4hd-fidelity.resident"
CELLS = (CELL, "davis240c.resident")
SEED = 2**31 + 22
CORRECTION = "kernels.local_flow_correction_launches"
# a 96 x 64 sensor at 4096 lanes a micro-step (512-lane snapshot
# sub-groups of 2048-lane phases); a stream of one whole process() call
# (min(steps_per_scan 8, 131072 / 4096) micro-steps), as the cells' calls
# are whole
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


def _small_cell(name=CELL):
    """The cell as its files state it, on a 96 x 64 sensor with 4096-lane
    micro-steps and a 32,768-event stream; the correction keeps its share
    of the chunk (32,768 of 131,072 lanes), every other field is kept."""
    c = harness.load_cell(name)
    assert c.flow["causal_snapshots"] == 8 and c.flow["center_correction"]
    assert c.traffic["driver"] == "resident"
    cfg = copy.deepcopy(c.config)
    share = c.flow["center_correction"] / c.flow["chunk_size"]
    cfg["flow"].update(SMALL, center_correction=int(
        share * SMALL["chunk_size"]))
    return dataclasses.replace(c, config=cfg, traffic={
        **c.traffic, "stream_events": EVENTS, "rate": 2e5})


def _events(cell, n=EVENTS, device="cpu"):
    return EventBatch(*harness.make_pool(cell, SEED, device,
                                         n_events=n).take(0, n))


# ---- the configuration on the CPU -------------------------------------------

def test_fidelity_configuration_is_gen4hd_at_the_fidelity_preset():
    """gen4hd's flow with the fidelity members set, nothing else changed;
    the same cut (`stream_events`) and engine."""
    fid = harness.load_cell(CELL).config
    hd = harness.load_cell("gen4hd.resident").config
    preset = dict(aperture_sub_phases=2, causal_snapshots=8,
                  center_correction=32768, correction_coarse_chain=True)
    assert fid["flow"] == dict(hd["flow"], **preset)
    assert fid["reduced"] == hd["reduced"] == ["stream_events"]
    assert fid["engine"] == hd["engine"] and fid["devices"] == 1


def test_fidelity_process_matches_the_reference():
    cell = _small_cell()
    ev = _events(cell)
    eng = harness.make_engine(cell, torch.device("cpu"))
    out = eng.process(ev)
    # enough fits pass for the comparison to mean something
    assert np.mean(np.asarray(out.r_local) > 0) > 0.05
    sample = harness.sample_record(ev, None, out, eng.whole_state())
    nums = judge([sample], cell.flow, int(ev.t[0]), "cpu")
    assert _within(nums, cell.limits), nums


@pytest.mark.parametrize("name", CELLS)
def test_fidelity_resident_cell_is_correct(name):
    """The cell's own window (flowbench.drivers.resident: process_resident's
    fn() replayed, its last replay judged) at the small size."""
    cell = _small_cell(name)
    r = resident.run(cell, SEED, 0.3, False, "cpu")
    assert r["attempted"] >= 1 and len(r["samples"]) == 1
    nums = judge(r["samples"], cell.flow, r["t0"], "cpu")
    assert _within(nums, cell.limits), nums


def test_fidelity_control_is_not_correct():
    """The reference in bfloat16 (its integral in float32), in the
    program's place on the cell's stream, fails the cell's limits."""
    cell = _small_cell()
    samples, t0 = control.samples_of(cell, SEED, "cpu")
    nums = judge(samples, cell.flow, t0, "cpu",
                 program=lower_program(cell.flow, t0, "cpu", LOWER))
    assert not _within(nums, cell.limits), nums


# ---- the card path's counter on CPU tensors ---------------------------------

class _FoldRecorder(_PlainLibrary):
    """The stand-in library, noting the mode of each launch."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.folds = []

    def farms_local_flow(self, chain, S, fold, *args):
        self.folds.append(bool(fold))
        return super().farms_local_flow(chain, S, fold, *args)


@pytest.mark.parametrize("correction", [True, False])
def test_card_path_counts_correction_launches_on_cpu_tensors(monkeypatch,
                                                             correction):
    """One kernels.local_flow_correction_launches a correction-mode launch
    (one a micro-step), none for the phases' fits, and none at all without
    the correction; the outputs bitwise the plain path's, traced and
    untraced."""
    cell = _small_cell()
    # two micro-steps a call: a profiled step on the CPU records
    # thousands of ops
    cell.config["flow"]["steps_per_scan"] = 2
    if not correction:
        cell.config["flow"]["center_correction"] = 0
    steps = 2
    ev = _events(cell, steps * SMALL["chunk_size"])
    plain = harness.make_engine(cell, "cpu").process(ev)
    eng = harness.make_engine(cell, "cpu")
    _card_path_on_cpu(monkeypatch, eng.cfg)
    lib = _FoldRecorder(eng.cfg)
    monkeypatch.setattr(tk._build, "load", lambda: lib)
    tk.reset_launches()
    untraced = harness.make_engine(cell, "cpu").process(ev)
    assert tracing.totals() == {"spans": {}, "counters": {}}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        traced = eng.process(ev)
    P = cell.flow["sub_phases"]
    fits = steps * (P + correction)            # a run's launches
    assert lib.folds == 2 * (P * [True] + correction * [False]) * steps
    assert tk.LAUNCHES["local_flow"] == 2 * fits
    assert tk.COUNTERS == {"kernels.local_flow_general_launches": 0,
                           CORRECTION: 2 * steps * correction}
    t = tracing.totals()
    assert t["spans"]["kernels.local_flow"][0] == fits
    assert t["counters"].get(CORRECTION, 0) == steps * correction
    assert "kernels.local_flow_general_launches" not in t["counters"]
    _assert_bitwise(untraced, plain)
    _assert_bitwise(traced, plain)


def test_graph_takes_the_capture_counts_back_and_adds_them_at_replay():
    """A resident graph's bookkeeping: the capture's counts come off
    kernels.LAUNCHES and kernels.COUNTERS once, and each replay adds them,
    to the tracing counters too while a profiler records."""
    graph = teng._ResidentGraph.__new__(teng._ResidentGraph)
    graph.counts = [dict.fromkeys(tk.LAUNCHES, 0), dict(tk.COUNTERS)]
    graph.counts[0].update(local_flow=96, aperture=64, integral=64)
    graph.counts[1][CORRECTION] = 32
    tk.reset_launches()
    for k, n in graph.counts[0].items():         # what the capture counted
        tk.LAUNCHES[k] += n
    tk.COUNTERS[CORRECTION] += 32
    graph._count(-1)
    assert not any(tk.LAUNCHES.values()) and not any(tk.COUNTERS.values())
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        graph._count(1)
        graph._count(1)
    assert tk.LAUNCHES == {k: 2 * n for k, n in graph.counts[0].items()}
    assert tk.COUNTERS[CORRECTION] == 64
    assert tracing.totals()["counters"] == {CORRECTION: 64}
    tk.reset_launches()


# ---- the reader -------------------------------------------------------------

def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "flowbench_metric_" + name.replace(".", "_"))


def _reading(traced, kernels, cell=CELL):
    """Two traced replays of the full cell's 4,194,304 events (32
    micro-steps each) and an untraced one, with the kernels' device
    time."""
    flow = harness.load_cell(cell).flow
    calls = [{"events": 4194304, "traced": i < traced, "due": None,
              "start": 0.0, "end": 0.0} for i in range(traced + 1)]
    trace = {"kernels": kernels, "busy_s": 0.1, "window_s": 0.2}
    return {"calls": calls, "trace": trace, "flow": flow, "traffic": {},
            "config": {}}


_STREAMED = {"void local_flow_streamed<1>(int const*, int)": (192, 0.0125)}
# 40.716 us a micro-step at 1280 x 720 (below) x 64 micro-steps over 12.5 ms
_HD = 100.0 * 64 * (2 * 56 + 36) * 921600 / 3.35e12 / 0.0125


@pytest.mark.parametrize("counters,traced,cell,want", [
    ({CORRECTION: 64}, 2, CELL, _HD),
    # the DAVIS240C's 43,200 pixels
    ({CORRECTION: 64}, 2, "davis240c.resident", _HD * 43200 / 921600),
    # no correction launch counted: no reading
    ({"kernels.local_flow_general_launches": 64}, 2, CELL, None),
    # no traced replay
    ({CORRECTION: 64}, 0, CELL, None),
])
def test_fid_reader_reads_the_totals(monkeypatch, counters, traced, cell,
                                     want):
    monkeypatch.setattr(tracing, "_counters", dict(counters))
    got = _reader("local_flow_roofline_pct.fid").read(
        _reading(traced, _STREAMED, cell))
    assert got == pytest.approx(want) if want is not None else got is None


def test_fid_reader_gives_none_without_totals():
    assert _reader("local_flow_roofline_pct.fid").read(
        _reading(2, _STREAMED)) is None


def test_fid_bound_counts_the_chains_and_the_correction():
    """The plane fits of a fidelity micro-step at k = 3: two phase passes
    over the 8-surface snapshot chain (9 surfaces read, 5 maps written)
    and the correction pass over the coarse chain of 1 + P = 3, each
    bytes-bound: 40.716 us at 1280 x 720."""
    flow = harness.load_cell(CELL).flow
    px = flow["width"] * flow["height"]
    chain8 = (8 + 1 + 5) * px * 4 / roofline.PEAK_BYTES
    chain3 = (3 + 1 + 5) * px * 4 / roofline.PEAK_BYTES
    assert roofline.local_flow_pass(3, 8, px) == pytest.approx(chain8)
    assert roofline.local_flow_pass(3, 3, px) == pytest.approx(chain3)
    assert roofline.local_flow_step(flow) == pytest.approx(2 * chain8
                                                           + chain3)
    assert roofline.local_flow_step(flow) == pytest.approx(40.716e-6,
                                                           rel=1e-4)


# ---- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_fidelity_resident_at_full_size_matches_the_reference(cuda):
    """process_resident at the configuration as its file states it (1280 x
    720, chunk 131,072, 8 snapshots, the correction of 32,768 lanes) over
    the cell's 4,194,304 events: fn() replays a graph, and two replays
    under a profiler count their 32 correction passes each; the last
    replay and the state after it judged under the cell's limits."""
    cell = harness.load_cell(CELL)
    n = int(cell.traffic["stream_events"])
    steps = n // cell.flow["chunk_size"]
    ev = _events(cell, n, cuda)
    eng = harness.make_engine(cell, cuda)
    fn, _ = eng.process_resident(ev)
    start = eng.state
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            eng.state = start
            main, aux = fn()
    torch.cuda.synchronize()
    counters = tracing.totals()["counters"]
    assert counters["engine.graph_replays"] == 2
    assert counters["engine.resident_calls"] == 2
    assert counters[CORRECTION] == 2 * steps
    assert "kernels.local_flow_general_launches" not in counters
    from flowbench.reference.dense import Semantics, decode_wire
    main, aux = main.cpu().numpy(), aux.cpu().numpy()
    C = main.shape[1]
    cols = decode_wire(main.transpose(1, 0, 2).reshape(C, -1)[:, :n],
                       aux.reshape(-1)[:n], Semantics.from_dict(cell.flow))
    sample = harness.sample_record(ev, None, cols, eng.whole_state())
    del eng, fn
    torch.cuda.empty_cache()
    nums = judge([sample], cell.flow, int(ev.t[0]), cuda)
    assert _within(nums, cell.limits), nums

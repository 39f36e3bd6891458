"""The resident call as one CUDA graph, and the device step number that
makes it replayable.

Every micro-step takes its phases' write epochs (step * sub_phases +
phase) from the step's number on the device (the batch's "step", which
scan_chunk fills from state.step), not from a host integer; the integral
kernel resets its counters itself. The single engine's process_resident
on a card then captures its call (`_run_call`) once and replays it
(pipeline/engine.py `_ResidentGraph`).

On the CPU (no JAX):
- scan_chunk at the benchmark and fidelity presets, from a state at a
  later step, gives bit for bit what the micro-steps give with the host
  integer the step took before: every state map and wire block; the
  epoch map holds step * P + p of each pixel's last winning phase,
  computed from the packed winners;
- fn() advances `SurfaceState.step` by the call's steps, from any start;
- a CPU engine's fn() counts `engine.resident_calls` and replays no graph;
- the reader of `graph_replay_pct.resident`.

On the card (marked `cuda`; skips without one): at 1280 x 720, both
presets, the graph's fn() against the eager steps bit for bit, first and
later calls, from states at other steps, its returned blocks untouched by
later replays; the integral kernel captured once and replayed 100 times;
at k = 7 the kernels a profiler sees a replay run, by name, against the
eager steps' launches, and the counts a replay adds; an eager call's
steps and a replay make no stream synchronisation and no host-to-device
copy; the dp and spatial engines' fn() replays no graph.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.ops import kernels as tk
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.state.surfaces import SurfaceState
from farms_tpu_torch.utils import tracing
from flowbench import harness
from flowbench.traffic.gen import rotating_edges

torch.set_num_threads(1)

_MAPS = ("t_surf", "epoch", "flow_len", "flow_vx", "flow_vy")
# the presets' operating points (farms_tpu_torch/cli.py) at a chunk that
# suits the sensor
_PRESETS = {
    "benchmark": dict(sub_phases=2, wire="f16"),
    "fidelity": dict(sub_phases=2, aperture_sub_phases=2, causal_snapshots=8,
                     correction_coarse_chain=True, wire="f16"),
}


@pytest.fixture(autouse=True)
def clean_totals():
    tracing.reset()
    yield
    tracing.reset()


def _cfg(preset: str, width: int, height: int, chunk: int, **kw):
    kw = dict(_PRESETS[preset], width=width, height=height, chunk_size=chunk,
              steps_per_scan=8, **kw)
    if preset == "fidelity":
        kw["center_correction"] = chunk // 4
    return FlowConfig(**kw)


def _events(cfg: FlowConfig, n: int, seed: int) -> EventBatch:
    s = rotating_edges(cfg.width, cfg.height, rate=10e6, n_events=n,
                       edges=16, seed=seed)
    return EventBatch(s.x, s.y, s.t, s.p)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().cpu().view(torch.uint8).numpy().tobytes()


def _assert_states_equal(a: SurfaceState, b: SurfaceState, what=""):
    assert a.step == b.step, what
    for f in _MAPS:
        assert _bits(getattr(a, f)) == _bits(getattr(b, f)), f"{what} {f}"


def _assert_wires_equal(a, b, what=""):
    for x, y, name in zip(a, b, ("main", "aux")):
        assert x.shape == y.shape and _bits(x) == _bits(y), f"{what} {name}"


def _later_state(eng, ev, calls: int):
    """The engine's state after `calls` process() calls of one micro-step
    each (ev's first events), and the events left."""
    m = eng.cfg.chunk_size
    eng.process(EventBatch(ev.x[:calls * m], ev.y[:calls * m],
                           ev.t[:calls * m], ev.pol[:calls * m]), 1)
    assert eng.state.step == calls
    return eng.state, EventBatch(ev.x[calls * m:], ev.y[calls * m:],
                                 ev.t[calls * m:], ev.pol[calls * m:])


# ---- the device step number, on the CPU -------------------------------------

def _host_step_scan(state, chunk, cfg):
    """The micro-steps with the host integer state.step as the step's
    number: the epoch formulation before the device step (a Python int
    scattered into the epoch map and compared with it)."""
    mains, auxs = [], []
    for i in range(chunk["ev"].shape[0]):
        batch = {k: v[i] for k, v in chunk.items()}
        batch["step"] = state.step
        state, (main, aux) = teng.micro_step(state, batch, cfg)
        mains.append(main)
        auxs.append(aux)
    return state, (torch.stack(mains), torch.stack(auxs))


def _winner_epochs(epoch0: np.ndarray, rows5: np.ndarray, step0: int,
                   P: int, W: int, H: int) -> np.ndarray:
    """The epoch map after a 5-row call: each phase's winners' pixels take
    (step0 + s) * P + p, in order."""
    ep = epoch0.copy().reshape(-1)
    for s, b in enumerate(rows5):
        x, y, valid, win = b[0], b[1], b[3] != 0, b[4] != 0
        seg = b.shape[1] // P
        for p in range(P):
            sl = slice(p * seg, (p + 1) * seg)
            w = valid[sl] & win[sl]
            ep[(x[sl][w].astype(np.int64) * H + y[sl][w])] = (
                (step0 + s) * P + p)
    return ep.reshape(W, H)


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_device_step_equals_the_host_integer(preset):
    cfg = _cfg(preset, 96, 64, 2048)
    ev = _events(cfg, 7 * cfg.chunk_size - 300, seed=11)
    eng = teng.FlowEngine(cfg, device="cpu")
    state, rest = _later_state(eng, ev, 3)
    chunk = next(eng.device_calls(rest, 4, rows5=True))
    got_state, got = teng.scan_chunk(state, chunk, cfg)
    want_state, want = _host_step_scan(state, chunk, cfg)
    _assert_states_equal(got_state, want_state, preset)
    _assert_wires_equal(got, want, preset)
    assert got_state.step == 3 + 4
    epochs = _winner_epochs(state.epoch.numpy(), chunk["ev"].numpy(), 3,
                            cfg.sub_phases, cfg.width, cfg.height)
    assert np.array_equal(got_state.epoch.numpy(), epochs)
    assert (epochs >= 3 * cfg.sub_phases).any()


def test_resident_fn_advances_the_step():
    cfg = _cfg("benchmark", 96, 64, 2048)
    ev = _events(cfg, 5 * cfg.chunk_size, seed=12)
    eng = teng.FlowEngine(cfg, device="cpu")
    start, rest = _later_state(eng, ev, 2)
    fn, n = eng.process_resident(rest)
    assert eng.state is start
    out = fn()
    assert eng.state.step == 2 + 3
    out2 = fn()
    assert eng.state.step == 2 + 6
    assert not torch.equal(out[0], out2[0]) or not torch.equal(out[1],
                                                               out2[1])
    eng.state = start
    _assert_wires_equal(fn(), out, "replayed from the start")
    assert eng.state.step == 5


def test_cpu_resident_fn_counts_calls_and_replays_no_graph():
    cfg = _cfg("benchmark", 96, 64, 2048)
    eng = teng.FlowEngine(cfg, device="cpu")
    fn, _ = eng.process_resident(_events(cfg, 2 * cfg.chunk_size, seed=13))
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        fn()
        fn()
    counters = tracing.totals()["counters"]
    assert counters["engine.resident_calls"] == 2
    assert "engine.graph_replays" not in counters


def test_graph_replay_pct_reader():
    mod = harness.load_module(harness.HERE / "metrics"
                              / "graph_replay_pct.resident.py", "m")
    calls = [{"traced": True, "events": 8}, {"traced": False, "events": 8}]
    assert mod.read({"calls": calls, "trace": None}) is None
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        tracing.count("engine.resident_calls", 4)
        tracing.count("engine.graph_replays", 3)
    assert mod.read({"calls": calls, "trace": None}) == 75.0
    assert mod.read({"calls": [], "trace": None}) is None


# ---- the graph on the card --------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _chunk(eng, ev):
    """ev's resident call, packed and uploaded as process_resident does."""
    spc = -(-len(ev) // eng.cfg.chunk_size)
    twin = teng.FlowEngine(eng.cfg, device=eng.device)
    twin._t0 = eng._t0                  # the stream's first stamp
    return next(twin.device_calls(ev, spc, rows5=True))


def _eager(eng, ev, state):
    """The eager steps of ev's resident call from `state`."""
    return teng.scan_chunk(state, _chunk(eng, ev), eng.cfg)


def _traced(run):
    """run() and a wait for the card inside a torch profiler of the host
    and the card; returns its events."""
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return prof.events()


def _clone(state: SurfaceState) -> SurfaceState:
    return SurfaceState(*(getattr(state, f).clone() for f in _MAPS),
                        state.step)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_cuda_resident_graph_equals_eager(cuda, preset):
    """fn() replays the graph: equal to the eager steps bit for bit on its
    first and later calls, from the start state and from states at other
    steps (the epochs are not baked in), and a state or wire block one
    fn() returned is unchanged by later replays."""
    cfg = _cfg(preset, 1280, 720, 131072)
    ev = _events(cfg, 4 * cfg.chunk_size, seed=2**31 + 21)
    eng = teng.FlowEngine(cfg, device=cuda)
    start, rest = _later_state(eng, ev, 1)
    fn, n = eng.process_resident(rest)
    steps = -(-n // cfg.chunk_size)
    kept = []
    for i, st in enumerate((start, start, None, start)):
        eng.state = st if st is not None else eng.state
        before = _clone(eng.state)
        want_state, want = _eager(eng, rest, before)
        got = fn()
        _assert_wires_equal(got, want, f"{preset} call {i}")
        _assert_states_equal(eng.state, want_state, f"{preset} call {i}")
        assert eng.state.step == before.step + steps
        kept.append((got, _clone(eng.state), eng.state,
                     tuple(w.clone() for w in got)))
    # from a state at a far step: other epochs, the same flow
    far = SurfaceState(*(getattr(start, f) for f in _MAPS), 1000)
    eng.state = far
    want_state, want = _eager(eng, rest, _clone(far))
    got = fn()
    _assert_wires_equal(got, want, "far")
    _assert_states_equal(eng.state, want_state, "far")
    torch.cuda.synchronize()
    for got, copy, state, wire in kept:
        _assert_wires_equal(got, wire, "a returned block")
        _assert_states_equal(state, copy, "a returned state")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1280, 720), (320, 320), (33, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_integral_replays_a_captured_launch(cuda, shape):
    """One integral launch captured, its graph replayed 100 times back to
    back, then in turns with eager launches on another stream: each
    equals the plain version bit for bit, with no trap (every launch
    leaves its counters at 0)."""
    rng = np.random.default_rng(shape[0])
    fields = [torch.from_numpy((rng.standard_normal(shape) * (
        rng.random(shape) < 0.3)).astype(np.float32)).to(cuda)
        for _ in range(3)]
    fields[0] = fields[0].abs()
    want = tdf.build_integral(*fields).view(torch.int64)
    tk.integral(*fields)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tk.integral(*fields)
    outs = []
    for _ in range(100):
        graph.replay()
        outs.append(captured.clone())
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            graph.replay()
            outs.append(captured.clone())
            outs.append(tk.integral(*fields))
    torch.cuda.synchronize()
    assert all(torch.equal(o.view(torch.int64), want) for o in outs)


def _device_launches(run, want):
    """kernels.device_launches of run() in up to three traces, until one
    counts `want` (a trace now and then drops a device event); the
    counts of the last trace."""
    for _ in range(3):
        tracing.reset()
        tk.reset_launches()
        seen = tk.device_launches(_traced(run))
        if seen == want:
            break
    return seen


@pytest.mark.cuda
def test_cuda_replays_count_their_launches_at_k7(cuda):
    """At k = 7 the card runs in three replays three times the kernels of
    the eager steps, each counted by its name in a profiler's device
    events; the eager steps' own counts are their launches. The replays'
    bookkeeping adds the same to kernels.LAUNCHES, and the general plane
    fits to the counter kernels.local_flow_general_launches; the capture
    itself counts only its eager warm-up."""
    cfg = _cfg("benchmark", 1280, 720, 131072, filter_size=7)
    ev = _events(cfg, 2 * cfg.chunk_size, seed=2**31 + 7)
    eng = teng.FlowEngine(cfg, device=cuda)
    start = eng.state
    tk.reset_launches()
    _eager(eng, ev, start)
    eager = dict(tk.LAUNCHES)
    assert eager["local_flow_general"] == 2 * cfg.sub_phases
    assert _device_launches(lambda: _eager(eng, ev, start), eager) == eager
    tk.reset_launches()
    fn, _ = eng.process_resident(ev)
    assert tk.LAUNCHES == eager                  # the warm-up alone

    def replays():
        for _ in range(3):
            eng.state = start
            fn()

    want = {k: 3 * n for k, n in eager.items()}
    assert _device_launches(replays, want) == want
    assert tk.LAUNCHES == want
    counters = tracing.totals()["counters"]
    assert counters["kernels.local_flow_general_launches"] == 3 * eager[
        "local_flow_general"]
    assert counters["engine.resident_calls"] == 3
    assert counters["engine.graph_replays"] == 3
    assert "kernels.local_flow" not in tracing.totals()["spans"]


@pytest.mark.cuda
@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_cuda_steps_wait_on_nothing(cuda, preset):
    """One eager call's steps (process()'s) and one graph fn() at 1280 x
    720 on an uploaded chunk: the profiler records no
    cudaStreamSynchronize and no host-to-device copy, while it records the
    eager kernel launches and the graph launch."""
    cfg = _cfg(preset, 1280, 720, 131072)
    ev = _events(cfg, 2 * cfg.chunk_size, seed=2**31 + 9)
    eng = teng.FlowEngine(cfg, device=cuda)
    start = eng.state
    chunk = _chunk(eng, ev)
    fn, _ = eng.process_resident(ev)
    for launch, run in (("cudaLaunchKernel",
                         lambda: teng.scan_chunk(start, chunk, cfg)),
                        ("cudaGraphLaunch", fn)):
        eng.state = start
        names = collections.Counter(e.name for e in _traced(run))
        assert names[launch] >= 1, launch
        assert names["cudaStreamSynchronize"] == 0, launch
        assert not [n for n in names if "HtoD" in n], launch


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dp", "spatial"])
def test_cuda_sharded_resident_fn_replays_no_graph(cuda, engine):
    """The dp and spatial engines' process_resident (one in-process rank)
    run their steps eagerly: fn() counts a resident call, no graph
    replay, and gives the single engine's graph replay bit for bit."""
    from farms_tpu_torch.parallel import ShardedFlowEngine
    from farms_tpu_torch.parallel.tiling import SpatialFlowEngine
    cfg = _cfg("benchmark", 1280, 720, 131072)
    ev = _events(cfg, 2 * cfg.chunk_size, seed=2**31 + 5)
    single = teng.FlowEngine(cfg, device=cuda)
    want = single.process_resident(ev)[0]()
    make = ShardedFlowEngine if engine == "dp" else SpatialFlowEngine
    eng = make(cfg, device=cuda)
    fn, _ = eng.process_resident(ev)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        got = fn()
    torch.cuda.synchronize()
    counters = tracing.totals()["counters"]
    assert counters["engine.resident_calls"] == 1
    assert "engine.graph_replays" not in counters
    _assert_wires_equal(got, want, engine)

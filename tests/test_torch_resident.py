"""The explicit 5-row batch layout, FlowEngine.process_resident and the
benchmark harness of the port, against farms_tpu.

- pack(compact=False) is bitwise equal to farms_tpu's 5-row pack
  (farms_tpu/pipeline/engine.py:811-908).
- micro_step on a 5-row batch equals the compact batch on every lane,
  padded lanes included (they decode to the sentinel pixel), and agrees
  with farms_tpu's 5-row micro_step as the engines agree
  (tests/test_torch_engine.py `_assert_engines_agree`).
- process_resident's outputs equal process() bit for bit, at both
  presets' shapes, replayed from its start state; and agree with
  farms_tpu's process_resident. The halo engine's counterpart equals the
  single engine on 2 gloo ranks.
- The harness prints farms_tpu's JSON lines.
"""
import json

import numpy as np
import pytest
import torch

from farms_tpu_torch.bench import harness as tharness
from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.state.surfaces import init_state

from test_torch_engine import _assert_engines_agree, _multi_pass_bar
from test_torch_halo_ranks import resident_runs

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


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig
    from farms_tpu.pipeline import engine
    from farms_tpu.state.surfaces import init_state as jinit
    return FlowConfig, engine, jinit


@pytest.fixture(scope="module")
def stream():
    """A collision-rich stream of 3 bar sweeps and noise, cut so its last
    micro-step has padded lanes."""
    ev = _multi_pass_bar(3)[:3000]
    assert len(ev) % 256
    return ev


def _assert_bitwise(a, b, what=""):
    assert len(a) == len(b)
    for col in COLUMNS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
            f"{what} {col}"


def _recording(monkeypatch):
    """The flow_len surface each aperture pass reads, in pass order."""
    passes = []
    aperture = teng.kernels.aperture

    def recording(flow_len, flow_vx, flow_vy, cfg):
        passes.append(flow_len.clone())
        return aperture(flow_len, flow_vx, flow_vy, cfg)

    monkeypatch.setattr(teng.kernels, "aperture", recording)
    return passes


@pytest.mark.parametrize("preset", list(_PRESETS))
def test_five_row_pack_equals_jax(jax_mods, stream, preset):
    """The 5-row pack of two consecutive parts of a stream, bitwise."""
    JConfig, jeng, _ = jax_mods
    kw = _PRESETS[preset]
    jeng_ = jeng.FlowEngine(JConfig(**kw))
    eng = teng.FlowEngine(TConfig(**kw), device="cpu")
    for part in (stream[:1100], stream[1100:]):
        want, wn = jeng_.pack(part)
        got, gn = eng.pack(part)
        assert gn == wn == len(part)
        assert got.shape == want.shape and got.shape[2] == 5
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _decoded(eng, out, ev):
    main, aux = (a.cpu().numpy() for a in out)
    return eng._unpack_outputs([(main, aux)], ev, len(ev))


@pytest.mark.parametrize("kw", [_BENCH, dict(_BENCH, wire="f32"),
                                dict(_BENCH, use_dense=False)],
                         ids=["f16", "f32", "perevent"])
def test_micro_step_five_rows_equal_compact(stream, kw):
    """scan_chunk on the 5-row batch equals the compact batch on every
    lane (wire words and aux bytes, padded lanes included) and leaves the
    same state."""
    cfg = TConfig(**kw)
    eng = teng.FlowEngine(cfg, device="cpu")
    spc = -(-len(stream) // cfg.chunk_size)
    rows5 = torch.from_numpy(eng.pack(stream, spc)[0][0])
    compact = torch.from_numpy(eng.pack(stream, spc, compact=True)[0][0])
    assert rows5.shape[1] == 5 and compact.shape[1] == 2
    # the decoded lanes: padded ones at the compact sentinel (x = W, y = 0)
    for a, b in zip(teng._decode_batch({"ev": rows5[-1]}, cfg),
                    teng._decode_batch({"ev": compact[-1]}, cfg)):
        assert torch.equal(a, b)
    outs = [teng.scan_chunk(init_state(cfg, "cpu"), {"ev": b}, cfg)
            for b in (rows5, compact)]
    (s5, (m5, a5)), (s2, (m2, a2)) = outs
    assert torch.equal(m5, m2) and torch.equal(a5, a2)
    for f in ("t_surf", "epoch", "flow_len", "flow_vx", "flow_vy"):
        a, b = getattr(s5, f), getattr(s2, f)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f


def test_padded_lanes_never_reach_pixel_zero():
    """A stream whose events avoid pixel (0, 0): after the 5-row call
    with padded lanes (packed at x = y = 0) the pixel is still unwritten
    and its flow zero."""
    cfg = TConfig(**_BENCH)
    ev = tio.synthetic_random_events(300, width=64, height=64, seed=2)
    ev.x[:] = np.maximum(ev.x, 1)
    eng = teng.FlowEngine(cfg, device="cpu")
    packed, _ = eng.pack(ev)
    assert (packed[..., 3, :] == 0).any()
    state, _ = teng.scan_chunk(eng.state, {"ev": torch.from_numpy(
        packed[0])}, cfg)
    assert int(state.t_surf[0, 0]) == 0 and int(state.epoch[0, 0]) == -1


@pytest.mark.parametrize("preset", ["benchmark"])
def test_micro_step_five_rows_agrees_with_jax(jax_mods, stream, preset,
                                              monkeypatch):
    """scan_chunk on the 5-row batch against farms_tpu's scan_chunk on
    the same batch (epoch path, no escapes), decoded, on the real lanes;
    under correction both would take the call's rank-2 data (the fidelity
    shape's 5-row call is held to farms_tpu through process_resident
    below)."""
    JConfig, jeng, jinit = jax_mods
    import jax.numpy as jnp

    kw = _PRESETS[preset]
    cfg, jcfg = TConfig(**kw), JConfig(**kw)
    eng = teng.FlowEngine(cfg, device="cpu")
    jeng_ = jeng.FlowEngine(jcfg)
    spc = -(-len(stream) // cfg.chunk_size)
    packed, _ = eng.pack(stream, spc)
    jbatch = {"ev": jnp.asarray(packed[0])}
    batch = {"ev": torch.from_numpy(packed[0])}
    if cfg.center_correction:
        flags, centers = eng.pack_r2(stream, spc)
        jbatch.update(r2f=jnp.asarray(flags[0]), r2c=jnp.asarray(centers[0]))
        batch.update(r2f=torch.from_numpy(flags[0]),
                     r2c=torch.from_numpy(centers[0]))
    jeng_.pack(stream, spc)                       # latch t0
    _, jout = jeng.scan_chunk(jinit(jcfg), jbatch, jcfg)
    want = jeng_._unpack_outputs([tuple(np.asarray(a) for a in jout)],
                                 stream, len(stream))
    passes = _recording(monkeypatch)
    _, out = teng.scan_chunk(init_state(cfg, "cpu"), batch, cfg)
    got = _decoded(eng, out, stream)
    _assert_engines_agree(want, got, passes, cfg, f"5-row {preset}")


@pytest.mark.parametrize("preset", list(_PRESETS))
def test_process_resident_equals_process(stream, preset):
    """process_resident's call, replayed twice from its start state,
    decodes to process()'s output bit for bit; the dp and multihost
    engines' counterparts (one in-process rank) equal it."""
    from farms_tpu_torch.parallel import MultiHostFlowEngine, ShardedFlowEngine
    cfg = TConfig(**_PRESETS[preset])
    want = teng.FlowEngine(cfg, device="cpu").process(stream)
    for make in (teng.FlowEngine, ShardedFlowEngine, MultiHostFlowEngine):
        eng = make(cfg, device="cpu")
        fn, n = eng.process_resident(stream)
        assert n == len(stream)
        start = eng.state
        for _ in range(2):
            eng.state = start
            _assert_bitwise(want, _decoded(eng, fn(), stream),
                            make.__name__)
        assert eng.state.step == start.step + -(-n // cfg.chunk_size)


@pytest.mark.parametrize("preset", list(_PRESETS))
def test_process_resident_agrees_with_jax(jax_mods, stream, preset,
                                          monkeypatch):
    JConfig, jeng, _ = jax_mods
    kw = _PRESETS[preset]
    jeng_ = jeng.FlowEngine(JConfig(**kw))
    jfn, n = jeng_.process_resident(stream)
    want = jeng_._unpack_outputs([tuple(np.asarray(a) for a in jfn())],
                                 stream, n)
    cfg = TConfig(**kw)
    eng = teng.FlowEngine(cfg, device="cpu")
    fn, _ = eng.process_resident(stream)
    passes = _recording(monkeypatch)
    got = _decoded(eng, fn(), stream)
    _assert_engines_agree(want, got, passes, cfg, f"resident {preset}")


def test_halo_process_resident_on_two_ranks(stream):
    """HaloFlowEngine.process_resident on 2 gloo ranks (owner-sharded
    layout), replayed twice, equals the single engine's process()."""
    cfg = TConfig(**_BENCH)
    want = teng.FlowEngine(cfg, device="cpu").process(stream)
    outs = mesh.run(resident_runs, 2, "cpu", cfg, stream)
    for got in outs:
        _assert_bitwise(want, got, "halo")


def test_time_resident_restores_its_start_state(stream, monkeypatch):
    """The harness's replay timing leaves the engine at the state before
    its first call, and reports a rate."""
    cfg = TConfig(**_BENCH)
    eng = teng.FlowEngine(cfg, device="cpu")
    monkeypatch.setattr(tharness, "TARGET_EVENTS", 2 * len(stream))
    rate = tharness._time_resident(eng, stream, reps=1)
    assert rate > 0
    assert eng.state.step == 0 and int(eng.state.t_surf.abs().sum()) == 0


def test_harness_main_prints_jax_lines(jax_mods, monkeypatch, capsys,
                                       tmp_path):
    """With a stubbed config, the port's `main` prints farms_tpu's JSON
    line (keys, order, rounding) and appends it to --out."""
    pytest.importorskip("jax")
    from farms_tpu.bench import harness as jharness

    def stub(mod):
        def run():
            return [mod.BenchResult("config1_100k_fs5", 98304,
                                    123456.789, {}),
                    mod.BenchResult("config5_1280x720_dev1", 262144,
                                    0.04, {"engine": "FlowEngine",
                                           "devices": 1})]
        return run

    monkeypatch.setattr(jharness, "ALL_CONFIGS", {"1": stub(jharness)})
    jharness.main(["--configs", "1"])
    want = capsys.readouterr().out
    monkeypatch.setattr(tharness, "ALL_CONFIGS", {"1": stub(tharness)})
    out = tmp_path / "lines.jsonl"
    assert tharness.main(["--configs", "all", "--out", str(out)]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert out.read_text() == want
    assert list(json.loads(got.splitlines()[1])) == [
        "config", "events", "events_per_sec", "engine", "devices"]
    with pytest.raises(SystemExit):
        tharness.main(["--configs", "9"])

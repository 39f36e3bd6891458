"""The port's streaming ingestion and event I/O (farms_tpu_torch/events/
stream.py, events/io.py) against farms_tpu's: the cases of
tests/test_stream.py, tests/test_io.py and tests/test_dataset_layouts.py on
the port, each beside the farms_tpu function on the same input.

- The port's stream over micro-batch-aligned chunks equals its one-shot
  process() bit for bit; over chunks that are not whole calls (and not
  whole micro-steps) it equals farms_tpu's stream on the same chunking
  within the engine comparison's bounds (tests/test_torch_engine.py).
- File and generator functions are NumPy on both sides and equal exactly.
"""
import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.events import stream as tstream
from farms_tpu_torch.pipeline import engine as teng

from test_torch_engine import _assert_engines_agree

torch.set_num_threads(1)

COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
           "r_local", "theta_local", "scale")


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig
    from farms_tpu.events import io, stream
    from farms_tpu.pipeline.engine import FlowEngine
    return FlowConfig, io, stream, FlowEngine


def _bar(n=512, w=64):
    return tio.synthetic_translating_bar(width=w, height=w, bar_len=16,
                                         duration_us=25000,
                                         jitter_us=15)[:n]


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for col in COLUMNS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col


# ---- tests/test_stream.py on the port ------------------------------------

@pytest.mark.parametrize("kw, chunk_events", [
    (dict(chunk_size=64, steps_per_scan=2), 128),
    (dict(chunk_size=64, steps_per_scan=2, sub_phases=4, wire="f16"), 192),
])
def test_stream_equals_oneshot(tmp_path, kw, chunk_events):
    """test_stream.py:14 and :45: aligned chunks (a whole call; 1.5 calls
    with phases and the f16 wire) equal one process() bit for bit."""
    ev = _bar()
    path = tio.write_events_txt(ev, str(tmp_path / "s"))
    cfg = TConfig(width=64, height=64, **kw)
    one = teng.FlowEngine(cfg, device="cpu").process(ev)
    streamed = tstream.process_file_streaming(
        teng.FlowEngine(cfg, device="cpu"), path, chunk_events=chunk_events)
    assert (one.r_local > 0).sum() > 50
    _assert_bitwise(one, streamed)


@pytest.mark.parametrize("chunk_events", [320, 100])
def test_stream_equals_jax_stream(jax_mods, tmp_path, chunk_events,
                                  monkeypatch):
    """The port's process_file_streaming against farms_tpu's on the same
    file and chunking: 320 events are 5 micro-steps (2.5 calls of 2), 100
    not even a whole micro-step; farms_tpu's stream carries the same
    padding, so the two agree as the engines do on one stream."""
    JConfig, jio, jstream, JEngine = jax_mods
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=40,
                                       duration_us=40000, jitter_us=20,
                                       seed=5)[:2000]
    path = tio.write_events_txt(ev, str(tmp_path / "j"))
    kw = dict(width=64, height=64, chunk_size=64, steps_per_scan=2,
              sub_phases=2, wire="f16")
    want = jstream.process_file_streaming(JEngine(JConfig(**kw)), path,
                                          chunk_events=chunk_events)
    passes = []
    aperture = teng.kernels.aperture

    def recording(flow_len, flow_vx, flow_vy, cfg):
        passes.append(flow_len.clone())
        return aperture(flow_len, flow_vx, flow_vy, cfg)

    monkeypatch.setattr(teng.kernels, "aperture", recording)
    cfg = TConfig(**kw)
    got = tstream.process_file_streaming(teng.FlowEngine(cfg, device="cpu"),
                                         path, chunk_events=chunk_events)
    assert len(got) == len(want) == len(ev)
    _assert_engines_agree(want, got, passes, cfg,
                          f"stream of {chunk_events}")


def test_iter_file_chunks(jax_mods, tmp_path):
    _, _, jstream, _ = jax_mods
    ev = tio.synthetic_translating_bar(width=48, height=48, bar_len=10,
                                       duration_us=10000)[:100]
    path = tio.write_events_txt(ev, str(tmp_path / "c"))
    chunks = list(tstream.iter_file_chunks(path, 30))
    want = list(jstream.iter_file_chunks(path, 30))
    assert [len(c) for c in chunks] == [len(c) for c in want] == [30, 30,
                                                                  30, 10]
    np.testing.assert_array_equal(np.concatenate([c.x for c in chunks]),
                                  ev.x)
    for a, b in zip(chunks, want):
        np.testing.assert_array_equal(a.t, b.t)


def test_stream_prefetch_and_meter():
    """test_stream.py:68: the producer thread and the meter; outputs equal
    the unprefetched stream's and the one-shot run's."""
    ev = _bar()
    cfg = TConfig(width=64, height=64, chunk_size=64, steps_per_scan=2)

    def chunks():
        for s in range(0, 512, 128):
            yield ev[s:s + 128]

    seen = []
    outs = list(tstream.stream_flow(
        teng.FlowEngine(cfg, device="cpu"), chunks(), prefetch=2,
        meter=lambda n, dt, nt, tt: seen.append((n, nt))))
    got = tio.FlowOutput.concatenate(outs)
    _assert_bitwise(teng.FlowEngine(cfg, device="cpu").process(ev), got)
    sizes = [min(128, len(ev) - s) for s in range(0, len(ev), 128)]
    assert [n for n, _ in seen] == sizes
    assert [nt for _, nt in seen] == list(np.cumsum(sizes))
    outs0 = list(tstream.stream_flow(teng.FlowEngine(cfg, device="cpu"),
                                     chunks(), prefetch=0))
    _assert_bitwise(got, tio.FlowOutput.concatenate(outs0))


def test_stream_prefetch_propagates_source_errors():
    """test_stream.py:104: a source that raises mid-stream raises in the
    consumer after the chunks before it."""
    cfg = TConfig(width=64, height=64, chunk_size=64, steps_per_scan=2)
    ev = _bar(256)

    def broken():
        yield ev[:128]
        raise IOError("disk went away")

    it = tstream.stream_flow(teng.FlowEngine(cfg, device="cpu"), broken(),
                             prefetch=2)
    next(it)
    with pytest.raises(IOError, match="disk went away"):
        next(it)


def test_abandoned_stream_stops_its_producer():
    """A consumer that closes the generator early releases the producer:
    it stops pulling the source instead of blocking on a full queue."""
    cfg = TConfig(width=64, height=64, chunk_size=64, steps_per_scan=2)
    ev = _bar(256)
    pulled = []

    def endless():
        while True:
            pulled.append(1)
            yield ev[:64]

    it = tstream.stream_flow(teng.FlowEngine(cfg, device="cpu"), endless(),
                             prefetch=1)
    next(it)
    it.close()
    import time
    time.sleep(0.6)
    n = len(pulled)
    time.sleep(0.6)
    assert len(pulled) == n <= 4


def test_print_meter(capsys):
    tstream.print_meter(1000, 0.001, 5000, 0.01)
    err = capsys.readouterr().err
    assert err.startswith("[stream] 1000 events in 1000 us")
    assert "500,000 ev/s over 5000 events" in err


def test_empty_file_streams_to_empty_output(tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text("")
    out = tstream.process_file_streaming(
        teng.FlowEngine(TConfig(width=64, height=64), device="cpu"),
        str(path))
    assert len(out) == 0


# ---- tests/test_io.py on the port, against farms_tpu ----------------------

def test_events_txt_roundtrip(jax_mods, tmp_path):
    _, jio, _, _ = jax_mods
    ev = tio.synthetic_random_events(500, width=100, height=80, seed=3)
    want = jio.synthetic_random_events(500, width=100, height=80, seed=3)
    path = tio.write_events_txt(ev, str(tmp_path / "events"))
    jpath = jio.write_events_txt(want, str(tmp_path / "jevents"))
    assert open(path).read() == open(jpath).read()
    back = tio.load_events_txt(path)
    for col in ("x", "y", "t", "pol"):
        np.testing.assert_array_equal(getattr(ev, col), getattr(back, col))
        np.testing.assert_array_equal(getattr(want, col),
                                      getattr(back, col))


def test_load_clamps_negative_polarity(tmp_path):
    p = tmp_path / "neg.txt"
    p.write_text("3 4 100 -1\n5 6 200 1\n")
    assert list(tio.load_events_txt(str(p)).pol) == [0, 1]


def test_load_max_events(tmp_path):
    p = tmp_path / "cap.txt"
    p.write_text("".join(f"{i} {i} {i * 10} 1\n" for i in range(50)))
    assert len(tio.load_events_txt(str(p), max_events=7)) == 7


def test_flow_txt_roundtrip(jax_mods, tmp_path):
    """test_io.py:40, and the file equals farms_tpu's byte for byte."""
    _, jio, _, _ = jax_mods
    n = 64
    rng = np.random.default_rng(0)
    out = tio.FlowOutput(
        x=rng.integers(0, 320, n).astype(np.int32),
        y=rng.integers(0, 320, n).astype(np.int32),
        t=rng.integers(0, 10**6, n).astype(np.uint32),
        pol=rng.integers(0, 2, n).astype(np.int32),
        r_true=rng.normal(size=n) ** 2,
        theta_true=rng.uniform(-np.pi, np.pi, n),
        vx=rng.normal(size=n),
        vy=rng.normal(size=n),
        r_local=rng.normal(size=n) ** 2,
        theta_local=rng.uniform(-np.pi, np.pi, n),
        scale=(rng.integers(0, 11, n) * 5).astype(np.int32),
    )
    path = tio.write_flow_txt(out, str(tmp_path / "run"))
    assert path.endswith("_FARMSOut_batch.txt")  # vFlow.cpp:131
    jpath = jio.write_flow_txt(jio.FlowOutput(**vars(out)),
                               str(tmp_path / "jrun"))
    assert open(path, "rb").read() == open(jpath, "rb").read()
    back = tio.read_flow_txt(path)
    np.testing.assert_array_equal(out.x, back.x)
    np.testing.assert_array_equal(out.scale, back.scale)
    np.testing.assert_allclose(out.r_true, back.r_true, rtol=1e-4)
    np.testing.assert_allclose(out.vx, back.vx, rtol=1e-4)


def test_flow_output_concatenate(jax_mods):
    _, jio, _, _ = jax_mods
    ev = _bar(300)
    cfg = TConfig(width=64, height=64, chunk_size=64)
    a = teng.FlowEngine(cfg, device="cpu").process(ev)
    parts = [a.__class__(**{k: v[s] for k, v in vars(a).items()})
             for s in (slice(0, 100), slice(100, 300))]
    _assert_bitwise(a, tio.FlowOutput.concatenate(parts))
    jparts = [jio.FlowOutput(**vars(p)) for p in parts]
    _assert_bitwise(a, jio.FlowOutput.concatenate(jparts))


def test_synthetic_generators_match_jax(jax_mods):
    """The generators of both packages give the same streams, sorted and
    in bounds (test_io.py:63, :71)."""
    _, jio, _, _ = jax_mods
    pairs = [
        (tio.synthetic_translating_bar(width=64, height=64, bar_len=16,
                                       duration_us=20000),
         jio.synthetic_translating_bar(width=64, height=64, bar_len=16,
                                       duration_us=20000)),
        (tio.synthetic_random_events(1000, width=64, height=64),
         jio.synthetic_random_events(1000, width=64, height=64)),
        (tio.synthetic_rotating_shapes(duration_us=150_000, seed=1),
         jio.synthetic_rotating_shapes(duration_us=150_000, seed=1)),
    ]
    for ev, want in pairs:
        assert np.all(np.diff(ev.t.astype(np.int64)) >= 0)
        for col in ("x", "y", "t", "pol"):
            np.testing.assert_array_equal(getattr(ev, col),
                                          getattr(want, col))


# ---- tests/test_dataset_layouts.py on the port ----------------------------

def _sample_batch():
    rng = np.random.default_rng(0)
    n = 500
    return tio.EventBatch(
        x=rng.integers(0, 240, n).astype(np.int32),
        y=rng.integers(0, 180, n).astype(np.int32),
        t=np.sort(rng.integers(1000, 2_000_000, n)).astype(np.uint32),
        pol=rng.integers(0, 2, n).astype(np.int32),
    )


def test_davis_layout_roundtrip(jax_mods, tmp_path):
    """test_dataset_layouts.py:29; the file equals farms_tpu's."""
    _, jio, _, _ = jax_mods
    ev = _sample_batch()
    path = tio.write_events_davis_txt(ev, str(tmp_path / "davis.txt"))
    jpath = jio.write_events_davis_txt(ev, str(tmp_path / "jdavis.txt"))
    assert open(path).read() == open(jpath).read()
    got = tio.load_events_txt(path, layout="txyp", time_unit="s")
    for col in ("x", "y", "t", "pol"):
        np.testing.assert_array_equal(getattr(got, col), getattr(ev, col))


def test_davis_layout_would_misparse_as_reference(tmp_path):
    ev = _sample_batch()
    path = tio.write_events_davis_txt(ev, str(tmp_path / "davis.txt"))
    assert not np.array_equal(tio.load_events_txt(path).x, ev.x)


def test_converter_to_reference_layout(jax_mods, tmp_path):
    _, jio, _, _ = jax_mods
    ev = _sample_batch()
    src = tio.write_events_davis_txt(ev, str(tmp_path / "davis.txt"))
    dst = tio.convert_events_txt(src, str(tmp_path / "converted.txt"),
                                 layout="txyp", time_unit="s")
    jdst = jio.convert_events_txt(src, str(tmp_path / "jconverted.txt"),
                                  layout="txyp", time_unit="s")
    assert open(dst).read() == open(jdst).read()
    got = tio.load_events_txt(dst)       # the native parser reads it
    np.testing.assert_array_equal(got.x, ev.x)
    np.testing.assert_array_equal(got.t, ev.t)


def test_negative_polarity_clamped_txyp(tmp_path):
    path = str(tmp_path / "neg.txt")
    with open(path, "w") as fh:
        fh.write("0.001000000 3 4 -1\n0.002000000 5 6 1\n")
    got = tio.load_events_txt(path, layout="txyp", time_unit="s")
    np.testing.assert_array_equal(got.pol, [0, 1])
    np.testing.assert_array_equal(got.t, [1000, 2000])


def test_unknown_layout_rejected():
    with pytest.raises(ValueError):
        tio.load_events_txt("x.txt", layout="ptyx")
    with pytest.raises(ValueError):
        tio.load_events_txt("x.txt", time_unit="ms")


def test_rotating_shapes_regime():
    """test_dataset_layouts.py:85 on the port's engine: the reported flow
    of the rotating scene is radial (the reference's 90-degree atan2
    convention) with |v| about omega * r."""
    ev = tio.synthetic_rotating_shapes(duration_us=150_000,
                                       omega_rad_s=2 * np.pi, seed=1)
    assert len(ev) > 3000
    assert ev.x.min() >= 0 and ev.x.max() < 240
    assert ev.y.min() >= 0 and ev.y.max() < 180
    cfg = TConfig(width=240, height=180, chunk_size=1024, steps_per_scan=4)
    out = teng.FlowEngine(cfg, device="cpu").process(ev[:8192])
    valid = out.r_local > 0
    assert valid.sum() > 100
    rx = out.x[valid] - 120.0
    ry = out.y[valid] - 90.0
    r = np.hypot(rx, ry)
    vx = out.r_true[valid] * np.cos(out.theta_true[valid])
    vy = out.r_true[valid] * np.sin(out.theta_true[valid])
    speed = np.hypot(vx, vy)
    ok = (r > 10) & (speed > 0)
    radial = np.abs(vx * rx + vy * ry) / np.maximum(r * speed, 1e-9)
    assert np.median(radial[ok]) > 0.7
    assert 0.7 < np.median(speed[ok] / (2 * np.pi * r[ok])) < 1.5

"""The port's engine vs the float64 oracle and vs the JAX engine.

- chunk_size=1 reproduces the event-serial reference: asserted exactly as
  tests/test_golden.py asserts it for `farms_tpu`, on the same streams.
- At a chunked operating point (f16 wire, 2 sub-phases) the port and the
  JAX engine agree lane for lane up to fp drift (FMA contraction and
  summation order differ between XLA and PyTorch), from the same stream
  and from a `farms_tpu` checkpoint.
- The host packers and the wire decoder are NumPy and bitwise equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.pipeline import checkpoint as tckpt
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.pipeline.oracle import run_oracle
from farms_tpu_torch.pipeline.ties import scale_ties

torch.set_num_threads(1)


def _angular_err_deg(a, b, mask):
    d = np.angle(np.exp(1j * (a.theta_true[mask] - b.theta_true[mask])))
    return np.degrees(np.abs(d))


def _assert_matches_oracle(ref, got):
    """tests/test_golden.py::test_serial_mode_matches_oracle's asserts."""
    ref_valid = ref.r_local > 0
    got_valid = got.r_local > 0
    assert ref_valid.sum() > 100   # the fixture produces real flow
    np.testing.assert_array_equal(ref_valid, got_valid)
    np.testing.assert_array_equal(ref.scale, got.scale)
    np.testing.assert_array_equal(ref.t, got.t)
    m = ref_valid
    np.testing.assert_allclose(got.r_local[m], ref.r_local[m], rtol=1e-4)
    np.testing.assert_allclose(got.r_true[m], ref.r_true[m], rtol=1e-4)
    assert _angular_err_deg(ref, got, m).max() < 0.01


def _golden_bar():
    # tests/test_golden.py:30-35
    return tio.synthetic_translating_bar(
        width=64, height=64, bar_len=20, duration_us=30000,
        speed_px_per_sec=1000, jitter_us=20, seed=1)[:600]


def test_serial_mode_matches_oracle():
    ev = _golden_bar()
    cfg = TConfig(width=64, height=64, chunk_size=1, steps_per_scan=32)
    ref = run_oracle(ev, TConfig(width=64, height=64))
    got = teng.FlowEngine(cfg, device="cpu").process(ev)
    _assert_matches_oracle(ref, got)


def test_serial_mode_matches_oracle_past_2e31():
    """tests/test_golden.py:122: normalized stamps cross 2^31, so stamp1
    values wrap negative as int32; every stamp comparison must stay in the
    unsigned domain."""
    bar = tio.synthetic_translating_bar(
        width=64, height=64, bar_len=20, duration_us=30000,
        speed_px_per_sec=1000, jitter_us=20, seed=3)[:500]
    shift = np.uint32(2**31 - 15000)
    ev = tio.EventBatch(
        x=np.concatenate([[5], bar.x]).astype(np.int32),
        y=np.concatenate([[5], bar.y]).astype(np.int32),
        t=np.concatenate([[np.uint32(5)],
                          bar.t + shift + np.uint32(5)]).astype(np.uint32),
        pol=np.concatenate([[1], bar.pol]).astype(np.int32),
    )
    assert int(ev.t[-1] - ev.t[0]) > 2**31
    cfg = TConfig(width=64, height=64, chunk_size=1, steps_per_scan=32)
    ref = run_oracle(ev, TConfig(width=64, height=64))
    got = teng.FlowEngine(cfg, device="cpu").process(ev)
    _assert_matches_oracle(ref, got)


# ---------------------------------------------------------------------------
# port vs JAX engine at a chunked operating point
# ---------------------------------------------------------------------------

_OP = dict(width=64, height=64, chunk_size=1024, sub_phases=2, wire="f16",
           steps_per_scan=2)


def _streams():
    bar = tio.synthetic_translating_bar(
        width=64, height=64, bar_len=40, duration_us=40000,
        speed_px_per_sec=1000, jitter_us=20, seed=5)
    rnd = tio.synthetic_random_events(6000, width=64, height=64,
                                      rate_hz=1e6, seed=9)
    return {"bar": bar, "random": rnd}


def _multi_pass_bar(passes=3, w=64):
    """tests/test_center_correction.py::_multi_pass_bar: several bar
    sweeps over the same pixels plus background noise, a collision-rich
    stream (rank-2 lanes need pixels that fire twice in a phase)."""
    parts = []
    t_off = 0
    for i in range(passes):
        b = tio.synthetic_translating_bar(width=w, height=w, bar_len=20,
                                          speed_px_per_sec=4000.0,
                                          duration_us=60000, jitter_us=23,
                                          seed=i)
        parts.append((b.x, b.y, b.t.astype(np.int64) + t_off))
        t_off += int(b.t[-1]) + 100
    rng = np.random.default_rng(7)
    n_bg = sum(len(p[0]) for p in parts) // 2
    parts.append((rng.integers(0, w, n_bg).astype(np.int32),
                  rng.integers(0, w, n_bg).astype(np.int32),
                  np.sort(rng.integers(0, t_off, n_bg)).astype(np.int64)))
    x = np.concatenate([p[0] for p in parts])
    y = np.concatenate([p[1] for p in parts])
    t = np.concatenate([p[2] for p in parts])
    order = np.argsort(t, kind="stable")
    return tio.EventBatch(x[order].astype(np.int32),
                          y[order].astype(np.int32),
                          t[order].astype(np.uint32),
                          np.ones(len(x), np.int32))


def _process_recording_aperture(eng, ev, monkeypatch):
    """eng.process(ev), keeping the flow_len surface each aperture pass
    read, in pass order (micro-step, then sub-phase)."""
    passes = []
    aperture = teng.kernels.aperture

    def recording(flow_len, flow_vx, flow_vy, cfg):
        passes.append(flow_len.clone())
        return aperture(flow_len, flow_vx, flow_vy, cfg)

    with monkeypatch.context() as mp:
        mp.setattr(teng.kernels, "aperture", recording)
        out = eng.process(ev)
    return out, passes


def _assert_engines_agree(a, b, passes, cfg, what, min_agree=0.999):
    """a: JAX engine output, b: the port's, on the same lanes; `passes`
    the port's aperture inputs (_process_recording_aperture).

    Scale ids count as tied where the two engines chose different scales
    whose windows have equal mean lengths (scale_ties): an isolated flow
    pixel has the same mean at every scale whose window holds only it,
    and the f32 integral of `farms_tpu` picks among such scales by
    rounding noise, where the port's float64 integral picks the first, as
    the float64 reference does.
    """
    va, vb = a.r_local > 0, b.r_local > 0
    agree = (va == vb).mean()
    both = va & vb
    same = both & (a.scale == b.scale)
    tied = both & ~same & scale_ties(a, b, passes, cfg)
    n_both = max(1, both.sum())
    msg = (f"{what}: valid agreement {agree:.5f} over {va.size} events "
           f"({va.sum()} valid); scale equal on {same.sum() / n_both:.5f} "
           f"of {both.sum()} commonly valid lanes, "
           f"{tied.sum() / n_both:.5f} tied")
    assert agree >= min_agree, msg
    assert (same | tied)[both].mean() >= 0.995, msg
    assert both.sum() > 40, msg
    # components within the f16 quantization of the flow's magnitude
    # (vx is the small cos component of a near-axis flow)
    for col in ("vx", "vy"):
        err = np.abs(getattr(b, col) - getattr(a, col))[both]
        bound = 2e-3 * a.r_local[both] + 1e-6
        assert (err <= bound).all(), f"{what} {col}: {err.max()}"
    np.testing.assert_allclose(b.r_local[both], a.r_local[both], rtol=2e-3,
                               atol=1e-6, err_msg=f"{what} r_local")
    s = same
    np.testing.assert_allclose(b.r_true[s], a.r_true[s], rtol=2e-3,
                               atol=1e-6, err_msg=f"{what} r_true")
    np.testing.assert_allclose(b.theta_true[s], a.theta_true[s], atol=2e-3,
                               err_msg=f"{what} theta_true")
    np.testing.assert_array_equal(a.t, b.t)
    print(msg)


@pytest.fixture(scope="module")
def jax_engine_mod():
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig
    from farms_tpu.pipeline import checkpoint, engine
    return FlowConfig, engine, checkpoint


@pytest.mark.parametrize("stream", ["bar", "random"])
def test_port_matches_jax_engine(jax_engine_mod, stream, monkeypatch):
    JConfig, jeng, _ = jax_engine_mod
    ev = _streams()[stream]
    cfg = TConfig(**_OP)
    want = jeng.FlowEngine(JConfig(**_OP)).process(ev)
    got, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), ev, monkeypatch)
    _assert_engines_agree(want, got, passes, cfg, stream)


def test_port_resumes_jax_checkpoint(jax_engine_mod, tmp_path, monkeypatch):
    """A mid-stream `farms_tpu` checkpoint loaded through the port's
    load_engine continues like the JAX engine does."""
    JConfig, jeng, jckpt = jax_engine_mod
    ev = _streams()["random"]
    cut = 3072
    cfg = TConfig(**_OP)
    je = jeng.FlowEngine(JConfig(**_OP))
    je.process(ev[:cut])
    path = jckpt.save_engine(je, str(tmp_path / "jax_state"))
    want = je.process(ev[cut:])
    port = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"), path)
    assert port.state.step == int(np.load(path)["step"]) > 0
    got, passes = _process_recording_aperture(port, ev[cut:], monkeypatch)
    _assert_engines_agree(want, got, passes, cfg, "resumed")


def test_checkpoint_roundtrip_equals_oneshot(tmp_path):
    ev = _streams()["bar"]
    cfg = TConfig(**_OP)
    one = teng.FlowEngine(cfg, device="cpu").process(ev)
    eng = teng.FlowEngine(cfg, device="cpu")
    first = eng.process(ev[:512])
    path = tckpt.save_engine(eng, str(tmp_path / "port_state"))
    second = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"),
                               path).process(ev[512:])
    for col in ("vx", "r_true", "scale", "t"):
        np.testing.assert_array_equal(
            getattr(one, col),
            np.concatenate([getattr(first, col), getattr(second, col)]),
            err_msg=col)
    other = teng.FlowEngine(TConfig(width=32, height=32), device="cpu")
    with pytest.raises(ValueError):
        tckpt.load_engine(other, path)


# ---------------------------------------------------------------------------
# host packers and wire decode: bitwise equal to farms_tpu's
# ---------------------------------------------------------------------------

def _equal_stamp_stream(n=6000, seed=3, phase_len=256):
    """tests/test_written.py::_equal_stamp_stream: equal-stamp rewrite pairs
    planted at phase boundaries (the escapes of the derived `written`)."""
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=20,
                                       speed_px_per_sec=4000.0,
                                       duration_us=40000, jitter_us=17,
                                       seed=seed)
    x, y, t, pol = (ev.x[:n].copy(), ev.y[:n].copy(), ev.t[:n].copy(),
                    ev.pol[:n].copy())
    n = len(x)
    for i, b in enumerate(range(phase_len, n - 1, phase_len)):
        x[b - 1] = x[b] = 60
        y[b - 1] = y[b] = (i * 3) % 64
        t[b] = t[b - 1]
    return tio.EventBatch(x, y, t, pol)


def _overflow_stream():
    """tests/test_written.py:89: more equal-stamp rewrites in one phase
    than escape slots (that call takes the epoch path)."""
    n = 2048
    E2 = teng._W_ESCAPES + 8
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, n).astype(np.int32)
    y = rng.integers(0, 4, n).astype(np.int32)
    t = np.sort(rng.integers(0, 40000, n)).astype(np.uint32)
    x[256 - E2:256] = x[256:256 + E2] = 32
    y[256 - E2:256] = np.arange(E2)
    y[256:256 + E2] = np.arange(E2)
    t[256 - E2:256 + E2] = t[256 - E2]
    return tio.EventBatch(x, y, t, np.ones(n, np.int32))


def _gap_streams():
    """tests/test_wire.py:160: a gap past the delta field (escape-coded)
    and more oversized gaps per step than escape slots (fallback)."""
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=24,
                                       duration_us=40000, jitter_us=30,
                                       seed=1)
    ev2 = ev[:]
    ev2.t = ev.t.copy()
    ev2.t[len(ev2) // 2:] += np.uint32(1 << 19)
    ev3 = ev[:]
    stride = max(1, 256 // (teng._C2_ESCAPES + 4))
    bump = np.zeros(len(ev3), np.uint32)
    bump[::stride] = 1 << 19
    ev3.t = ev.t + np.cumsum(bump).astype(np.uint32)
    return ev, ev2, ev3


def _pack_cases():
    ev, ev2, ev3 = _gap_streams()
    return [
        ("bar", dict(width=64, height=64, chunk_size=256, steps_per_scan=2),
         ev),
        ("escape", dict(width=64, height=64, chunk_size=256,
                        steps_per_scan=2), ev2),
        ("fallback", dict(width=64, height=64, chunk_size=256,
                          steps_per_scan=2), ev3),
        ("equal_stamp", dict(width=64, height=64, chunk_size=512,
                             sub_phases=2, wire="f32"),
         _equal_stamp_stream()),
        ("wesc_overflow", dict(width=64, height=64, chunk_size=256,
                               wire="f32"), _overflow_stream()),
        ("huge_sensor", dict(width=4096, height=4096, chunk_size=256), ev),
    ]


@pytest.mark.parametrize("name", [c[0] for c in _pack_cases()])
def test_packers_bitwise_equal(jax_engine_mod, name):
    JConfig, jeng, _ = jax_engine_mod
    _, kw, ev = next(c for c in _pack_cases() if c[0] == name)
    je = jeng.FlowEngine(JConfig(**kw))
    te = teng.FlowEngine(TConfig(**kw), device="cpu")
    jp, jn = je.pack(ev, compact=True)
    tp, tn = te.pack(ev)
    assert jn == tn
    np.testing.assert_array_equal(tp, jp, err_msg="pack")
    jp, jaux, _ = je.pack2(ev)
    tp, taux, _ = te.pack2(ev)
    np.testing.assert_array_equal(tp, jp, err_msg="pack2")
    assert (jaux is None) == (taux is None)
    if jaux is not None:
        for a, b in zip(jaux, taux):
            np.testing.assert_array_equal(b, a)
    jw, jok = je.pack_wesc(ev)
    tw, tok = te.pack_wesc(ev)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(te._last_stamp, je._last_stamp)
    expect = {"escape": "escaped", "fallback": "fallback",
              "huge_sensor": "fallback", "wesc_overflow": "overflow",
              "equal_stamp": "wesc"}.get(name)
    if expect == "escaped":
        assert taux is not None and (taux[1][:, :, 0, :] < 256).any()
    elif expect == "fallback":
        assert taux is None
    elif expect == "overflow":
        assert not tok.all()
    elif expect == "wesc":
        assert tok.all() and (tw < 256).sum() > 0


@pytest.mark.parametrize("name", ["bar", "escape", "fallback",
                                  "equal_stamp", "wesc_overflow"])
def test_upload_layouts_and_written_paths_agree(name):
    """compact2 (with and without escapes), the 8-byte compact fallback,
    and the epoch-scatter fallback of the derived `written` all give the
    same outputs (tests/test_wire.py:160, tests/test_written.py:64)."""
    _, kw, ev = next(c for c in _pack_cases() if c[0] == name)
    cfg = TConfig(**kw)
    base = teng.FlowEngine(cfg, device="cpu").process(ev)

    class Compact(teng.FlowEngine):
        def pack2(self, ev, steps_per_call=None):
            packed, n = self.pack(ev, steps_per_call)
            return packed, None, n

    class Epoch(teng.FlowEngine):
        def pack_wesc(self, ev, steps_per_call=None):
            wesc, ok = super().pack_wesc(ev, steps_per_call)
            ok[:] = False
            return wesc, ok

    for cls in (Compact, Epoch):
        other = cls(cfg, device="cpu").process(ev)
        for col in ("vx", "vy", "r_true", "theta_true", "r_local", "scale"):
            np.testing.assert_array_equal(getattr(other, col),
                                          getattr(base, col),
                                          err_msg=f"{cls.__name__} {col}")
    assert (base.r_local > 0).sum() > 20


@pytest.mark.parametrize("wire", ["f16", "f32"])
def test_decode_wire_columns_equal(jax_engine_mod, wire):
    JConfig, jeng, _ = jax_engine_mod
    rng = np.random.default_rng(7)
    k = 4096
    C = 2 if wire == "f16" else 4
    if wire == "f16":
        halves = rng.standard_normal((C, 2, k)).astype(np.float16)
        halves[:, :, ::97] = np.float16(np.nan)
        main = halves.transpose(0, 2, 1).copy().view(np.int32)[..., 0]
    else:
        main = rng.standard_normal((C, k)).astype(np.float32).view(np.int32)
    aux = rng.integers(0, 256, k).astype(np.uint8)
    want = jeng.decode_wire_columns(main, aux, JConfig(wire=wire))
    got = teng.decode_wire_columns(main, aux, TConfig(wire=wire))
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_f16_pair_saturates_and_keeps_nan():
    """tests/test_wire.py:129: NaN propagates, out-of-range saturates."""
    vx = torch.tensor([1.5, np.nan, 1e9, -1e9], dtype=torch.float32)
    vy = torch.tensor([-2.5, 0.0, 0.0, 0.0], dtype=torch.float32)
    z = torch.zeros(4)
    main, aux = teng.wire_pack(vx, vy, z, z, z, TConfig(wire="f16"))
    p0 = main[0].numpy().view(np.uint32)
    got_vx = (p0 & 0xFFFF).astype(np.uint16).view(np.float16)
    got_vy = (p0 >> 16).astype(np.uint16).view(np.float16)
    assert got_vx[0] == np.float16(1.5) and got_vy[0] == np.float16(-2.5)
    assert np.isnan(got_vx[1])
    assert got_vx[2] == np.float16(65504.0)
    assert got_vx[3] == np.float16(-65504.0)


def test_compact2_decode_wraps_stamps():
    """The in-step cumsum of stamp deltas wraps mod 2^32 (int64 sums, not
    int32 overflow), escapes re-add their exact deltas, and sentinel lanes
    decode to the spare pixel W*H."""
    cfg = TConfig(width=64, height=64, chunk_size=8, steps_per_scan=1)
    eng = teng.FlowEngine(cfg, device="cpu")
    t = np.array([0, 10, 2**31 - 3, 2**31 + 5, 2**32 - 2, 2**32 - 1, 3, 9],
                 dtype=np.int64)
    t0 = np.uint32(100)
    ev = tio.EventBatch(x=np.arange(6, dtype=np.int32),
                        y=np.arange(6, dtype=np.int32),
                        t=((t[:6] + int(t0)) % 2**32).astype(np.uint32),
                        pol=np.ones(6, np.int32))
    packed, aux, n = eng.pack2(ev)
    assert aux is not None and n == 6
    batch = {"ev": torch.from_numpy(packed[0, 0]),
             "base": torch.from_numpy(aux[0][0])[0],
             "esc": torch.from_numpy(aux[1][0, 0])}
    x, y, tt, win = teng._decode_batch(batch, cfg)
    np.testing.assert_array_equal(
        tt[:6].numpy().view(np.uint32), t[:6].astype(np.uint32))
    np.testing.assert_array_equal(x[:6].numpy(), np.arange(6))
    assert win[:6].all() and not win[6:].any()
    assert (x[6:] * 64 + y[6:] == 64 * 64).all()


def test_call_grouping_does_not_change_outputs():
    """steps_per_scan only groups micro-steps into calls: outputs are the
    same for any grouping."""
    ev = _streams()["random"]
    cfg = TConfig(**_OP)
    a = teng.FlowEngine(cfg, device="cpu").process(ev)
    b = teng.FlowEngine(dataclasses.replace(cfg, steps_per_scan=1),
                        device="cpu").process(ev)
    for col in ("vx", "r_true", "scale"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))

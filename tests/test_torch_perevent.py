"""The port's per-event formulation (use_dense=False) against `farms_tpu`.

- `local_flow_batch` and `aperture_batch` (farms_tpu_torch/ops) against
  their JAX counterparts on seeded random surfaces, with stamps past 2^31,
  border and corner events, k = 3, 5 and 7, and the y-clamp quirk.
- The cases of tests/test_plane_fit.py and tests/test_aperture.py on the
  port: the plane fit against numpy's lstsq and its rejections, the
  pooling against a naive float64 rescan.
- The per-event engine against JAX's at chunk 256, P = 2, on both wires
  (outputs and the state after process), against the port's dense engine
  on the winner lanes, and at chunk_size=1 against the float64 oracle as
  the `dense=False` cases of tests/test_golden.py and
  tests/test_configs_sweep.py assert it.

Tolerances against JAX: XLA on the CPU contracts a product into the sum
that follows it (fused multiply-add) in the normal-equation sums and the
solve; the port keeps the dense path's separate multiply and add (so the
card equals the CPU and a winner lane equals the dense path's). So the
float outputs of a fit differ by a few ulps, more on ill-conditioned fits:
length and angle within 4 ulps, each component within 4 ulps of the
length, on the random surfaces; integers and accept flags are equal. The
aperture stage's integral is float64 in the port and f32 in `farms_tpu`,
so scale ids are compared outside float64 near-ties (pipeline/ties.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.ops import aperture as tap
from farms_tpu_torch.ops import local_flow as tlf
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.pipeline.oracle import run_oracle
from farms_tpu_torch.pipeline.ties import scale_means_f64
from test_torch_engine import (_angular_err_deg, _assert_engines_agree,
                               _assert_matches_oracle, _golden_bar,
                               _multi_pass_bar, _streams)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from farms_tpu.config import FlowConfig
    from farms_tpu.ops import aperture, local_flow
    from farms_tpu.pipeline import engine
    return jnp, FlowConfig, local_flow, aperture, engine


def _u32(v):
    """int64 stamps as stamp1 uint32 bit patterns in int32."""
    return (np.asarray(v) % 2**32).astype(np.uint32).view(np.int32)


def _plane_case(W, H, seed, shift, m=400):
    """Stamp1 surfaces of a noisy plane (85 % touched, stamps offset by
    `shift`, so past 2^31 or 2^32 they wrap) and m events at random pixels,
    the four corners and border pixels among them, each a little after
    the plane at its pixel; t_post holds the events' stamps."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(-60, 60, 2)
    plane = (20000 + a * np.arange(W)[:, None] + b * np.arange(H)[None, :]
             + rng.integers(-30, 30, (W, H))).astype(np.int64)
    pre = np.where(rng.random((W, H)) < 0.85, plane + shift + 1, 0)
    x = rng.integers(0, W, m)
    y = rng.integers(0, H, m)
    x[:8] = [0, 0, W - 1, W - 1, 0, W - 1, 1, W - 2]
    y[:8] = [0, H - 1, 0, H - 1, H // 2, H // 2, 0, H - 1]
    t_ev = plane[x, y] + rng.integers(1, 200, m) + shift + 1
    post = pre.copy()
    post[x, y] = t_ev
    return (_u32(pre), _u32(post), x.astype(np.int32), y.astype(np.int32),
            _u32(t_ev))


def _spacing(a):
    return np.spacing(np.abs(np.asarray(a, np.float32)))


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("shift", [0, 2**31 - 10000, 2**32 - 15000])
def test_local_flow_batch_matches_jax(jax_mods, k, shift):
    jnp, JConfig, jlf, _, _ = jax_mods
    W = H = 40
    arrays = _plane_case(W, H, seed=k + shift % 7, shift=shift)
    want = [np.asarray(o) for o in jlf.local_flow_batch(
        *(jnp.asarray(a) for a in arrays),
        JConfig(width=W, height=H, filter_size=k))]
    got = [o.numpy() for o in tlf.local_flow_batch(
        *(torch.from_numpy(a) for a in arrays),
        TConfig(width=W, height=H, filter_size=k))]
    gate = want[2]
    np.testing.assert_array_equal(got[2], gate)
    assert gate.sum() > 20 and gate[:8].any() and not gate.all()
    # rejected fits report exact zeros on both sides
    for i in (0, 1):
        assert (got[i][~gate] == 0).all() and (want[i][~gate] == 0).all()
    length = want[3][gate]
    for i, name in ((3, "length"), (4, "theta")):
        err = np.abs(got[i][gate] - want[i][gate])
        assert (err <= 4 * _spacing(want[i][gate])).all(), (name, err.max())
    for i, name in ((0, "vx"), (1, "vy")):
        err = np.abs(got[i][gate] - want[i][gate])
        assert (err <= 4 * _spacing(length)).all(), (name, err.max())


def _random_flow(W, H, density, seed):
    # tests/test_aperture.py::_random_surfaces
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(W, H)) < density
    ln = np.where(mask, rng.uniform(0.5, 5.0, (W, H)), 0.0).astype(np.float32)
    vx = np.where(mask, rng.normal(size=(W, H)), 0.0).astype(np.float32)
    vy = np.where(mask, rng.normal(size=(W, H)), 0.0).astype(np.float32)
    return ln, vx, vy


def _naive_pool(flow_len, flow_vx, flow_vy, x, y, cfg):
    """tests/test_aperture.py::_naive_pool: the reference's rescan of
    every scale's window, in float64."""
    W, H = cfg.width, cfg.height
    y_clamp = (W if cfg.replicate_y_clamp_quirk else H) - 1
    best_val, best = 0.0, None
    for s in cfg.scales:
        x0, x1 = max(0, x - s), min(x + s, W - 1)
        y0, y1 = max(0, y - s), min(y + s, y_clamp)
        win = (slice(x0, x1 + 1), slice(y0, y1 + 1))
        g = flow_len[win] > 0
        n = int(g.sum())
        if n == 0:
            continue
        mean_len = flow_len[win][g].astype(np.float64).sum() / n
        if mean_len > best_val:
            best_val = mean_len
            best = (flow_vx[win][g].astype(np.float64).sum() / n,
                    flow_vy[win][g].astype(np.float64).sum() / n, s)
    if best is None:
        return flow_vx[x, y], flow_vy[x, y], 0
    return best


def _port_pool(ln, vx, vy, xs, ys, cfg):
    fields = [torch.from_numpy(a) for a in (ln, vx, vy)]
    out = tap.aperture_batch(tap.build_integral(*fields), fields[1],
                             fields[2], torch.from_numpy(xs),
                             torch.from_numpy(ys), cfg)
    return [o.numpy() for o in out]


# (W, H, density, seed, y-clamp quirk): tests/test_aperture.py's pooling
# and quirk geometries, and the quirk on a sensor taller than wide
_POOLS = [(80, 80, 0.1, 11, False), (48, 32, 0.2, 2, False),
          (48, 32, 0.2, 2, True), (32, 48, 0.2, 3, True)]


@pytest.mark.parametrize("W, H, density, seed, quirk", _POOLS)
def test_aperture_pooling_matches_naive(W, H, density, seed, quirk):
    """tests/test_aperture.py:46 and :99 (pooling, the y-clamp quirk):
    every lane's scale and pooled flow equal a float64 rescan's; border
    and corner lanes included."""
    cfg = TConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
    ln, vx, vy = _random_flow(W, H, density, seed)
    rng = np.random.default_rng(5)
    xs = np.concatenate([[0, W - 1, 0, W - 1, W // 2],
                         rng.integers(0, W, 60)]).astype(np.int32)
    ys = np.concatenate([[0, 0, H - 1, H - 1, H - 1],
                         rng.integers(0, H, 60)]).astype(np.int32)
    tvx, tvy, sc = _port_pool(ln, vx, vy, xs, ys, cfg)
    for i in range(len(xs)):
        evx, evy, es = _naive_pool(ln, vx, vy, int(xs[i]), int(ys[i]), cfg)
        assert sc[i] == es, f"lane {i}: scale {sc[i]} != {es}"
        np.testing.assert_allclose(tvx[i], evx, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tvy[i], evy, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["uniform_tie", "empty_surface"])
def test_aperture_tie_and_fallback(case):
    """tests/test_aperture.py:67 (equal means at every scale: the smallest
    scale wins) and :86 (nothing pooled: the center flow at scale 0)."""
    if case == "uniform_tie":
        W = H = 64
        ln = np.full((W, H), 2.0, np.float32)
        vx = np.full((W, H), 1.5, np.float32)
        vy = np.full((W, H), -1.0, np.float32)
        at, want = 32, (1.5, -1.0, 0)
    else:
        W = H = 32
        ln, vx, vy = (np.zeros((W, H), np.float32) for _ in range(3))
        at, want = 10, (0.0, 0.0, 0)
    tvx, tvy, sc = _port_pool(ln, vx, vy, np.array([at], np.int32),
                              np.array([at], np.int32),
                              TConfig(width=W, height=H))
    assert (float(tvx[0]), float(tvy[0]), int(sc[0])) == want


@pytest.mark.parametrize("W, H, density, seed, quirk", _POOLS)
def test_aperture_batch_matches_jax(jax_mods, W, H, density, seed, quirk):
    """Scale ids equal JAX's outside float64 near-ties of the per-scale
    mean lengths; pooled flow within JAX's f32-integral rounding where the
    scales agree."""
    jnp, JConfig, _, jap, _ = jax_mods
    ln, vx, vy = _random_flow(W, H, density, seed)
    rng = np.random.default_rng(seed + 1)
    xs = rng.integers(0, W, 300).astype(np.int32)
    ys = rng.integers(0, H, 300).astype(np.int32)
    jcfg = JConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
    want = [np.asarray(o) for o in jap.aperture_batch(
        jap.build_integral(jnp.asarray(ln), jnp.asarray(vx), jnp.asarray(vy)),
        jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(xs), jnp.asarray(ys),
        jcfg)]
    cfg = TConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
    got = _port_pool(ln, vx, vy, xs, ys, cfg)
    differ = got[2] != want[2]
    if differ.any():
        means = scale_means_f64(torch.from_numpy(ln), xs[differ], ys[differ],
                                cfg)
        cols = np.arange(differ.sum())
        mg = means[got[2][differ] // cfg.window_jump, cols]
        mw = means[want[2][differ] // cfg.window_jump, cols]
        assert (np.abs(mg - mw) <= 1e-5 * (np.abs(mg) + 1e-6)).all()
    same = ~differ
    assert same.mean() > 0.9 and (got[2][same] > 0).sum() > 30
    for i in (0, 1):
        np.testing.assert_allclose(got[i][same], want[i][same], rtol=2e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# tests/test_plane_fit.py on the port
# ---------------------------------------------------------------------------

def _run_single(t_surf, touched, x, y, t_ev, cfg):
    """local_flow_batch for one event on stamp1-encoded surfaces."""
    t1 = np.where(touched, t_surf.astype(np.int64) + 1, 0).astype(np.int32)
    s = torch.from_numpy(t1)
    out = tlf.local_flow_batch(s, s, torch.tensor([x]), torch.tensor([y]),
                               torch.tensor([t_ev + 1], dtype=torch.int32),
                               cfg)
    return [o.numpy()[0] for o in out]


def _plane_surface(W, H, a_us, b_us, t0_us):
    xs = np.arange(W)[:, None]
    ys = np.arange(H)[None, :]
    return (t0_us + a_us * xs + b_us * ys).astype(np.int32)


def test_perfect_plane_recovers_velocity():
    """tests/test_plane_fit.py:28: gradient (a, b) in s/px gives speed
    1/|grad| along atan2(a, b) (vFlow.cpp:1373-1377)."""
    W = H = 32
    cfg = TConfig(width=W, height=H, min_evts_on_plane=5)
    surf = _plane_surface(W, H, 40.0, 25.0, 1000)
    vx, vy, valid, _, _ = _run_single(surf, np.ones((W, H), bool), 16, 16,
                                      int(surf[16, 16]), cfg)
    assert valid
    grad = np.array([40.0, 25.0]) * 1e-6
    speed = 1.0 / np.linalg.norm(grad)
    ang = np.arctan2(grad[0], grad[1])
    np.testing.assert_allclose(vx, speed * np.cos(ang), rtol=1e-4)
    np.testing.assert_allclose(vy, speed * np.sin(ang), rtol=1e-4)


def test_plane_fit_matches_numpy_lstsq():
    """tests/test_plane_fit.py:47: the adjugate solve of the winning
    window equals a least-squares fit of it, on noisy planes."""
    rng = np.random.default_rng(7)
    W = H = 32
    cfg = TConfig(width=W, height=H, min_evts_on_plane=0)
    f = cfg.f_rad
    f2 = 2 * f
    for _ in range(20):
        a_us, b_us = rng.uniform(5, 200, 2)
        surf = _plane_surface(W, H, a_us, b_us, 500)
        surf = (surf + rng.integers(-3, 4, size=surf.shape)).astype(np.int32)
        x = int(rng.integers(5, W - 5))
        y = int(rng.integers(5, H - 5))
        # every support cell in the past: no wraparound penalties
        t_ev = int(surf[x - f2:x + f2 + 1, y - f2:y + f2 + 1].max()) + 50
        surf[x, y] = t_ev
        vx, vy, _, _, _ = _run_single(surf, np.ones((W, H), bool), x, y,
                                      t_ev, cfg)
        best, best_score = None, np.inf
        for di in (-f, 0, f):
            for dj in (-f, 0, f):
                win = surf[x + di - f:x + di + f + 1,
                           y + dj - f:y + dj + f + 1]
                score = float(np.mean(t_ev - win.astype(np.float64)))
                if score < best_score:
                    best_score, best = score, (di, dj)
        di, dj = best
        win = surf[x + di - f:x + di + f + 1, y + dj - f:y + dj + f + 1]
        gx, gy = np.meshgrid(np.arange(x + di - f, x + di + f + 1),
                             np.arange(y + dj - f, y + dj + f + 1),
                             indexing="ij")
        A = np.stack([gx.ravel(), gy.ravel(), np.ones(win.size)], 1)
        abc, *_ = np.linalg.lstsq(A, win.ravel() * 1e-6, rcond=None)
        speed = 1.0 / np.hypot(abc[0], abc[1])
        ang = np.arctan2(abc[0], abc[1])
        np.testing.assert_allclose(vx, speed * np.cos(ang), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(vy, speed * np.sin(ang), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("case", ["degenerate_det", "noise_inliers"])
def test_plane_fit_rejections(case):
    """tests/test_plane_fit.py:94 (untouched support: every row at (0, 0),
    det < 1) and :105 (random stamps: too few inliers)."""
    W = H = 16
    if case == "degenerate_det":
        cfg = TConfig(width=W, height=H)
        surf = np.zeros((W, H), np.int32)
        touched = np.zeros((W, H), bool)
        t_ev = 100
    else:
        rng = np.random.default_rng(3)
        cfg = TConfig(width=W, height=H, min_evts_on_plane=9)
        surf = rng.integers(1, 10**6, size=(W, H)).astype(np.int32)
        touched = np.ones((W, H), bool)
        t_ev = 10**6 + 1
        surf[8, 8] = t_ev
    vx, vy, valid, _, _ = _run_single(surf, touched, 8, 8, t_ev, cfg)
    assert not valid and vx == 0 and vy == 0


@pytest.mark.parametrize("case", ["border", "corner"])
def test_edge_event_uses_inward_candidate(case):
    """tests/test_plane_fit.py:118 and :130: an event on the border (x = 0)
    or in the corner has only inward candidates with full windows
    (vFlow.cpp:889), and a clean plane still gives a valid fit there."""
    W = H = 32
    cfg = TConfig(width=W, height=H, min_evts_on_plane=3)
    if case == "border":
        surf = _plane_surface(W, H, 40.0, 25.0, 1000)
        x, y = 0, 16
    else:
        # the wavefront reaches the corner last: its event is the newest
        surf = _plane_surface(W, H, -40.0, -25.0, 1000 + 65 * 31)
        x, y = 0, 0
    _, _, valid, _, _ = _run_single(surf, np.ones((W, H), bool), x, y,
                                    int(surf[x, y]), cfg)
    assert valid


# ---------------------------------------------------------------------------
# the per-event engine
# ---------------------------------------------------------------------------

_OP = dict(width=64, height=64, chunk_size=256, sub_phases=2,
           steps_per_scan=2, use_dense=False)


def _process_recording_passes(eng, ev, monkeypatch):
    """eng.process(ev), keeping the flow_len surface each per-event
    aperture pass pooled (one a phase), in pass order."""
    passes = []
    integral = teng.build_integral

    def recording(flow_len, flow_vx, flow_vy):
        passes.append(flow_len.clone())
        return integral(flow_len, flow_vx, flow_vy)

    with monkeypatch.context() as mp:
        mp.setattr(teng, "build_integral", recording)
        out = eng.process(ev)
    return out, passes


@pytest.mark.parametrize("wire", ["f32", "f16"])
def test_perevent_engine_matches_jax(jax_mods, wire, monkeypatch):
    """Outputs and the state after process() against JAX's per-event
    engine: stamps and write epochs equal, flow surfaces within the fits'
    drift, the micro-step counter equal."""
    _, JConfig, _, _, jeng = jax_mods
    kw = dict(_OP, wire=wire)
    ev = _streams()["bar"]
    je = jeng.FlowEngine(JConfig(**kw))
    want = je.process(ev)
    te = teng.FlowEngine(TConfig(**kw), device="cpu")
    got, passes = _process_recording_passes(te, ev, monkeypatch)
    _assert_engines_agree(want, got, passes, TConfig(**kw),
                          f"perevent {wire}")
    js, ts = je.state, te.state
    assert int(js.step) == ts.step > 0
    for name in ("t_surf", "epoch"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("flow_len", "flow_vx", "flow_vy"):
        w = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), w, rtol=2e-3,
                                   atol=2e-3 * np.abs(w).max(),
                                   err_msg=name)


def _winners(ev, cfg):
    """Lanes that are the last event at their pixel within their phase."""
    n = len(ev)
    flat = ev.x.astype(np.int64) * cfg.height + ev.y
    blk = cfg.chunk_size // cfg.sub_phases
    win = np.zeros(n, bool)
    for s in range(0, n, blk):
        f = flat[s:s + blk]
        last = {p: i for i, p in enumerate(f)}
        win[s + np.fromiter(last.values(), int)] = True
    return win


@pytest.mark.parametrize("wire", ["f32", "f16"])
def test_perevent_and_dense_engines_agree_on_winners(wire):
    """A phase's winner lane reads the same causal view, folds in the same
    order and pools the same surfaces in both formulations, so its output
    row is bitwise equal; the flow surfaces and stamps after the stream
    are too. (Non-winner lanes differ: the dense path gives them their
    pixel's winner's flow.)"""
    ev = _multi_pass_bar()
    cfg = TConfig(**dict(_OP, wire=wire))
    pe = teng.FlowEngine(cfg, device="cpu")
    de = teng.FlowEngine(dataclasses.replace(cfg, use_dense=True),
                         device="cpu")
    a, b = pe.process(ev), de.process(ev)
    win = _winners(ev, cfg)
    assert 0.5 < win.mean() < 1 and (a.r_local[win] > 0).sum() > 40
    for col in ("r_true", "theta_true", "vx", "vy", "r_local",
                "theta_local", "scale"):
        np.testing.assert_array_equal(getattr(a, col)[win],
                                      getattr(b, col)[win], err_msg=col)
    for name in ("t_surf", "flow_len", "flow_vx", "flow_vy"):
        assert torch.equal(getattr(pe.state, name), getattr(de.state, name))


def _past_2e31():
    """tests/test_golden.py:131: an anchor event latches t0, then the bar
    plays out straddling 2^31 (stamp1 values wrap negative as int32)."""
    bar = tio.synthetic_translating_bar(
        width=64, height=64, bar_len=20, duration_us=30000,
        speed_px_per_sec=1000, jitter_us=20, seed=3)[:500]
    shift = np.uint32(2**31 - 15000)
    ev = tio.EventBatch(
        x=np.concatenate([[5], bar.x]).astype(np.int32),
        y=np.concatenate([[5], bar.y]).astype(np.int32),
        t=np.concatenate([[np.uint32(5)],
                          bar.t + shift + np.uint32(5)]).astype(np.uint32),
        pol=np.concatenate([[1], bar.pol]).astype(np.int32))
    assert int(ev.t[-1] - ev.t[0]) > 2**31
    return ev


@pytest.mark.parametrize("stream", ["bar", "past_2e31"])
def test_perevent_chunk1_matches_oracle(stream):
    """tests/test_golden.py:44 and :121 with dense=False: chunk_size=1 is
    the event-serial reference."""
    ev = _golden_bar() if stream == "bar" else _past_2e31()
    cfg = TConfig(width=64, height=64, chunk_size=1, steps_per_scan=32,
                  use_dense=False)
    ref = run_oracle(ev, TConfig(width=64, height=64))
    _assert_matches_oracle(ref, teng.FlowEngine(cfg, device="cpu").process(ev))


def test_perevent_random_stream_matches_oracle():
    """tests/test_golden.py:63 with dense=False: random events with
    duplicate pixels, invalid fits and borders; f32 against float64 may
    flip a knife-edge fit."""
    ev = tio.synthetic_random_events(800, width=48, height=48, rate_hz=3e6,
                                     seed=9)
    cfg = TConfig(width=48, height=48, chunk_size=1, steps_per_scan=32,
                  use_dense=False)
    ref = run_oracle(ev, cfg)
    got = teng.FlowEngine(cfg, device="cpu").process(ev)
    rv, gv = ref.r_local > 0, got.r_local > 0
    assert (rv != gv).sum() <= len(ev) * 0.01
    m = rv & gv
    if m.any():
        np.testing.assert_allclose(got.r_local[m], ref.r_local[m],
                                   rtol=1e-3, atol=1e-3)
        assert _angular_err_deg(ref, got, m).max() < 0.5
        assert (ref.scale[m] == got.scale[m]).mean() > 0.98


@pytest.mark.parametrize("chunk_size", [64, 256])
def test_perevent_chunked_within_budget(chunk_size):
    """tests/test_golden.py:100 with dense=False: larger chunks stay within
    the BASELINE.json budget (AEE < 0.5 px/ms, angular error < 5 deg)."""
    ev = _golden_bar()
    ref = run_oracle(ev, TConfig(width=64, height=64))
    cfg = TConfig(width=64, height=64, chunk_size=chunk_size,
                  steps_per_scan=4, use_dense=False)
    got = teng.FlowEngine(cfg, device="cpu").process(ev)
    rv, gv = ref.r_local > 0, got.r_local > 0
    assert (rv != gv).mean() < 0.05
    m = rv & gv

    def vec(o):
        return np.stack([o.r_true * np.cos(o.theta_true),
                         o.r_true * np.sin(o.theta_true)], 1)[m]

    assert np.linalg.norm(vec(ref) - vec(got), axis=1).mean() < 500.0
    assert _angular_err_deg(ref, got, m).mean() < 5.0


def test_perevent_filter_size_7_matches_oracle():
    """tests/test_configs_sweep.py:18-20's (7, 10, False) case: k = 7 with
    10 inliers on the per-event path at chunk_size=1."""
    ev = tio.synthetic_translating_bar(
        width=64, height=64, bar_len=24, duration_us=25000,
        speed_px_per_sec=1500, jitter_us=30, seed=3)[:400]
    cfg = TConfig(width=64, height=64, filter_size=7, min_evts_on_plane=10,
                  chunk_size=1, steps_per_scan=25, use_dense=False)
    ref = run_oracle(ev, cfg)
    got = teng.FlowEngine(cfg, device="cpu").process(ev)
    rv, gv = ref.r_local > 0, got.r_local > 0
    assert (rv != gv).sum() <= max(2, len(ev) * 0.01)
    m = rv & gv
    assert m.sum() > 20
    np.testing.assert_allclose(got.r_local[m], ref.r_local[m], rtol=2e-3,
                               atol=1e-3)
    assert (ref.scale[m] == got.scale[m]).mean() > 0.97


def test_halo_engine_refuses_perevent():
    """JAX's HaloFlowEngine refuses the per-event path
    (farms_tpu/parallel/halo.py:616-617); so does the port's."""
    from farms_tpu_torch.parallel.halo import HaloFlowEngine
    with pytest.raises(ValueError, match="dense compute path"):
        HaloFlowEngine(TConfig(**_OP), device="cpu")


def test_perevent_wire_keeps_raw_nan():
    """With min_evts_on_plane=0 a fit with dtdp == 0 gives the reference's
    inf/nan pair; the per-event wire ships it unscrubbed on both wires,
    as farms_tpu's wire_pack does (the dense path scrubs its maps)."""
    cfg = TConfig(width=16, height=16, chunk_size=1, steps_per_scan=1,
                  min_evts_on_plane=0, use_dense=False)
    t = np.full((16, 16), 101, np.int32)           # a flat plane: a = b = 0
    s = torch.from_numpy(t)
    vx, vy, gate, _, _ = tlf.local_flow_batch(
        s, s, torch.tensor([8]), torch.tensor([8]),
        torch.tensor([101], dtype=torch.int32), cfg)
    assert torch.isinf(vx).all() and torch.isnan(vy).all() and not gate.any()
    for wire in ("f32", "f16"):
        main, aux = teng.wire_pack(vx, vy, torch.zeros(1), torch.zeros(1),
                                   torch.zeros(1),
                                   dataclasses.replace(cfg, wire=wire))
        cols = teng.decode_wire_columns(main.numpy(), aux.numpy(),
                                        dataclasses.replace(cfg, wire=wire))
        assert np.isnan(cols["vy"]).all() and cols["r_local"][0] == 0


def test_cli_perevent_matches_jax_cli(tmp_path, capsys):
    """`--backend perevent` through both CLIs (tests/test_torch_cli.py's
    point: chunk 256, 2 sub-phases, f16 wire): the same prints up to the
    measured duration and the same output file but for the fits' drift."""
    pytest.importorskip("jax")
    from farms_tpu import cli as jcli
    from farms_tpu_torch import cli as tcli
    from test_torch_cli import _POINT, _events_file

    ev, base = _events_file(tmp_path, "perevent")
    argv = ["--filename", base, *_POINT, "--backend", "perevent"]
    assert jcli.main(argv) == 0
    want = tio.read_flow_txt(base + "_FARMSOut_batch.txt")
    jax_out = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = tio.read_flow_txt(base + "_FARMSOut_batch.txt")
    out = capsys.readouterr().out
    assert len(got) == len(want) == len(ev)
    for col in ("x", "y", "t", "pol", "scale"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    valid = want.r_local > 0
    np.testing.assert_array_equal(got.r_local > 0, valid)
    assert valid.mean() > 0.3
    np.testing.assert_allclose(got.r_true[valid], want.r_true[valid],
                               rtol=2e-3)

    def lines(text):
        return [ln for ln in text.splitlines() if "[Benchmark Main]" not in ln]

    assert lines(out) == lines(jax_out)

"""Properties of the fidelity features, on the port alone, and pack_r2.

The port's versions of the semantics tests of `farms_tpu`
(tests/test_golden.py: aperture sub-phases, causal snapshots, coarse
pooling; tests/test_center_correction.py: rank-2 identification, the
collision-free invariance, the rank-2 lane's serial fit). Where those hold
an engine against the JAX chunk-1 engine, these use the port's own, so
they stay fast. pack_r2 is NumPy and bitwise equal to `farms_tpu`'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.state.surfaces import init_state
from test_torch_engine import _multi_pass_bar

torch.set_num_threads(1)

_LOCAL = ("vx", "vy", "r_local", "theta_local")
_ALL = _LOCAL + ("r_true", "theta_true", "scale")


def _bar():
    # tests/test_golden.py:31-35
    return tio.synthetic_translating_bar(
        width=64, height=64, bar_len=20, duration_us=30000,
        speed_px_per_sec=1000, jitter_us=20, seed=1)[:600]


def _run(ev, **kw):
    return teng.FlowEngine(TConfig(**kw), device="cpu").process(ev)


def _assert_columns_equal(a, b, cols, what=""):
    for col in cols:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=f"{what} {col}")


# ---------------------------------------------------------------------------
# pack_r2
# ---------------------------------------------------------------------------

def test_port_pack_r2_finds_rank2_lanes():
    """tests/test_center_correction.py:44. One chunk (m = 8, P = 2): pixel
    A fires at lanes 0, 1, 3 (rank 2: lane 1), pixel B at lanes 4, 6
    (rank 2: lane 4), pixel A again at 5, 7 (rank 2: lane 5, which
    replaces lane 1: the latest occurrence per pixel is kept)."""
    x = np.array([2, 2, 9, 2, 5, 2, 5, 2], np.int32)
    y = np.array([3, 3, 9, 3, 6, 3, 6, 3], np.int32)
    t = np.arange(8, dtype=np.uint32) * 10
    ev = tio.EventBatch(x, y, t, np.ones(8, np.int32))
    cfg = TConfig(width=16, height=16, chunk_size=8, sub_phases=2,
                  steps_per_scan=1, wire="f32", center_correction=4)
    flags, centers = teng.FlowEngine(cfg, device="cpu").pack_r2(
        ev, steps_per_call=1)
    assert sorted(np.nonzero(flags[0, 0])[0].tolist()) == [4, 5]
    ctr = centers[0, 0]
    assert ctr[5, 6] == 41 and ctr[2, 3] == 51
    assert (ctr != 0).sum() == 2


@pytest.mark.parametrize("stream, budget", [
    ("multi-pass bar", 256), ("multi-pass bar", 16), ("random", 256)])
def test_port_pack_r2_bitwise_equal(stream, budget):
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.pipeline import engine as jeng

    ev = (_multi_pass_bar() if stream == "multi-pass bar" else
          tio.synthetic_random_events(6000, width=64, height=64,
                                      rate_hz=1e6, seed=9))
    kw = dict(width=64, height=64, chunk_size=1024, steps_per_scan=2,
              sub_phases=2, causal_snapshots=4, center_correction=budget)
    want = jeng.FlowEngine(JConfig(**kw)).pack_r2(ev)
    got = teng.FlowEngine(TConfig(**kw), device="cpu").pack_r2(ev)
    for name, a, b in zip(("flags", "centers"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    per_step = want[0].reshape(-1, kw["chunk_size"]).sum(1)
    assert per_step.max() > 0 and per_step.max() <= budget


# ---------------------------------------------------------------------------
# center correction
# ---------------------------------------------------------------------------

def test_port_correction_without_collisions_changes_nothing():
    """tests/test_center_correction.py:65: no pixel fires twice in a
    chunk, so there is no rank-2 lane and correction changes nothing."""
    n = 512
    x = (np.arange(n) % 60 + 2).astype(np.int32)
    y = ((np.arange(n) * 7) % 60 + 2).astype(np.int32)
    t = (np.arange(n) * 40).astype(np.uint32)
    ev = tio.EventBatch(x, y, t, np.ones(n, np.int32))
    base = dict(width=64, height=64, chunk_size=64, sub_phases=1,
                steps_per_scan=2, wire="f32")
    _assert_columns_equal(_run(ev, **base),
                          _run(ev, **base, center_correction=8),
                          ("vx", "vy", "r_local", "r_true", "scale"))


def test_port_rank2_lane_gets_its_serial_fit():
    """tests/test_center_correction.py:82, held against the port's own
    chunk_size=1 engine. Chunk 0 writes columns x = 17..19; chunk 1 fires
    column x = 20 and then rewrites (20, 20), so that column event is a
    rank-2 lane far from every other co-chunk event: corrected, its local
    columns equal the event-serial fit bit for bit; uncorrected, it
    inherits the winner's fit, which sees (20, 21)."""
    m = 64
    xs, ys, ts = [], [], []
    for i, cx in enumerate((17, 18, 19)):
        for yy in range(14, 27):
            xs.append(cx)
            ys.append(yy)
            ts.append(5500 + i * 100 + (yy - 14))
    for j in range(m - len(xs) % m):            # distinct-pixel fill
        xs.append(40 + j // 16)
        ys.append(34 + j % 16)
        ts.append(5790)
    n0 = len(xs)
    for yy in range(14, 27):                    # chunk 1: column x = 20
        xs.append(20)
        ys.append(yy)
        ts.append(5800 + (yy - 14))
    pair_lane = len(xs) - 7                     # the (20, 20) event
    xs.append(20)
    ys.append(20)
    ts.append(5830)
    for j in range(m - (len(xs) - n0) % m):
        xs.append(50 + j // 16)
        ys.append(34 + j % 16)
        ts.append(5840 + j)
    ev = tio.EventBatch(np.asarray(xs, np.int32), np.asarray(ys, np.int32),
                        np.asarray(ts, np.uint32), np.ones(len(xs), np.int32))
    base = dict(width=64, height=64, chunk_size=m, sub_phases=1,
                steps_per_scan=1, wire="f32")
    out_c = _run(ev, **base, center_correction=8)
    out_1 = _run(ev, width=64, height=64, chunk_size=1, wire="f32")
    out_n = _run(ev, **base)
    for col in _LOCAL:
        a = getattr(out_c, col)[pair_lane]
        b = getattr(out_1, col)[pair_lane]
        assert a == b or (np.isnan(a) and np.isnan(b)), (col, a, b)
    assert out_c.r_local[pair_lane] > 0
    assert out_n.vx[pair_lane] != out_1.vx[pair_lane]


# ---------------------------------------------------------------------------
# aperture phasing and causal snapshots
# ---------------------------------------------------------------------------

def test_port_aperture_phasing_keeps_local_lanes():
    """tests/test_golden.py:251: A == P is the coupled default, bit for
    bit; finer A (8 pooling passes per chunk) moves only the pooled
    columns, never the plane fit's."""
    ev = _bar()
    base = dict(width=64, height=64, chunk_size=256, steps_per_scan=4,
                sub_phases=2)
    a = _run(ev, **base)
    _assert_columns_equal(a, _run(ev, **base, aperture_sub_phases=2), _ALL,
                          "A == P")
    c = _run(ev, **base, aperture_sub_phases=8)
    _assert_columns_equal(a, c, ("vx", "vy", "r_local"), "A = 8")
    assert len(c) == len(a) and (c.r_local > 0).sum() > 100


def test_port_snapshots_fold_semantics():
    """tests/test_golden.py:281. (1) With no pixel firing twice in a
    chunk every snapshot equals a pixel's pre or post value, so S = 4 is
    bit-identical to S = 1. (2) On a rewrite-heavy stream S = 4 agrees
    with the event-serial engine on at least as many validity rows as
    S = 1."""
    rng = np.random.default_rng(11)
    m = 64
    n = 4 * m
    pix = rng.choice(64 * 64, size=n, replace=False)
    ev = tio.EventBatch(
        (pix // 64).astype(np.int32), (pix % 64).astype(np.int32),
        np.sort(rng.integers(1000, 60000, n)).astype(np.uint32),
        np.ones(n, np.int32))
    _assert_columns_equal(
        _run(ev, width=64, height=64, chunk_size=m),
        _run(ev, width=64, height=64, chunk_size=m, causal_snapshots=4),
        ("vx", "vy", "r_true", "r_local", "scale"), "rewrite-free")

    n2 = 512
    ev2 = tio.EventBatch(
        rng.integers(10, 26, n2).astype(np.int32),
        rng.integers(10, 26, n2).astype(np.int32),
        np.sort(rng.integers(1000, 120000, n2)).astype(np.uint32),
        np.ones(n2, np.int32))
    sv = _run(ev2, width=64, height=64, chunk_size=1,
              steps_per_scan=64).r_local > 0
    s1 = _run(ev2, width=64, height=64, chunk_size=256).r_local > 0
    s4 = _run(ev2, width=64, height=64, chunk_size=256,
              causal_snapshots=4).r_local > 0
    assert (s4 == sv).sum() >= (s1 == sv).sum()
    assert (s4 != s1).any()                  # the chain is not inert here


def test_port_coarse_pooling_matches_one_pass():
    """tests/test_golden.py:333. Coarse pooling (A = 1 < P = 2): the
    plane-fit lanes equal the uniform run's bit for bit, and the pooled
    columns equal one aperture pass over the flow surfaces that all the
    group's phases left (the kill window is huge, so the two runs' state
    evolves identically)."""
    W = H = 64
    m = 256
    cfg_u = TConfig(width=W, height=H, chunk_size=m, sub_phases=2,
                    kill_old_flow_time_us=1 << 29)
    cfg_c = dataclasses.replace(cfg_u, aperture_sub_phases=1)
    packed, _ = teng.FlowEngine(cfg_u, device="cpu").pack(
        _bar()[:m], steps_per_call=1, compact=True)
    batch = {"ev": torch.from_numpy(packed[0, 0])}
    st_u, (main_u, aux_u) = teng.micro_step(init_state(cfg_u, "cpu"), batch,
                                            cfg_u)
    st_c, (main_c, aux_c) = teng.micro_step(init_state(cfg_c, "cpu"), batch,
                                            cfg_c)
    for f in ("t_surf", "flow_len", "flow_vx", "flow_vy"):
        assert torch.equal(getattr(st_u, f), getattr(st_c, f)), f

    tvx, tvy, scale = tdf.dense_aperture(st_u.flow_len, st_u.flow_vx,
                                         st_u.flow_vy, cfg_u)
    x, y, _, _ = teng._decode_batch(batch, cfg_u)
    tf = tdf.onehot_gather(torch.stack([tvx, tvy, scale.float()]), x, y,
                           W, H).numpy()
    aux_c, aux_u = aux_c.numpy(), aux_u.numpy()
    main_c, main_u = main_c.numpy(), main_u.numpy()
    valid = (aux_c & 0x80) != 0
    assert valid.sum() > 20
    np.testing.assert_array_equal(valid, (aux_u & 0x80) != 0)
    np.testing.assert_array_equal(main_c[:2], main_u[:2])
    np.testing.assert_array_equal(main_c[2].view(np.float32),
                                  np.where(valid, tf[0], 0.0))
    np.testing.assert_array_equal(main_c[3].view(np.float32),
                                  np.where(valid, tf[1], 0.0))
    np.testing.assert_array_equal(
        aux_c & 0x7F, np.where(valid, tf[2] // cfg_u.window_jump, 0))

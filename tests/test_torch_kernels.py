"""The port's dense stages vs the JAX reference, and its kernels vs plain.

On the CPU the wrappers of ops/kernels.py run the plain PyTorch versions
(ops/dense_flow.py). Those are held against `farms_tpu`'s XLA dense path
and its Pallas kernels (interpreter mode) on the same numpy-seeded inputs,
with the exact-selection tolerance masks of tests/test_pallas_kernels.py:
candidate and scale ids exact off fp near-ties, accept flips <= 5e-4,
float fields within 0.1% / 5% of the velocity magnitude. The CUDA kernels
run only on a card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from farms_tpu.config import FlowConfig as JConfig  # noqa: E402
from farms_tpu.ops import dense_flow as jdf  # noqa: E402
from farms_tpu.ops.pallas import kernels as pk  # noqa: E402


def _cfgs(**kw):
    return JConfig(**kw), TConfig(**kw)


def _port_local(t_pre, t_post, cfg):
    chain = torch.from_numpy(np.asarray(t_pre, np.int32))[None]
    center = torch.from_numpy(np.asarray(t_post, np.int32))
    acc, a, b, dtdp, cand = tk.local_flow(chain, center, cfg)
    return [o.numpy() for o in tdf.trig_tail(acc, a, b, dtdp)], cand.numpy()


def _assert_local_equivalent(ref, rcand, scores, out, pcand, what):
    """tests/test_pallas_kernels.py::_assert_local_equivalent with `ref`
    (the JAX outputs) and `out` (the port's) given as numpy arrays."""
    scores = np.asarray(scores, np.float64)
    ssort = np.sort(scores, axis=0)
    local_ok = np.isfinite(ssort[0])
    tie = (ssort[1] - ssort[0]) <= 1e-5 * (np.abs(ssort[0]) + 1.0)
    decided = local_ok & ~tie
    rcand = np.asarray(rcand)
    np.testing.assert_array_equal(
        pcand[decided], rcand[decided],
        err_msg=f"{what}: candidate selection differs off-tie")
    assert (pcand[~local_ok] == -1).all(), f"{what}: cand id at ~local_ok"
    agree = (pcand == rcand) & local_ok
    rvx0 = np.asarray(ref[0])[agree] == 0
    ovx0 = np.asarray(out[0])[agree] == 0
    flip = rvx0 != ovx0
    assert flip.mean() <= 5e-4, f"{what}: {flip.sum()}/{flip.size} accept flips"
    keep = ~flip
    rlen = np.asarray(ref[3], np.float64)[agree][keep]
    for name, r, o in zip(["vx", "vy", "gate", "len", "theta"], ref, out):
        r = np.asarray(r, np.float64)[agree][keep]
        o = np.asarray(o, np.float64)[agree][keep]
        if name == "gate":
            np.testing.assert_array_equal(o, r, err_msg=f"{what} {name}")
        elif name == "theta":
            d = np.abs(o - r) % (2 * np.pi)
            d = np.minimum(d, 2 * np.pi - d)
            bad = (d > 5e-3) & (rlen > 1e-9)
            assert bad.sum() <= max(3, 2e-4 * bad.size), (
                f"{what} theta: {bad.sum()} past 5e-3 rad")
        else:
            both_nan = np.isnan(r) & np.isnan(o)
            err = np.where(both_nan, 0.0, np.abs(o - r))
            tight = err <= 1e-3 * np.abs(r) + 1e-3 * rlen + 1e-4
            loose = err <= 1e-3 * np.abs(r) + 5e-2 * rlen + 1e-4
            assert (~loose).sum() <= max(3, 2e-4 * loose.size), (
                f"{what} {name}: {(~loose).sum()} past 5%-of-magnitude")
            assert (~tight).sum() <= max(3, 1e-3 * tight.size), (
                f"{what} {name}: {(~tight).sum()}/{tight.size} past the "
                f"0.1%-of-magnitude tier")
    for name, r, o in zip(["vx", "vy", "gate"], ref, out):
        np.testing.assert_array_equal(np.asarray(o)[~local_ok],
                                      np.asarray(r)[~local_ok],
                                      err_msg=f"{what} {name} @ ~local_ok")


def _random_surfaces(W, H, seed, touched_frac=0.8, hot=800):
    rng = np.random.default_rng(seed)
    touched = rng.random((W, H)) < touched_frac
    t_pre = np.where(touched, rng.integers(1, 5_000_000, (W, H)) + 1, 0)
    t_post = t_pre.copy()
    x0, x1, y0, y1 = W // 5, 4 * W // 5, H // 8, 5 * H // 8
    blk = t_pre[x0:x1, y0:y1]
    t_post[x0:x1, y0:y1] = blk + hot + (blk == 0)
    return t_pre.astype(np.int32), t_post.astype(np.int32)


def _wrap_surfaces(W, H, seed):
    """Stamps on both sides of 2^31 and near 2^32 (wrapped-negative int32,
    neighbors "in the future" mod 2^32) with half the cells untouched."""
    rng = np.random.default_rng(seed)
    touched = rng.random((W, H)) < 0.5
    t = np.where(touched,
                 rng.choice([101, 5001, 2**31 + 7, 2**32 - 3], size=(W, H)),
                 0).astype(np.uint32).view(np.int32)
    post = t.copy()
    post[::3, ::2] = (t[::3, ::2].view(np.uint32) + np.uint32(700)).view(np.int32)
    return t, post


_SURFACES = {"random": _random_surfaces, "wrap": _wrap_surfaces}


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("geom", [(48, 40), (64, 528)])
@pytest.mark.parametrize("kind", ["random", "wrap"])
def test_local_flow_matches_jax_dense(k, geom, kind):
    W, H = geom
    jc, tc = _cfgs(width=W, height=H, filter_size=k,
                   min_evts_on_plane=5 if k == 3 else 3)
    t_pre, t_post = _SURFACES[kind](W, H, seed=11 + k)
    *ref, rbest, scores = jdf.dense_local_flow(
        jnp.asarray(t_pre), jnp.asarray(t_post), jc, want_ids=True)
    out, pcand = _port_local(t_pre, t_post, tc)
    assert (pcand >= 0).mean() > 0.5
    _assert_local_equivalent(ref, rbest, scores, out, pcand,
                             f"dense k{k} {W}x{H} {kind}")


@pytest.mark.parametrize("k, kind", [(3, "random"), (5, "random"),
                                     (3, "wrap")])
def test_local_flow_matches_pallas_interpret(k, kind):
    W, H = 48, 40
    jc, tc = _cfgs(width=W, height=H, filter_size=k,
                   min_evts_on_plane=5 if k == 3 else 3)
    t_pre, t_post = _SURFACES[kind](W, H, seed=21 + k)
    *_, scores = jdf.dense_local_flow(jnp.asarray(t_pre),
                                      jnp.asarray(t_post), jc, want_ids=True)
    *ref, rcand = pk.local_flow_pallas(jnp.asarray(t_pre),
                                       jnp.asarray(t_post), jc, want_ids=True)
    out, pcand = _port_local(t_pre, t_post, tc)
    _assert_local_equivalent(ref, rcand, scores, out, pcand,
                             f"pallas k{k} {kind}")


def test_local_flow_snapshot_chain_matches_jax_dense():
    """A 3-surface chain (oldest, boundary, post): the causal fold sees
    the intermediate surface exactly as the JAX dense path does
    (tests/test_pallas_kernels.py::test_local_flow_snapshots_match_dense)."""
    W, H = 48, 40
    jc, tc = _cfgs(width=W, height=H)
    rng = np.random.default_rng(9)
    touched = rng.random((W, H)) < 0.7
    pre = np.where(touched, rng.integers(1, 3_000, (W, H)) + 1, 0)
    mid = pre.copy()
    hot = rng.random((W, H)) < 0.5
    mid[hot] = pre[hot] + rng.integers(200, 2000, (W, H))[hot] + (pre[hot] == 0)
    post = mid.copy()
    hot2 = rng.random((W, H)) < 0.5
    post[hot2] = (mid[hot2] + rng.integers(200, 2000, (W, H))[hot2]
                  + (mid[hot2] == 0))
    pre, mid, post = (a.astype(np.int32) for a in (pre, mid, post))
    *ref, rbest, scores = jdf.dense_local_flow(
        (jnp.asarray(pre), jnp.asarray(mid)), jnp.asarray(post), jc,
        want_ids=True)
    acc, a, b, dtdp, cand = tk.local_flow(
        torch.from_numpy(np.stack([pre, mid])), torch.from_numpy(post), tc)
    out = [o.numpy() for o in tdf.trig_tail(acc, a, b, dtdp)]
    _assert_local_equivalent(ref, rbest, scores, out, cand.numpy(),
                             "snapshot chain")
    # the fold must see the intermediate surface
    base, _ = _port_local(pre, post, tc)
    assert any((~np.isclose(x, y, equal_nan=True)).any()
               for x, y in zip(base, out))


@pytest.mark.parametrize("k", [3, 5])
def test_local_flow_stamp_shift_invariance(k):
    """Outputs depend only on stamp differences: shifting every stamp by
    2^31 + delta (all stamp1 values wrap negative) changes nothing."""
    W, H = 48, 40
    tc = TConfig(width=W, height=H, filter_size=k)
    rng = np.random.default_rng(4)
    base = rng.integers(100, 40_000, (W, H)).astype(np.uint32)
    hot = base.copy()
    hot[10:30, 5:25] += 1000
    shift = np.uint32(2**31 + 12345)
    lo, lo_c = _port_local(base.view(np.int32), hot.view(np.int32), tc)
    hi, hi_c = _port_local((base + shift).view(np.int32),
                           (hot + shift).view(np.int32), tc)
    np.testing.assert_array_equal(lo_c, hi_c)
    for name, a, b in zip(["vx", "vy", "gate", "len", "theta"], lo, hi):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert lo[2].any()


def test_trig_tail_axis_aligned_knife_edge():
    """The vx != 0 / vy != 0 gate on exactly axis-aligned planes: b == 0
    keeps vx = speed * cos(fl(pi/2)) != 0 (valid); a == 0 with b > 0 gives
    vy = speed * sin(0) == 0 (invalid), with b < 0 vy = speed * sin(fl(pi))
    != 0 (valid), exactly as the JAX tail and the float64 oracle decide."""
    a = np.array([1e-3, -1e-3, 0.0, 0.0, 2e-3, 0.0, 1e-3], np.float32)
    b = np.array([0.0, 0.0, 1e-3, -1e-3, 2e-3, 0.0, -0.0], np.float32)
    dtdp = np.sqrt(a * a + b * b).astype(np.float32)
    acc = np.array([1, 1, 1, 1, 1, 1, 0], np.int32)
    vx, vy, gate, ln, th = tdf.trig_tail(*(torch.from_numpy(v) for v in
                                           (acc, a, b, dtdp)))
    ja, jb, jd = jnp.asarray(a), jnp.asarray(b), jnp.asarray(dtdp)
    speed = 1.0 / jd
    ang = jnp.arctan2(ja, jb)
    jvx = jnp.where(jnp.asarray(acc) > 0, speed * jnp.cos(ang), 0.0)
    jvy = jnp.where(jnp.asarray(acc) > 0, speed * jnp.sin(ang), 0.0)
    jgate = ~jnp.isnan(jvx) & ~jnp.isnan(jvy) & (jvx != 0) & (jvy != 0)
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    np.testing.assert_array_equal(gate.numpy(),
                                  [True, True, False, True, True, False,
                                   False])
    np.testing.assert_allclose(vx.numpy(), np.asarray(jvx), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(vy.numpy(), np.asarray(jvy), rtol=1e-6,
                               atol=1e-9)


def _flow_fields(W, H, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    fl = (rng.random((W, H)) * mask).astype(np.float32)
    fvx = (rng.standard_normal((W, H)) * (fl > 0)).astype(np.float32)
    fvy = (rng.standard_normal((W, H)) * (fl > 0)).astype(np.float32)
    return fl, fvx, fvy


def _assert_aperture_equivalent(ml, ref, out, what):
    """tests/test_pallas_kernels.py::_assert_aperture_equivalent: scale
    ids exact off near-tie winners, pooled means within rtol 1e-3 /
    atol 1e-4 where the scale agrees."""
    ml = np.asarray(ml, np.float64)
    msort = np.sort(ml, axis=0)
    tie = (msort[-1] - msort[-2]) <= 1e-5 * (np.abs(msort[-1]) + 1e-6)
    tie |= np.abs(msort[-1]) <= 1e-7
    rscale = np.asarray(ref[2])
    pscale = np.asarray(out[2])
    np.testing.assert_array_equal(pscale[~tie], rscale[~tie],
                                  err_msg=f"{what}: scale differs off-tie")
    agree = pscale == rscale
    for name, r, o in zip(["tvx", "tvy"], ref[:2], out[:2]):
        np.testing.assert_allclose(
            np.asarray(o, np.float64)[agree],
            np.asarray(r, np.float64)[agree],
            rtol=1e-3, atol=1e-4, err_msg=f"{what} {name}")


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("geom", [(48, 40), (40, 48)])
def test_aperture_matches_jax(quirk, geom):
    """Plain aperture vs JAX dense_aperture and aperture_pallas
    (interpreter). 40 x 48 has W < H, where the quirk changes the clamp."""
    W, H = geom
    jc, tc = _cfgs(width=W, height=H, replicate_y_clamp_quirk=quirk)
    fl, fvx, fvy = _flow_fields(W, H, seed=2 + W)
    jin = [jnp.asarray(a) for a in (fl, fvx, fvy)]
    *ref, ml = jdf.dense_aperture(*jin, jc, want_ids=True)
    pal = pk.aperture_pallas(*jin, jc)
    out = [o.numpy() for o in tk.aperture(
        *(torch.from_numpy(a) for a in (fl, fvx, fvy)), tc)]
    _assert_aperture_equivalent(ml, ref, out, f"dense {W}x{H} q={quirk}")
    _assert_aperture_equivalent(ml, pal, out, f"pallas {W}x{H} q={quirk}")
    assert (out[2] > 0).any()


def test_quirk_changes_clamp_only_when_width_below_height():
    fl, fvx, fvy = _flow_fields(40, 48, seed=5)
    ins = [torch.from_numpy(a) for a in (fl, fvx, fvy)]
    off = tk.aperture(*ins, TConfig(width=40, height=48))
    on = tk.aperture(*ins, TConfig(width=40, height=48,
                                   replicate_y_clamp_quirk=True))
    assert not torch.equal(off[2], on[2])
    fl, fvx, fvy = _flow_fields(48, 40, seed=5)
    ins = [torch.from_numpy(a) for a in (fl, fvx, fvy)]
    off = tk.aperture(*ins, TConfig(width=48, height=40))
    on = tk.aperture(*ins, TConfig(width=48, height=40,
                                   replicate_y_clamp_quirk=True))
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_onehot_gather_sentinel_lane():
    """Padded lanes carry the flat sentinel W*H: they read the spare zero
    column instead of indexing out of bounds."""
    maps = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    x = torch.tensor([0, 3, 4], dtype=torch.int32)
    y = torch.tensor([1, 2, 0], dtype=torch.int32)
    got = tdf.onehot_gather(maps, x, y, 4, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  [[1.0, 11.0, 0.0], [13.0, 23.0, 0.0]])


def test_cpu_wrappers_do_not_count_launches():
    tk.reset_launches()
    t_pre, t_post = _random_surfaces(24, 20, seed=1)
    _port_local(t_pre, t_post, TConfig(width=24, height=20))
    fl, fvx, fvy = _flow_fields(24, 20, seed=1)
    tk.aperture(*(torch.from_numpy(a) for a in (fl, fvx, fvy)),
                TConfig(width=24, height=20))
    assert tk.LAUNCHES == {"local_flow": 0, "aperture": 0}

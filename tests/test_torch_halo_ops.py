"""Halo modes of the port's plain kernels, and the halo engine's packer.

- `local_flow_core(halo=, row_offset=)` (k = 3, 5 and 7, default and
  correction mode) and `dense_aperture(halo=, integ=)` against `farms_tpu`'s
  `dense_local_flow(halo=, row_offset=)` and `dense_aperture(halo=, integ=)`
  on row bands cut from 64 x 64 surfaces (k = 7: 24 x 20, run eagerly under
  `jax.disable_jit()`), within the masks of tests/test_pallas_kernels.py
  (tests/test_torch_kernels.py helpers): candidate and scale ids exact off
  near-ties.
- The halo versions against the whole-sensor versions' rows: bitwise, on
  bands cut from the zero-padded surfaces and from the whole integral.
- `HaloFlowEngine.pack_halo` against `farms_tpu`'s `HaloFlowEngine.pack`
  at 4 shards: the 5-row layout, the owner-shard reorder and its
  permutation, and the rank-2 center surfaces, bitwise.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events.io import EventBatch
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.ops import kernels as tk
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.halo import HaloFlowEngine as THalo

torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from farms_tpu.config import FlowConfig as JConfig  # noqa: E402
from farms_tpu.ops import dense_flow as jdf  # noqa: E402
from test_torch_kernels import (_assert_aperture_equivalent,  # noqa: E402
                                _assert_local_equivalent)
from test_torch_local_flow_modes import _chain_and_centers  # noqa: E402
from test_torch_halo_ranks import pack_halo  # noqa: E402


def _band(arr, n, i, h):
    """Shard i of n of a [..., W, H] array with h rows from each side,
    zero past the sensor edge: exchange_halo's result, built on the host."""
    rows = arr.shape[-2] // n
    pad = [(0, 0)] * (arr.ndim - 2) + [(h, h), (0, 0)]
    return np.ascontiguousarray(
        np.pad(arr, pad)[..., i * rows:i * rows + rows + 2 * h, :])


def _local_case(W, H, k, fold, seed):
    """(chain, center) of stamp1 surfaces past 2^31: the chain ends with
    the post-scatter surface in correction mode, the center is it in the
    default mode."""
    chain, center = _chain_and_centers(W, H, seed=seed, n_mid=1)
    if fold:
        return np.stack(chain[:-1]), chain[-1]
    return np.stack(chain), center


def _jax_halo(chain, center, jc, fold, R, row0):
    js = [jnp.asarray(s) for s in chain]
    if fold:
        pre = tuple(js) if len(js) > 1 else js[0]
        return jdf.dense_local_flow(pre, jnp.asarray(center), jc, halo=R,
                                    row_offset=row0, want_ids=True)
    pre = tuple(js[:-1]) if len(js) > 2 else js[0]
    return jdf.dense_local_flow(pre, js[-1], jc, halo=R, row_offset=row0,
                                want_ids=True, t_center=jnp.asarray(center))


def _port_halo(chain, center, tc, fold, R, row0):
    acc, a, b, dtdp, cand = tk.local_flow(
        torch.from_numpy(chain), torch.from_numpy(center), tc,
        fold_center=fold, halo=R, row_offset=row0)
    return [o.numpy() for o in tdf.trig_tail(acc, a, b, dtdp)], cand.numpy()


@pytest.mark.parametrize("k, fold", [(3, True), (5, True), (3, False),
                                     (5, False), (7, True), (7, False),
                                     (11, True), (11, False)])
def test_halo_local_flow_matches_jax_dense_halo(k, fold):
    """Every shard of 4 (row_offset 0, 16, 32, 48) against the JAX dense
    halo mode; k = 7 on a 24 x 20 sensor and k = 11 (a run-time radius in
    the general kernel) on 24 x 22, each in 2 shards, eagerly."""
    W, H, n = {3: (64, 64, 4), 5: (64, 64, 4), 7: (24, 20, 2),
               11: (24, 22, 2)}[k]
    kw = dict(width=W, height=H, filter_size=k,
              min_evts_on_plane={3: 5, 5: 3, 7: 8, 11: 8}[k])
    jc, tc = JConfig(**kw), TConfig(**kw)
    R = tc.support_radius
    chain, center = _local_case(W, H, k, fold, seed=60 + k + fold)
    rows = W // n
    for i in range(n):
        ch, ce = _band(chain, n, i, R), _band(center, n, i, R)
        if k < 7:
            *ref, rbest, scores = _jax_halo(ch, ce, jc, fold, R, i * rows)
        else:
            with jax.disable_jit():
                *ref, rbest, scores = _jax_halo(ch, ce, jc, fold, R,
                                                i * rows)
        out, pcand = _port_halo(ch, ce, tc, fold, R, i * rows)
        assert out[0].shape == (rows, H)
        _assert_local_equivalent(ref, rbest, scores, out, pcand,
                                 f"halo k{k} fold={fold} shard {i}/{n}")


@pytest.mark.parametrize("k", [3, 5, 7, 11, 19])
@pytest.mark.parametrize("fold", [True, False])
def test_halo_local_flow_equals_whole_sensor_rows(k, fold):
    """A shard's band holds the values the whole-sensor zero pad reads, in
    the same order: outputs equal the whole-sensor rows bitwise, also with
    a halo deeper than R and over a padded array (width 66 in 4 shards of
    17 rows, pad rows never written); at k = 19 the halo (R = 18) is
    deeper than a shard."""
    W, H = 66, 40
    tc = TConfig(width=W, height=H, filter_size=k, min_evts_on_plane=5)
    R = tc.support_radius
    chain, center = _local_case(W, H, k, fold, seed=70 + k)
    whole = tk.local_flow(torch.from_numpy(chain), torch.from_numpy(center),
                          tc, fold_center=fold)
    assert (whole[4] >= 0).float().mean() > 0.5 and whole[0].any()
    padded = np.pad(chain, ((0, 0), (0, 2), (0, 0)))
    pcenter = np.pad(center, ((0, 2), (0, 0)))
    tc4 = tc.padded_to(4)
    rows = tc4.array_width // 4
    for h in (R, R + 3):
        for i in range(4):
            got = tk.local_flow(
                torch.from_numpy(_band(padded, 4, i, h)),
                torch.from_numpy(_band(pcenter, 4, i, h)), tc4,
                fold_center=fold, halo=h, row_offset=i * rows)
            lo, hi = i * rows, min(W, (i + 1) * rows)
            for name, g, w in zip(("accept", "a", "b", "dtdp", "cand"), got,
                                  whole):
                np.testing.assert_array_equal(
                    g.numpy()[:hi - lo], w.numpy()[lo:hi],
                    err_msg=f"k{k} halo {h} shard {i} {name}")


def _flow_fields(W, H, seed):
    rng = np.random.default_rng(seed)
    has = rng.random((W, H)) < 0.3
    fl = np.where(has, rng.uniform(0.5, 3, (W, H)), 0.0).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (W, H))
    fvx = np.where(has, np.cos(ang), 0.0).astype(np.float32)
    fvy = np.where(has, np.sin(ang), 0.0).astype(np.float32)
    return fl, fvx, fvy


def _integral_band(integ, n, i, A):
    """Shard i of n of a whole [4, W+1, H+1] integral as the band
    assemble_integral_band builds: 0 above the sensor, its total row T
    below it."""
    rows = (integ.shape[1] - 1) // n
    full = np.concatenate([np.zeros_like(integ[:, :A]), integ,
                           np.repeat(integ[:, -1:], A, axis=1)], 1)
    return np.ascontiguousarray(full[:, i * rows:i * rows + rows + 2 * A + 1])


@pytest.mark.parametrize("max_window", [10, 50])
def test_one_rank_integral_band_is_the_whole_integral(max_window):
    """assemble_integral_band at one rank (no group): the whole-sensor
    float64 integral between A zero rows and A copies of its total row,
    bitwise, and contiguous, as the aperture kernel reads it."""
    from farms_tpu_torch.parallel.halo import assemble_integral_band

    A = max_window + 1
    fields = [torch.from_numpy(a) for a in _flow_fields(64, 48, seed=3)]
    got = assemble_integral_band(*fields, mesh.Axis((0,), 0), A)
    want = _integral_band(tdf.build_integral(*fields).numpy(), 1, 0, A)
    assert got.is_contiguous() and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  want.view(np.uint64))


@pytest.mark.parametrize("max_window", [10, 20])
def test_aperture_band_matches_jax_dense_band(max_window):
    """dense_aperture(integ=) against the JAX band mode, each on its own
    integral (float64 here, f32 in JAX), every shard of 4."""
    W, H, n = 64, 64, 4
    kw = dict(width=W, height=H, max_window=max_window, window_jump=5)
    jc, tc = JConfig(**kw), TConfig(**kw)
    A = max_window + 1
    fl, fvx, fvy = _flow_fields(W, H, seed=max_window)
    t_integ = tdf.build_integral(*(torch.from_numpy(a)
                                   for a in (fl, fvx, fvy))).numpy()
    gate = (fl > 0).astype(np.float32)
    fields = jnp.stack([gate, fl * gate, fvx * gate, fvy * gate], 0)
    j_integ = np.asarray(jnp.pad(jnp.cumsum(jnp.cumsum(fields, 1), 2),
                                 ((0, 0), (1, 0), (1, 0))))
    rows = W // n
    for i in range(n):
        core = slice(i * rows, (i + 1) * rows)
        jin = [jnp.asarray(a[core]) for a in (fl, fvx, fvy)]
        *ref, ml = jdf.dense_aperture(
            *jin, jc, halo=A, want_ids=True,
            integ=jnp.asarray(_integral_band(j_integ, n, i, A)))
        out = [o.numpy() for o in tk.aperture(
            *(torch.from_numpy(np.ascontiguousarray(a[core]))
              for a in (fl, fvx, fvy)), tc, halo=A,
            integ=torch.from_numpy(_integral_band(t_integ, n, i, A)))]
        _assert_aperture_equivalent(ml, ref, out, f"band shard {i}/{n}")
        assert (out[2] > 0).any()


@pytest.mark.parametrize("quirk", [False, True])
def test_aperture_band_equals_whole_sensor_rows(quirk):
    """On a band sliced from the whole integral the band mode reads the
    values the whole-sensor clamp reads: bitwise equal rows (W < H, so the
    y-clamp quirk binds)."""
    W, H, A = 48, 56, 11
    tc = TConfig(width=W, height=H, max_window=10,
                 replicate_y_clamp_quirk=quirk)
    ins = [torch.from_numpy(a) for a in _flow_fields(W, H, seed=4)]
    whole = tk.aperture(*ins, tc)
    integ = tdf.build_integral(*ins).numpy()
    for n in (2, 4):
        rows = W // n
        for i in range(n):
            core = slice(i * rows, (i + 1) * rows)
            got = tk.aperture(*(a[core].contiguous() for a in ins), tc,
                              halo=A, integ=torch.from_numpy(
                                  _integral_band(integ, n, i, A)))
            for name, g, w in zip(("tvx", "tvy", "scale"), got, whole):
                assert torch.equal(g, w[core]), (n, i, name)


def test_band_arguments_are_checked():
    tc = TConfig(width=32, height=24, max_window=10)
    z = torch.zeros((8, 24))
    with pytest.raises(ValueError, match="band"):
        tk.aperture(z, z, z, tc, halo=11)
    with pytest.raises(ValueError, match="halo"):
        tk.aperture(z, z, z, tc, halo=5,
                    integ=torch.zeros((4, 19, 25), dtype=torch.float64))
    chain = torch.zeros((1, 12, 24), dtype=torch.int32)
    with pytest.raises(ValueError, match="support_radius"):
        tk.local_flow(chain, chain[0], TConfig(width=32, height=24,
                                               filter_size=5),
                      halo=1, row_offset=8)


# ---------------------------------------------------------------------------
# the halo engine's packer
# ---------------------------------------------------------------------------

def _four_bars(repeats=False, starts=(2, 18, 34, 50)):
    """tests/test_halo.py:193 (and :287 with repeats): four parallel bars,
    one per shard band of a 64-row sensor, interleaved event by event, so
    every scatter sub-group spreads over all 4 shards; repeats rewrite a
    fifth of the pixels one microsecond later (rank-2 lanes). Bars that
    start close together (`starts`) crowd one shard instead."""
    xs, ys, ts = [], [], []
    for step in range(12):
        for yy in range(10, 40):
            for b, x0 in enumerate(starts):
                xs.append(x0 + step)
                ys.append(yy)
                ts.append(1000 + step * 400 + (yy - 10) * 2 + b)
                if repeats and (yy + step) % 5 == 0:
                    xs.append(x0 + step)
                    ys.append(yy)
                    ts.append(1000 + step * 400 + (yy - 10) * 2 + b + 1)
    order = np.argsort(np.asarray(ts), kind="stable")
    return EventBatch(np.asarray(xs, np.int32)[order],
                      np.asarray(ys, np.int32)[order],
                      np.asarray(ts, np.uint32)[order],
                      np.ones(len(xs), np.int32))


def _one_shard_stream():
    """tests/test_halo.py:260: every event on shard 0 (overflows)."""
    rng = np.random.default_rng(3)
    n = 512
    return EventBatch(rng.integers(0, 8, n).astype(np.int32),
                      rng.integers(0, 48, n).astype(np.int32),
                      np.sort(rng.integers(0, 20000, n)).astype(np.uint32),
                      np.ones(n, np.int32))


_SHAPE = dict(width=64, height=48, chunk_size=128, steps_per_scan=2,
              max_window=10, window_jump=5, sub_phases=4,
              aperture_sub_phases=2, causal_snapshots=2)

PACK_CASES = {
    "owner-sharded": (_SHAPE, _four_bars, True),
    "overflow": (dict(_SHAPE, sub_phases=2, aperture_sub_phases=0,
                      causal_snapshots=1), _one_shard_stream, False),
    "correction": (dict(_SHAPE, center_correction=32,
                        correction_coarse_chain=True),
                   lambda: _four_bars(repeats=True), True),
    "padded": (dict(_SHAPE, width=66), _four_bars, True),
}


@pytest.mark.parametrize("name", list(PACK_CASES))
def test_pack_equals_jax_halo_pack(name):
    from farms_tpu.parallel.halo import HaloFlowEngine as JHalo

    kw, stream, sharded = PACK_CASES[name]
    ev = stream()
    je = JHalo(JConfig(use_pallas=False, **kw), num_devices=4)
    jp, jn = je.pack(ev)
    tp, tn, perm, centers = pack_halo(TConfig(**kw), ev, 4)
    assert tn == jn == len(ev)
    assert tp.dtype == np.int32
    np.testing.assert_array_equal(tp, jp)
    assert (perm is not None) == sharded == (je._shard_layout is not None)
    if sharded:
        np.testing.assert_array_equal(perm, je._shard_layout)
        assert tp.shape[2] == 4 and tp.shape[4] < kw["chunk_size"]
    if kw.get("center_correction"):
        np.testing.assert_array_equal(centers, np.stack(je._r2c_queue))
        assert tp[..., 5, :].sum() > 20          # rank-2 lanes exist
    else:
        assert centers is None


def test_pack_one_rank_is_the_5_row_layout():
    """At one rank pack_halo is the replicated 5-row layout of the compact
    pack: padded lanes x = y = 0, invalid and never winners."""
    ev = _four_bars()[:500]
    kw = dict(_SHAPE)
    te = THalo(TConfig(**kw), device="cpu")
    assert (te.rank, te.n_shards) == (0, 1)
    tp, tn, perm, centers = te.pack_halo(ev)
    compact, _ = te.pack(ev)
    assert perm is None and centers is None and tn == 500
    flat = tp[:, :, 0] * 48 + tp[:, :, 1]
    valid = tp[:, :, 3] == 1
    np.testing.assert_array_equal(np.where(valid, flat, 64 * 48),
                                  compact[:, :, 0] & 0x3FFFFFFF)
    np.testing.assert_array_equal(tp[:, :, 4], (compact[:, :, 0] >> 30) & 1)
    assert valid.sum() == 500 and not tp[:, :, :2][~np.stack(
        [valid, valid], 2)].any()

"""Tile modes of the port's plain kernels and the tile integral band.

- `local_flow_core(halo=, row_offset=, col_halo=, col_offset=)` (k = 3, 5
  and 7, default and correction mode) on the 2-D tiles of a (2, 2) grid
  against `farms_tpu`'s whole-sensor `dense_local_flow` sliced to each
  tile (k = 7 on 24 x 20, run eagerly under `jax.disable_jit()`), within
  the masks of tests/test_pallas_kernels.py (tests/test_torch_kernels.py
  helpers): candidate ids exact off near-ties, f32 outputs within their
  tiers.
- `dense_aperture(halo=, col_halo=, integ=)` on the tiles of a (2, 4)
  grid, each band cut from the whole integral (`tile_band`), against
  `farms_tpu`'s whole-sensor `dense_aperture` sliced, with and without the
  y-clamp quirk (40 x 48: W < H, where the quirk moves the clamp).
- Both tile modes against the port's whole-sensor versions' cells,
  bitwise: local flow at k = 3, 5, 7, 11 and 19 (a halo deeper than a
  tile) on a padded array, the pool with the quirk and on a (1, 8) grid
  whose last tile starts past the quirk's clamp.
- `assemble_integral_tile` on one rank: the band of the whole integral,
  bit for bit, whose pool equals the whole-sensor pool.
- Argument checks of the tile modes.
"""
import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.ops import kernels as tk
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.halo import assemble_integral_tile

torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from farms_tpu.config import FlowConfig as JConfig  # noqa: E402
from farms_tpu.ops import dense_flow as jdf  # noqa: E402
from test_torch_kernels import (_assert_aperture_equivalent,  # noqa: E402
                                _assert_local_equivalent, _flow_fields)
from test_torch_local_flow_modes import (_chain_and_centers,  # noqa: E402
                                         _jax_dense)


def _tiles(W, H, shape):
    """(row0, rows, col0, cols) of every tile of a (tx, ty) grid over a
    W x H array, in rank order (tile (r % tx, r // tx))."""
    tx, ty = shape
    rows, cols = W // tx, H // ty
    return [((r % tx) * rows, rows, (r // tx) * cols, cols)
            for r in range(tx * ty)]


def _cut(arr, tile, h):
    """A tile of a [..., W, H] array with h cells more on each side in
    both axes, zero past the edge: the time-surface halos a rank of the
    spatial engine exchanges."""
    r0, rows, c0, cols = tile
    pad = [(0, 0)] * (arr.ndim - 2) + [(h, h), (h, h)]
    return np.ascontiguousarray(
        np.pad(arr, pad)[..., r0:r0 + rows + 2 * h, c0:c0 + cols + 2 * h])


def _core(arr, tile):
    r0, rows, c0, cols = tile
    return np.asarray(arr)[..., r0:r0 + rows, c0:c0 + cols]


def _local_case(W, H, fold, seed):
    """(chain, center): the chain ends with the post-scatter surface in
    correction mode, the center is it in the default mode."""
    chain, center = _chain_and_centers(W, H, seed=seed, n_mid=1)
    if fold:
        return np.stack(chain[:-1]), chain[-1]
    return np.stack(chain), center


def _port_tile(chain, center, cfg, fold, tile, R):
    r0, _, c0, _ = tile
    acc, a, b, dtdp, cand = tk.local_flow(
        torch.from_numpy(_cut(chain, tile, R)),
        torch.from_numpy(_cut(center, tile, R)), cfg, fold_center=fold,
        halo=R, row_offset=r0, col_halo=R, col_offset=c0)
    return [o.numpy() for o in tdf.trig_tail(acc, a, b, dtdp)], cand.numpy()


@pytest.mark.parametrize("k, fold", [(3, True), (5, True), (3, False),
                                     (5, False), (7, True), (7, False)])
def test_tile_local_flow_matches_jax_dense_slices(k, fold):
    """Every tile of a (2, 2) grid against the JAX whole-sensor plane fit
    sliced to it: 64 x 64 at k = 3 and 5, 24 x 20 at k = 7 (eagerly)."""
    W, H = (64, 64) if k < 7 else (24, 20)
    kw = dict(width=W, height=H, filter_size=k,
              min_evts_on_plane={3: 5, 5: 3, 7: 8}[k])
    jc, tc = JConfig(**kw), TConfig(**kw)
    R = tc.support_radius
    chain, center = _local_case(W, H, fold, seed=80 + k + fold)
    if k < 7:
        *ref, rbest, scores = _jax_dense(list(chain), center, jc, fold)
    else:
        with jax.disable_jit():
            *ref, rbest, scores = _jax_dense(list(chain), center, jc, fold)
    for i, tile in enumerate(_tiles(W, H, (2, 2))):
        out, pcand = _port_tile(chain, center, tc, fold, tile, R)
        assert out[0].shape == (tile[1], tile[3])
        _assert_local_equivalent([_core(r, tile) for r in ref],
                                 _core(rbest, tile), _core(scores, tile),
                                 out, pcand,
                                 f"tile k{k} fold={fold} tile {i}")


@pytest.mark.parametrize("quirk", [False, True])
def test_tile_aperture_matches_jax_dense_slices(quirk):
    """Every tile of a (2, 4) grid over 40 x 48 (W < H: the quirk clamps y
    at 40, inside the last tile's band) against the JAX whole-sensor pool
    sliced, each tile's band cut from the whole integral."""
    W, H = 40, 48
    kw = dict(width=W, height=H, max_window=10,
              replicate_y_clamp_quirk=quirk)
    jc, tc = JConfig(**kw), TConfig(**kw)
    A = tc.max_window + 1
    fields = _flow_fields(W, H, seed=7 + quirk)
    *ref, ml = jdf.dense_aperture(*(jnp.asarray(a) for a in fields), jc,
                                  want_ids=True)
    ins = [torch.from_numpy(a) for a in fields]
    integ = tdf.build_integral(*ins)
    yc = tdf.aperture_y_clip(tc)
    pooled = 0
    for i, tile in enumerate(_tiles(W, H, (2, 4))):
        r0, rows, c0, cols = tile
        out = [o.numpy() for o in tk.aperture(
            *(torch.from_numpy(np.ascontiguousarray(_core(a, tile)))
              for a in fields), tc, halo=A, col_halo=A,
            integ=tdf.tile_band(integ, r0, rows, c0, cols, A, yc))]
        _assert_aperture_equivalent(_core(ml, tile),
                                    [_core(r, tile) for r in ref], out,
                                    f"tile q={quirk} tile {i}")
        pooled += (out[2] > 0).sum()
    assert pooled > 0


@pytest.mark.parametrize("k", [3, 5, 7, 11, 19])
@pytest.mark.parametrize("fold", [True, False])
def test_tile_local_flow_equals_whole_sensor_cells(k, fold):
    """A tile's band holds the values the whole-sensor zero pad reads, in
    the same order: outputs equal the whole-sensor cells bitwise, on a
    (4, 2) grid over 66 x 40 in a 68 x 40 array (pad rows never written)
    and, at k = 19 (R = 18), with a halo deeper than the 17-row tiles."""
    W, H = 66, 40
    tc = TConfig(width=W, height=H, filter_size=k,
                 min_evts_on_plane=5).padded_to(4, 2)
    R = tc.support_radius
    chain, center = _local_case(W, H, fold, seed=90 + k)
    pad = [(0, 0)] * (chain.ndim - 2) + [(0, 2), (0, 0)]
    chain, center = np.pad(chain, pad), np.pad(center, [(0, 2), (0, 0)])
    whole = tk.local_flow(torch.from_numpy(chain), torch.from_numpy(center),
                          tc, fold_center=fold)
    assert (whole[4] >= 0).float().mean() > 0.4 and whole[0].any()
    for tile in _tiles(68, 40, (4, 2)):
        r0, rows, c0, cols = tile
        got = tk.local_flow(
            torch.from_numpy(_cut(chain, tile, R)),
            torch.from_numpy(_cut(center, tile, R)), tc, fold_center=fold,
            halo=R, row_offset=r0, col_halo=R, col_offset=c0)
        for name, g, w in zip(("accept", "a", "b", "dtdp", "cand"), got,
                              whole):
            w = w[r0:r0 + rows, c0:c0 + cols]
            assert torch.equal(g.view(torch.int32), w.contiguous().view(
                torch.int32)), (tile, name)


@pytest.mark.parametrize("W, H, shape, quirk", [
    (40, 48, (2, 4), True), (66, 40, (4, 2), False), (40, 64, (1, 8), True)])
def test_tile_aperture_equals_whole_sensor_cells(W, H, shape, quirk):
    """The pool on every tile's band (cut from the whole integral,
    pre-clamped in y) equals the whole-sensor pool's cells bitwise: with
    the quirk, on a padded array, and on a (1, 8) grid whose last tiles
    start past the quirk's clamp + max_window + 1 (column 56 > 40 + 11)."""
    tc = TConfig(width=W, height=H, max_window=10,
                 replicate_y_clamp_quirk=quirk).padded_to(*shape)
    Wa, Ha = tc.array_width, tc.array_height
    A = tc.max_window + 1
    fields = [np.pad(a, [(0, Wa - W), (0, Ha - H)])
              for a in _flow_fields(W, H, seed=3 + W)]
    ins = [torch.from_numpy(a) for a in fields]
    whole = tk.aperture(*ins, tc)
    integ = tdf.build_integral(*ins)
    yc = tdf.aperture_y_clip(tc)
    assert (whole[2] > 0).any()
    for tile in _tiles(Wa, Ha, shape):
        r0, rows, c0, cols = tile
        band = tdf.tile_band(integ, r0, rows, c0, cols, A, yc)
        assert band.shape == (4, rows + 2 * A + 1, cols + 2 * A + 1)
        got = tk.aperture(*(a[r0:r0 + rows, c0:c0 + cols].contiguous()
                            for a in ins), tc, halo=A, col_halo=A,
                          integ=band)
        for name, g, w in zip(("tvx", "tvy", "scale"), got, whole):
            assert torch.equal(g, w[r0:r0 + rows, c0:c0 + cols]), (tile,
                                                                   name)


@pytest.mark.parametrize("quirk", [False, True])
def test_one_rank_tile_integral_is_the_whole_integral(quirk):
    """With one rank (no process group) the tile integral band holds the
    whole integral bit for bit: 0 before the sensor, the total row below
    it, column y_clip past it; its pool is the whole-sensor pool."""
    W, H = 40, 52
    tc = TConfig(width=W, height=H, max_window=10,
                 replicate_y_clamp_quirk=quirk)
    A = tc.max_window + 1
    yc = tdf.aperture_y_clip(tc)
    ins = [torch.from_numpy(a) for a in _flow_fields(W, H, seed=11)]
    grid = mesh.make_spatial_mesh_2d(1, 1)
    band = assemble_integral_tile(*ins, grid, A, yc)
    integ = tdf.build_integral(*ins)
    assert torch.equal(band[:, A:A + W + 1, A:A + yc + 1],
                       integ[:, :, :yc + 1])
    assert not band[:, :A + 1].any() and not band[:, :, :A + 1].any()
    assert torch.equal(band[:, A + W:, A:A + yc + 1],
                       integ[:, -1:, :yc + 1].expand(-1, A + 1, -1))
    assert torch.equal(band[:, :, A + yc:],
                       band[:, :, A + yc:A + yc + 1].expand(
                           -1, -1, H + A - yc + 1))
    got = tk.aperture(*ins, tc, halo=A, col_halo=A, integ=band)
    for g, w in zip(got, tk.aperture(*ins, tc)):
        assert torch.equal(g, w)


def test_spatial_mesh_checks_the_world():
    """Without a group the world is one rank: (1, 1) and (N, 1) = (1, 1)
    only (JAX: make_spatial_mesh_2d raises where the mesh needs more
    devices than exist)."""
    grid = mesh.make_spatial_mesh()
    assert (grid.tx, grid.ty, grid.x.size, grid.y.size) == (1, 1, 1, 1)
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        mesh.make_spatial_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="requested 2 ranks"):
        mesh.make_spatial_mesh(2)


def test_tile_arguments_are_checked():
    tc = TConfig(width=32, height=24, max_window=10)
    z = torch.zeros((8, 12))
    band = torch.zeros((4, 31, 35), dtype=torch.float64)
    with pytest.raises(ValueError, match="band"):
        tk.aperture(z, z, z, tc, col_halo=11)
    with pytest.raises(ValueError, match="halo"):
        tk.aperture(z, z, z, tc, halo=11, col_halo=5, integ=band)
    chain = torch.zeros((1, 12, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="support_radius"):
        tk.local_flow(chain, chain[0], TConfig(width=32, height=24,
                                               filter_size=5),
                      halo=4, row_offset=8, col_halo=1, col_offset=4)
    # plain and tile-mode shapes: a tile's outputs are its core cells
    out = tk.local_flow(chain, chain[0], TConfig(width=32, height=24),
                        halo=2, row_offset=8, col_halo=2, col_offset=4)
    assert all(o.shape == (8, 12) for o in out)
    out = tk.aperture(z, z, z, tc, halo=11, col_halo=11,
                      integ=torch.zeros((4, 31, 35), dtype=torch.float64))
    assert all(o.shape == (8, 12) for o in out)

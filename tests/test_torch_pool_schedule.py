"""The aperture pool kernel's slot schedule (csrc/aperture.cu), played on
the CPU.

The kernel cannot run here, so its index arithmetic is mirrored by a small
model: the tile rows it picks at launch for a count of SMs, and for each
block (a tile of tx x 32 pixels), each corner kind and each scale, which
integral cell every slot of the kind's shared-memory slab holds and which
strip of cells each step copies in. The model asserts that every corner a
pixel reads at a scale is served from a slot holding the cell
`dense_aperture` reads there, and that the strip copied for the next scale
(stored while other threads still pool this one) lands in no slot this
scale reads. A second test pools with the values so read, scans the
scales on the count and length fields alone and reads the vx and vy
fields only at the winning scale, as the kernel does, and holds the
outputs bitwise against `dense_aperture`.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import farms_tpu_torch
from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.ops import dense_flow as tdf

torch.set_num_threads(1)

_SRC = (Path(farms_tpu_torch.__file__).parent / "csrc" /
        "aperture.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


TY, TX_MIN, TX_MAX = _const("TY"), _const("TX_MIN"), _const("TX_MAX")
KINDS = [(k & 1, k >> 1) for k in range(4)]   # (low row, low column)
SMS = (132, 4, 1000)    # an H100's SMs; few (tall tiles); many (short)


def tile_rows(rows, Ha, n_sm):
    """tile_rows: the fewest even rows whose grid fits the SMs."""
    col_tiles = -(-Ha // TY)
    row_tiles = max(n_sm // col_tiles, 1)
    tx = -(-rows // row_tiles)
    return min(max(tx + (tx & 1), TX_MIN), TX_MAX)


def slabs(tx, jump):
    """slabs_for: the cells a rectangle gains a scale in each axis and
    each kind's torus extents."""
    jx, jy = (jump, jump) if jump < tx and jump <= 16 else (tx, 0)
    return jx, jy, tx + jx, (TY + jy + 7) // 8 * 8


def strip(si, tx, jump):
    """The cells (a, b) copied at scale si, counted from the rectangles'
    leading edges, as the kernel decodes a cell index: the whole
    rectangle at scale 0, then jx whole rows and jy columns of the
    others."""
    jx, jy, _, _ = slabs(tx, jump)
    if si == 0:
        e = np.arange(tx * TY)
        return e // TY, e % TY
    n1 = jx * TY
    e = np.arange(n1 + (tx - jx) * jy)
    q = e - n1
    a = np.where(e < n1, e // TY, jx + q // max(jy, 1))
    b = np.where(e < n1, e % TY, q % max(jy, 1))
    return a, b


def play(integ, rows, halo, Ha, y_clip, n_scales, jump, n_sm):
    """Plays every block's schedule. Returns the float64 (count, length)
    pairs each pixel reads at each corner kind and scale, [n_scales, 4,
    2, rows, Ha], after asserting each read against the cell the plain
    version reads and each strip against the slots in use."""
    integ = integ.numpy()
    x_hi = integ.shape[1] - 1
    tx = tile_rows(rows, Ha, n_sm)
    jx, jy, px, py = slabs(tx, jump)
    out = np.zeros((n_scales, 4, 2, rows, Ha))
    tr, tc = np.meshgrid(np.arange(tx), np.arange(TY), indexing="ij")
    for r0 in range(0, rows, tx):
        for c0 in range(0, Ha, TY):
            held = np.full((4, px, py), -1, np.int64)     # flat cell ids
            vals = np.full((4, px, py, 2), np.nan)

            def cursors(si):
                """(xh, xl, yh, yl) slots of scale si's first row/col."""
                return (si * jx % px, -si * jx % px, si * jy % py,
                        -si * jy % py)

            def copies(si):
                """(kind, slot x, slot y, clamped row, clamped col)."""
                s = si * jump
                a, b = strip(si, tx, jump)
                c = cursors(si)
                for k, (lo_x, lo_y) in enumerate(KINDS):
                    rx = a if lo_x else tx - 1 - a
                    ry = b if lo_y else TY - 1 - b
                    vx = (halo + r0 - s if lo_x else halo + r0 + s + 1) + rx
                    vy = (c0 - s if lo_y else c0 + s + 1) + ry
                    sx = (rx + c[1 if lo_x else 0]) % px
                    sy = (ry + c[3 if lo_y else 2]) % py
                    yield (k, sx, sy, np.clip(vx, 0, x_hi),
                           np.clip(vy, 0, y_clip))

            def apply(cs):
                for k, sx, sy, x, y in cs:
                    held[k, sx, sy] = x * (Ha + 1) + y
                    vals[k, sx, sy] = integ[:2, x, y].T

            apply(copies(0))
            for si in range(n_scales):
                s = si * jump
                c = cursors(si)
                pending = list(copies(si + 1)) if si + 1 < n_scales else []
                pr, pc = halo + r0 + tr, c0 + tc
                live = (r0 + tr < rows) & (c0 + tc < Ha)
                for k, (lo_x, lo_y) in enumerate(KINDS):
                    sx = (tr + c[1 if lo_x else 0]) % px
                    sy = (tc + c[3 if lo_y else 2]) % py
                    x = np.clip(pr - s if lo_x else pr + s + 1, 0, x_hi)
                    y = np.clip(pc - s if lo_y else pc + s + 1, 0, y_clip)
                    assert (held[k, sx, sy] == x * (Ha + 1) + y).all(), (
                        r0, c0, si, k)
                    read = np.zeros((px, py), bool)
                    read[sx, sy] = True
                    for kk, wx, wy, _, _ in pending:
                        if kk == k:
                            assert not read[wx, wy].any(), (r0, c0, si, k)
                    got = vals[k, sx, sy]
                    out[si, k, :, (r0 + tr)[live], (c0 + tc)[live]] = \
                        got[live]
                apply(pending)
    return out


def pool(integ, flow_vx, flow_vy, halo, y_clip, n_scales, jump, reads):
    """The kernel's pooling from the played reads: the scan on the count
    and length fields, then vx and vy at the winning scale's corners."""
    rows, Ha = flow_vx.shape
    best_ml = torch.full((rows, Ha), -1.0)
    best_safe = torch.ones((rows, Ha))
    best_s = torch.zeros((rows, Ha), dtype=torch.int64)
    one = torch.ones((rows, Ha))
    for si in range(n_scales):
        A, B, C, D = (torch.from_numpy(reads[si, k]) for k in range(4))
        cnt, length = (((A - B) - C) + D).to(torch.float32)
        has = cnt > 0.5
        safe = torch.where(has, cnt, one)
        ml = torch.where(has, length / safe, 0.0)
        better = ml > best_ml
        best_ml = torch.where(better, ml, best_ml)
        best_safe = torch.where(better, safe, best_safe)
        best_s = torch.where(better, si * jump, best_s)
    xi = integ.shape[1] - 1
    px = (torch.arange(rows) + halo)[:, None]
    py = torch.arange(Ha)[None, :]
    xh = torch.clamp(px + best_s + 1, 0, xi)
    xl = torch.clamp(px - best_s, 0, xi)
    yh = torch.clamp(py + best_s + 1, 0, y_clip)
    yl = torch.clamp(py - best_s, 0, y_clip)
    vel = integ[2:]
    box = (vel[:, xh, yh] - vel[:, xl, yh] - vel[:, xh, yl]
           + vel[:, xl, yl]).to(torch.float32)
    pooled = best_ml > 0
    return (torch.where(pooled, box[0] / best_safe, flow_vx),
            torch.where(pooled, box[1] / best_safe, flow_vy),
            torch.where(pooled, best_s, 0).to(torch.int32))


def _fields(W, H, seed, special=False):
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    fl = (rng.uniform(100, 3000, (W, H)) * mask).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (W, H))
    fvx = (fl * np.cos(ang)).astype(np.float32)
    fvy = (fl * np.sin(ang)).astype(np.float32)
    if special:    # inf and NaN in vx, at pixels with and without flow
        fvx[rng.random((W, H)) < 0.01] = np.inf
        fvx[rng.random((W, H)) < 0.01] = np.nan
    return [torch.from_numpy(a) for a in (fl, fvx, fvy)]


# (sensor W, H, y-clamp quirk, max_window, window_jump, padded arrays,
# band counts, inf/NaN in vx): sensors that are not multiples of the tile,
# the quirk with W > H and W < H, jumps at and past the tile's rows and
# past the carry limit (no cell carried), one scale and 21, padded arrays,
# bands of one row
GEOMETRIES = {
    "37x53": (37, 53, False, 50, 5, None, (), False),
    "quirk W>H": (60, 41, True, 50, 5, None, (), False),
    "quirk W<H": (41, 60, True, 50, 5, None, (), False),
    "jump 8": (37, 53, False, 64, 8, None, (), False),
    "jump 16": (100, 70, False, 64, 16, None, (), False),
    "jump 17": (100, 70, False, 68, 17, None, (), False),
    "jump 33": (70, 53, False, 66, 33, None, (), False),
    "max_window 0": (37, 53, False, 0, 5, None, (), False),
    "max_window 100": (37, 53, False, 100, 5, None, (), False),
    "padded": (60, 44, True, 50, 5, (64, 48), (), False),
    "bands 1, 2, 4": (37, 53, False, 50, 5, None, (1, 2, 4), False),
    "bands of one row": (5, 40, True, 20, 3, None, (5,), False),
    "inf and NaN in vx": (37, 53, False, 50, 5, None, (3,), True),
}


def _cases(key):
    """The geometry's whole-sensor call and its band calls: (label, cfg,
    integ, flow fields, halo), with the plain version's outputs."""
    W, H, quirk, mw, jump, pad, bands, special = GEOMETRIES[key]
    cfg = FlowConfig(width=W, height=H, replicate_y_clamp_quirk=quirk,
                     max_window=mw, window_jump=jump)
    if pad:
        cfg = dataclasses.replace(cfg, padded_width=pad[0],
                                  padded_height=pad[1])
    Wa = cfg.array_width
    ins = _fields(Wa, cfg.array_height, 3, special)
    integ = tdf.build_integral(*ins)
    whole = tdf.dense_aperture(*ins, cfg)
    out = [("whole", cfg, integ, ins, 0, whole)]
    A = cfg.max_window + 1
    full = torch.cat([integ.new_zeros((4, A, integ.shape[2])), integ,
                      integ[:, -1:].expand(-1, A, -1)], 1)
    for nb in bands:
        rows = Wa // nb
        for i in range(nb):
            end = Wa if i == nb - 1 else rows * (i + 1)
            band = full[:, rows * i:end + 2 * A + 1].contiguous()
            core = [a[rows * i:end] for a in ins]
            want = tdf.dense_aperture(*core, cfg, halo=A, integ=band)
            for w, o in zip(want, whole):    # the band mode's contract
                assert torch.equal(w.view(torch.int32),
                                   o[rows * i:end].view(torch.int32))
            out.append((f"band {i} of {nb}", cfg, band, core, A, want))
    return out


@pytest.mark.parametrize("n_sm", SMS)
@pytest.mark.parametrize("key", list(GEOMETRIES))
def test_pool_schedule_serves_every_corner_from_its_cell(key, n_sm):
    for label, cfg, integ, ins, halo, _ in _cases(key):
        rows, Ha = ins[0].shape
        reads = play(integ, rows, halo, Ha, tdf.aperture_y_clip(cfg),
                     cfg.num_scales, cfg.window_jump, n_sm)
        assert reads.shape[0] == cfg.num_scales, label


@pytest.mark.parametrize("n_sm", SMS)
@pytest.mark.parametrize("key", list(GEOMETRIES))
def test_pool_winner_read_equals_dense_aperture(key, n_sm):
    for label, cfg, integ, ins, halo, want in _cases(key):
        rows, Ha = ins[0].shape
        yc = tdf.aperture_y_clip(cfg)
        reads = play(integ, rows, halo, Ha, yc, cfg.num_scales,
                     cfg.window_jump, n_sm)
        got = pool(integ, ins[1], ins[2], halo, yc, cfg.num_scales,
                   cfg.window_jump, reads)
        for name, g, w in zip(("tvx", "tvy", "scale"), got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (
                label, name)


@pytest.mark.parametrize("tx", [TX_MIN, 10, 16, 26, TX_MAX])
def test_pool_strip_is_the_cells_a_scale_gains(tx):
    """Each scale's strip is jx rows at the leading edge and jy columns of
    the other rows (the whole rectangle at scale 0 and where no cell
    carries), each cell once; the torus holds two scales' rectangles."""
    for jump in (0, 1, 5, tx - 1, tx, 16, 17, TY, TY + 7):
        jx, jy, px, py = slabs(tx, jump)
        assert px >= tx + jx and py >= TY + jy and py % 8 == 0
        assert 4 * px * py * 16 <= 4 * 48 * 48 * 16    # SLAB_BYTES_MAX
        for si in (0, 1, 2):
            a, b = strip(si, tx, jump)
            cells = set(zip(a.tolist(), b.tolist()))
            assert len(cells) == len(a) <= tx * TY
            if si == 0 or jx == tx:
                want = {(i, j) for i in range(tx) for j in range(TY)}
            else:
                want = {(i, j) for i in range(tx) for j in range(TY)
                        if i < jx or j < jy}
            assert cells == want, (jump, si)


def test_pool_tile_rows_fit_the_sms():
    """One wave where the rows allow it: 26 rows (130 blocks) at 320 x
    320 on 132 SMs, 22 (132) at 260 x 346; short bands stop at TX_MIN."""
    assert tile_rows(320, 320, 132) == 26
    assert tile_rows(260, 346, 132) == 22
    assert tile_rows(80, 320, 132) == TX_MIN
    assert tile_rows(1280, 720, 132) == TX_MAX
    for rows, Ha in ((320, 320), (260, 346), (37, 53), (500, 640)):
        tx = tile_rows(rows, Ha, 132)
        assert tx % 2 == 0 and TX_MIN <= tx <= TX_MAX
        if TX_MIN < tx < TX_MAX:
            assert -(-rows // tx) * -(-Ha // TY) <= 132

"""Spatially sharded engine with explicit ring band exchanges.

Counterpart of `farms_tpu.parallel.halo` on torch.distributed: each rank
owns a contiguous band of `rows` sensor rows of every surface, and the two
stencil stages receive exactly the neighbour rows they need -

- the plane fit reads a `support_radius`-deep band of the time surfaces
  (`exchange_halo`: point-to-point ring hops), and
- the aperture stage reads a `max_window + 1`-deep band of the flow
  surfaces' integral image (`assemble_integral_band`: each rank integrates
  only its own rows and the band carries offset-corrected partials).

Zero bands past the global sensor edge reproduce the reference's window
clamping exactly (zero fields add nothing to box sums; stamp1 == 0 means
"never written"), so the kernels' halo modes (ops/kernels.py) need no
clamps on the x axis.

Every rank is fed the same chronological stream and packs it the same way
(HaloFlowEngine.pack_halo), so all ranks issue the same collectives in the
same order; rank 0 returns the FlowOutput. A run of one rank has no
process group: exchanges zero-pad and the band integral is built locally,
so every halo mode of every kernel runs on one card.

The shard step `_step` runs on a band group (`mesh.Axis`: the ranks that
split the rows), which is the whole world here and one line of the (tx,
ev) grid in parallel/multihost.py, and gathers the outputs of a window of
lanes: all of them here, an event shard's there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, FlowOutput
from farms_tpu_torch.ops import kernels
from farms_tpu_torch.ops.dense_flow import (aperture_y_clip, onehot_gather,
                                            tile_band, trig_tail)
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.pipeline.engine import (FlowEngine, _coarse,
                                             _empty_output, _lane_table,
                                             _merge_lanes, _phasing,
                                             _scatter, _take, lane_range,
                                             refuse_sparse, wire_maps,
                                             wire_n_main_rows, wire_pack)
from farms_tpu_torch.state.surfaces import (SurfaceState, kill_stale_flow,
                                            kill_stale_flow_in_phase)
from farms_tpu_torch.utils import tracing


def _ring(sends, recvs, band: mesh.Axis) -> None:
    """Post point-to-point sends [(tensor, dst)] and receives
    [(tensor, src)] (dst, src: indices on the band) as one batch in the
    band's group and wait for all of them."""
    ops = ([dist.P2POp(dist.isend, t, band.ranks[i], band.group)
            for t, i in sends]
           + [dist.P2POp(dist.irecv, t, band.ranks[i], band.group)
              for t, i in recvs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def exchange_halo(arr: torch.Tensor, h: int, band: mesh.Axis,
                  below: torch.Tensor | None = None,
                  dim: int = -2) -> torch.Tensor:
    """Extend a [..., rows, H] shard with h rows from each side of the ring
    of the band's n ranks (this one at index `rank` of them); with dim=-1
    a [..., X, cols] tile with h columns from the ring of its grid's y
    line (parallel/tiling.py exchanges the rows first, then the columns of
    the row-extended array, which carries the corners), zero past the
    edge.

    Returns [..., rows + 2h, H]; bands past the global sensor edge are
    zero above the sensor (index 0's top) and zero or, if given, `below`
    ([..., 1, H], broadcast) under it (index n-1's bottom). Both stencil
    stages read zero rows as "outside the sensor". A band deeper than a
    shard (h > rows) comes from several ring hops: hop j fetches the rows
    needed from the shard j ranks away. Hops that would cross the sensor
    edge are not sent at all (their rows are the fill), so no send wraps
    around the ring.
    """
    if h == 0:
        return arr
    if dim == -1:
        return exchange_halo(arr.transpose(-1, -2), h, band).transpose(
            -1, -2).contiguous()
    n, rank = band.size, band.index
    rows = arr.shape[-2]

    def fill(take, value):
        shape = (*arr.shape[:-2], take, arr.shape[-1])
        return (arr.new_zeros(shape) if value is None
                else value.expand(shape).contiguous())

    if n == 1:
        return torch.cat([fill(h, None), arr, fill(h, below)], -2)
    hops = -(-h // rows)
    above, under, sends, recvs = [], [], [], []
    for j in range(1, hops + 1):
        take = min(rows, h - (j - 1) * rows)
        # the bottom `take` rows of shard rank-j sit right above the band
        # assembled so far, the top `take` rows of rank+j right below it
        prev, nxt = fill(take, None), fill(take, below)
        if rank + j < n:
            sends.append((arr[..., rows - take:, :].contiguous(), rank + j))
            recvs.append((nxt, rank + j))
        if rank - j >= 0:
            sends.append((arr[..., :take, :].contiguous(), rank - j))
            recvs.append((prev, rank - j))
        above.insert(0, prev)
        under.append(nxt)
    _ring(sends, recvs, band)
    return torch.cat(above + [arr] + under, -2)


def assemble_integral_band(flow_len, flow_vx, flow_vy, band: mesh.Axis,
                           A: int) -> torch.Tensor:
    """The float64 global-integral band [4, rows + 2A + 1, Ha + 1] of this
    shard (JAX: integral partials, farms_tpu/parallel/halo.py:78).

    Box sums are linear, so no rank integrates another's rows:
    1. each rank builds the float64 prefix integral L of its own rows
       (kernels.integral, the whole-sensor engine's own op);
    2. the per-shard total rows (column sums, [4, Ha + 1]) are gathered
       from every rank, which gives each shard's offset C_k (the sum of the
       totals above it) and the sensor's total T;
    3. global integral rows row0 + 1 .. row0 + rows of this shard are
       C_k + L[1:]; the band is those rows with A + 1 more from each side
       of the ring (exchange_halo: 0 above the sensor, T below it, the
       reference's x clamp), less the last.
    With one rank the band is L between A zero rows and A copies of T:
    the whole-sensor integral's values exactly.
    """
    L = kernels.integral(flow_len, flow_vx, flow_vy)   # [4, rows + 1, Ha + 1]
    n, rank = band.size, band.index
    if n == 1:
        own, total = L[:, 1:], L[:, -1:]
    else:
        cols = L.shape[2]
        allcs = L.new_empty((n * 4, cols))
        dist.all_gather_into_tensor(allcs, L[:, -1].contiguous(),
                                    group=band.group)
        allcs = allcs.view(n, 4, cols)
        offset = torch.zeros_like(allcs[0])
        for k in range(n):                            # left fold, rank order
            if k == rank:
                own = offset[:, None, :] + L[:, 1:]
            offset = offset + allcs[k]
        total = offset[:, None, :]
    # the kernel reads the band as one contiguous float64 array
    return exchange_halo(own, A + 1, band, below=total)[:, :-1].contiguous()


def assemble_integral_tile(flow_len, flow_vx, flow_vy, grid: mesh.TileMesh,
                           A: int, y_clip: int) -> torch.Tensor:
    """The float64 global-integral band [4, rows + 2A + 1, cols + 2A + 1]
    of this rank's tile, pre-clamped in y: the values
    dense_flow.tile_band cuts from the whole integral.

    As in assemble_integral_band, no rank integrates another's cells:
    1. each rank builds the float64 prefix integral L of its own tile
       (kernels.integral);
    2. along y: the row totals L[:, :, -1] of the tiles to the left,
       gathered on the y line, turn L into the integral of this row
       band's strip up to each global column (M);
    3. along x: the bottom rows M[:, -1] of the strips above, gathered on
       the x line, turn M into the global integral of the tile's cells,
       and the sum of all of them is the sensor's total row T;
    4. the global rows and columns row0 + 1 .. row0 + rows, col0 + 1 ..
       col0 + cols take A + 1 more rows from each side of the x ring (0
       above the sensor, T below it), then A + 1 more columns from each
       side of the y ring (0 left of the sensor), less the last of each;
    5. the y pre-clamp: band columns past y_clip take column y_clip, from
       this band or, where the tile starts past y_clip + A (the
       reference's y-by-width quirk on a tall sensor), from its owner on
       the y line (one all-gather of one column).
    With one rank the band is cut from L, the whole-sensor integral,
    exactly.
    """
    L = kernels.integral(flow_len, flow_vx, flow_vy)  # [4, rows+1, cols+1]
    rows, cols = flow_len.shape
    xa, ya = grid.x, grid.y
    if xa.size == 1 and ya.size == 1:
        return tile_band(L, 0, rows, 0, cols, A, y_clip)

    def offsets(part, axis):
        """(sum of the parts before this rank on the axis, sum of all)."""
        parts = part.new_empty((axis.size * part.shape[0], part.shape[1]))
        dist.all_gather_into_tensor(parts, part.contiguous(),
                                    group=axis.group)
        parts = parts.view(axis.size, *part.shape)
        before = total = torch.zeros_like(part)
        for k in range(axis.size):                # left fold, axis order
            if k == axis.index:
                before = total
            total = total + parts[k]
        return before, total

    M = L
    if ya.size > 1:
        left, _ = offsets(L[:, :, -1], ya)
        M = L + left[:, :, None]
    if xa.size > 1:
        above, total = offsets(M[:, -1], xa)
        N = M + above[:, None, :]
    else:
        N, total = M, M[:, -1]
    band = exchange_halo(N[:, 1:, 1:], A + 1, xa,
                         below=total[:, None, 1:])[:, :-1]
    band = exchange_halo(band, A + 1, ya, dim=-1)[:, :, :-1]
    # the y pre-clamp: global column of band column c is col0 - A + c
    first = ya.index * cols - A
    nb = band.shape[2]
    if any(j * cols - A > y_clip for j in range(ya.size)):
        # a tile of the line starts past y_clip + A: every rank sends its
        # column nearest y_clip, and the owner's is taken
        parts = band.new_empty((ya.size * 4, band.shape[1]))
        dist.all_gather_into_tensor(
            parts, band[:, :, min(max(y_clip - first, 0), nb - 1)]
            .contiguous(), group=ya.group)
        col = parts.view(ya.size, 4, -1)[(y_clip - 1) // cols]
    elif y_clip - first < nb:
        col = band[:, :, y_clip - first]
    else:
        return band.contiguous()
    past = torch.arange(nb, device=band.device) + first > y_clip
    return torch.where(past, col[:, :, None], band).contiguous()


def _own(lanes: torch.Tensor, in_core: torch.Tensor) -> torch.Tensor:
    """Gathered [F, k] lanes, -0.0 where another shard owns the lane (the
    gather read a clamped row there): the identity of f32 addition, so a
    sum over ranks is the owner's value bit for bit, signed zeros
    included (a +0.0 fill would turn an owner's -0.0 into +0.0)."""
    return torch.where(in_core, lanes, -0.0)


def _local_fit(chain, center, cfg, row0, fold_center=True, col0=None):
    """The plane fit of one shard's band (kernel 1 or 2 in halo mode, or
    with a tile's first column `col0` in tile mode) and its trig tail:
    (vx, vy, gate, length) maps of the core cells."""
    R = cfg.support_radius
    acc, a, b, dtdp, _ = kernels.local_flow(
        chain, center, cfg, fold_center=fold_center, halo=R,
        row_offset=row0, col_halo=0 if col0 is None else R,
        col_offset=col0 or 0)
    vx, vy, gate, length, _ = trig_tail(acc, a, b, dtdp)
    return vx, vy, gate, length


def _corr_assemble(cfg: FlowConfig, chain_ext, t_c2, loc_maps, ap_tables,
                   rows, row0, lx, ys, in_core, cflag, grp, lane, head,
                   col0=None):
    """Sharded rank-2 correction pass + merged-table lane assembly.

    The shard-local form of micro_step's correction (JAX:
    farms_tpu/parallel/halo.py:146): the extra plane fit runs in halo and
    correction mode on the chunk's exchanged chain (pass 1's bands, no new
    collective) against this shard's rows of the host-built center
    surface, and every lane reads its plane-fit rows from its phase's
    table (`grp`), or the correction table where flagged, and its
    true-flow rows from its aperture pass's table (`lane`, the lanes'
    indices among the step's `head`). Off-shard lanes read a clamped row
    and are zeroed. In tile mode (`col0`: the tile's first column) the
    center surface is the tile's cells and `ys` its local columns,
    clamped. Returns the [5, k] f32 lane stack of the k lanes.
    """
    R = cfg.support_radius
    cols = t_c2.shape[1]
    # the center is read at the core cells only (correction mode does not
    # fold it): its halos are zeros
    ch = 0 if col0 is None else R
    vx2, vy2, gate2, _ = _local_fit(torch.stack(chain_ext),
                                    F.pad(t_c2, (ch, ch, R, R)), cfg, row0,
                                    fold_center=False, col0=col0)
    loc_all = loc_maps + [_lane_table(vx2, vy2, gate2, cfg, packed=False)]
    RH = rows * cols
    pix = (lx.clamp(0, rows - 1).to(torch.int64) * cols
           + ys.clamp(0, cols - 1).to(torch.int64))
    table = torch.where(cflag, len(loc_all) - 1, grp)
    loc = _own(_take(loc_all, table * RH + pix), in_core)
    tf = _own(_take(ap_tables, lane // (head // len(ap_tables)) * RH + pix),
              in_core)
    return _merge_lanes(loc, tf, cfg, packed=False)


def _step(state: SurfaceState, x, y, t, is_winner, cfg: FlowConfig,
          band: mesh.Axis, cflag=None, t_c2=None, bs: int = 0,
          lanes: tuple[int, int] | None = None,
          tile: mesh.TileMesh | None = None):
    """One micro-step of one shard on its band group (JAX:
    halo_micro_step :374 with bs = 0, halo_micro_step_sharded :201 with
    bs > 0), or with `tile` of one tile of a (tx, ty) grid (band: the
    tile's x line; parallel/tiling.py, JAX's spatial engine): every halo
    in both axes, each kernel in tile mode, bs = 0, and the lanes summed
    over the whole grid.

    x, y, t, is_winner are the step's lanes (int32, bool), cflag the
    corrected-lane flags (bool) when `t_c2` (this shard's rows of the
    rank-2 center surface) is given:
    - bs = 0, replicated: every rank gets all m lanes and gathers those
      of the window `lanes` = (lo, hi) (all by default); the outputs are
      summed over the band (each lane has one non-zero contribution, its
      owner's);
    - bs > 0, owner-sharded: this rank's own P*S sub-group segments of bs
      lanes plus a P-lane tail whose stamp row holds the global phase start
      stamps for the staleness kill; no sum, the lanes stay on their rank.
    Returns the new state and the wire pair (int32 [C, k], uint8 [k]).
    """
    rows = cfg.array_width // band.size
    row0 = band.index * rows
    R = cfg.support_radius
    A = cfg.max_window + 1
    if tile is None:
        cols, col0, summed = cfg.array_height, None, band
    else:
        cols = cfg.array_height // tile.ty
        col0, summed = tile.y.index * cols, tile.grid
    corr = t_c2 is not None
    if bs:
        P, S = cfg.sub_phases, cfg.causal_snapshots
        links = (S - 1,) if cfg.correction_coarse_chain else tuple(range(S))
        mp = ms = None
        head = P * S * bs
        t0s = t[head:]
    else:
        head = x.shape[0]
        P, S, links = _phasing(head, cfg)
        mp = head // P
        ms = mp // S
        t0s = t[::mp][:P]
    lo, hi = lanes or (0, head)
    coarse = _coarse(cfg, P)
    seg = S * bs if bs else mp          # lanes of one phase
    sub = bs if bs else ms              # lanes of one scatter sub-group
    # fine aperture groups per phase (micro_step's rule; replicated layout)
    kf = max(1, cfg.aperture_sub_phases // P) if cfg.aperture_sub_phases else 1
    if bs or seg % kf or corr:
        kf = 1
    mg = seg // kf

    t_surf, epoch = state.t_surf, state.epoch
    flow_len, flow_vx, flow_vy = state.flow_len, state.flow_vx, state.flow_vy
    lx = x - row0
    ly = y if col0 is None else y - col0
    in_core = (lx >= 0) & (lx < rows) & (ly >= 0) & (ly < cols)
    # local flat pixel per lane; non-winners and lanes of other shards go
    # to the spare cell rows*cols of the scatter buffers
    pix = lx.to(torch.int64) * cols + ly.to(torch.int64)
    wpix = torch.where(is_winner & in_core, pix, rows * cols)
    t1 = t + 1
    safe_lx = lx.clamp(0, rows - 1)
    safe_ly = ly.clamp(0, cols - 1)

    def ext(surf):
        """A surface with its R-deep halo: rows, then (tiles) columns."""
        surf = exchange_halo(surf, R, band)
        return surf if tile is None else exchange_halo(surf, R, tile.y,
                                                       dim=-1)

    def core(surf_ext):
        return surf_ext[R:R + rows, R:R + cols] if tile else (
            surf_ext[R:R + rows])

    # ---- pass 1: scatters and every time-surface band exchange, before
    # any stencil compute (the JAX package's order, which lets XLA overlap
    # phase p+1's exchange with phase p's compute). A phase's pre-scatter
    # band is the previous phase's post band: one exchange per sub-group.
    phases = []
    pre_ext = ext(t_surf)
    chain_ext = [pre_ext] if corr else None
    for p in range(P):
        ep_val = state.step * P + p
        mids = []
        for si in range(S):
            ssl = slice(p * seg + si * sub, p * seg + (si + 1) * sub)
            t_surf = _scatter(t_surf, wpix[ssl], t1[ssl])
            epoch = _scatter(epoch, wpix[ssl], ep_val)
            if si < S - 1:
                mids.append(ext(t_surf))
                if corr and si in links:
                    chain_ext.append(mids[-1])
        post_ext = ext(t_surf)
        if corr:                        # the last sub-group always links
            chain_ext.append(post_ext)
        phases.append((epoch == ep_val, pre_ext, mids, post_ext))
        pre_ext = post_ext

    # ---- pass 2: stencil compute per phase ----
    loc_maps, ap_tables, pending, lanes_out = [], [], [], []
    for p, (written, pre_ext, mids, post_ext) in enumerate(phases):
        # the phase's gathered lanes
        lsl = lane_range(slice(p * seg, (p + 1) * seg), (lo, hi))
        # staleness kill at aperture-group cadence, against the phase's
        # pre-scatter surface: the core rows of its pre band
        if not coarse or p % (P // coarse) == 0:
            flow_len = kill_stale_flow(flow_len, core(pre_ext), t0s[p], cfg)
        vx_map, vy_map, gate_map, len_map = _local_fit(
            torch.stack([pre_ext, *mids]), post_ext, cfg, row0, col0=col0)
        flow_len = torch.where(
            written, torch.where(gate_map, len_map, 0.0), flow_len)
        flow_vx = torch.where(
            written, torch.where(gate_map, vx_map, 0.0), flow_vx)
        flow_vy = torch.where(
            written, torch.where(gate_map, vy_map, 0.0), flow_vy)
        loc = _lane_table(vx_map, vy_map, gate_map, cfg, packed=False)
        if corr:
            # every lane is assembled after the correction pass
            loc_maps.append(loc)
        elif coarse and lsl:
            # this group's plane-fit lanes wait for their pooling pass
            pending.append((lsl, _own(onehot_gather(
                loc, safe_lx[lsl], safe_ly[lsl], rows, cols), in_core[lsl])))
        if coarse and (p + 1) % (P // coarse):
            continue
        for g in range(kf):
            if g:
                # fine phasing: the in-phase kill against the phase's
                # post-scatter surface, the core rows of its post band
                flow_len = kill_stale_flow_in_phase(
                    flow_len, core(post_ext), t[p * seg + g * mg], cfg)
            if tile is None:
                integ = assemble_integral_band(flow_len, flow_vx, flow_vy,
                                               band, A)
            else:
                integ = assemble_integral_tile(flow_len, flow_vx, flow_vy,
                                               tile, A, aperture_y_clip(cfg))
            tvx_map, tvy_map, scale_map = kernels.aperture(
                flow_len, flow_vx, flow_vy, cfg, halo=A, integ=integ,
                col_halo=0 if tile is None else A)
            if corr:
                ap_tables.append(_lane_table(tvx_map, tvy_map, scale_map,
                                             cfg, packed=False))
                continue
            if coarse:
                amaps = _lane_table(tvx_map, tvy_map, scale_map, cfg,
                                    packed=False)
                for gsl, gloc in pending:
                    tf = _own(onehot_gather(amaps, safe_lx[gsl],
                                            safe_ly[gsl], rows, cols),
                              in_core[gsl])
                    lanes_out.append(_merge_lanes(gloc, tf, cfg,
                                                  packed=False))
                pending = []
                continue
            gsl = lane_range(slice(p * seg + g * mg, p * seg + (g + 1) * mg),
                             (lo, hi))
            if gsl:
                # packed=False: these lanes are summed across ranks below,
                # and f32 arithmetic on packed f16-pair words is not
                # bit-preserving
                maps = wire_maps(gate_map, vx_map, vy_map, tvx_map, tvy_map,
                                 scale_map, cfg, packed=False)
                lanes_out.append(_own(onehot_gather(
                    maps, safe_lx[gsl], safe_ly[gsl], rows, cols),
                    in_core[gsl]))

    if corr:
        lane = torch.arange(lo, hi, device=x.device)
        out_lanes = _corr_assemble(cfg, chain_ext, t_c2, loc_maps, ap_tables,
                                   rows, row0, lx[lo:hi], ly[lo:hi],
                                   in_core[lo:hi], cflag[lo:hi],
                                   lane // seg, lane, head, col0)
    else:
        out_lanes = torch.cat(lanes_out, 1)
    k = hi - lo
    n = summed.size
    if not bs and n > 1:
        # one non-zero (NaN-scrubbed) contribution per lane: the sum is
        # exact. A reduce-scatter leaves each rank its 1/n of the lanes;
        # where n does not divide them every rank sums them all.
        if k % n == 0:
            part = out_lanes.new_empty((k // n, 5))
            dist.reduce_scatter_tensor(part, out_lanes.t().contiguous(),
                                       group=summed.group)
            out_lanes = part.t()
        else:
            dist.all_reduce(out_lanes, group=summed.group)
    out = wire_pack(out_lanes[0], out_lanes[1], out_lanes[2], out_lanes[3],
                    out_lanes[4], cfg)
    return SurfaceState(t_surf, epoch, flow_len, flow_vx, flow_vy,
                        state.step + 1), out


def gather_lanes(main: torch.Tensor, aux: torch.Tensor, axis: mesh.Axis,
                 to_all: bool = False):
    """One call's wire blocks (int32 [steps, C, k], uint8 [steps, k]) of
    every rank on `axis`, laid end to end along the lane axis in axis
    order, on the device: on the axis's first rank (None elsewhere), or
    with `to_all` on every rank."""
    if axis.size == 1:
        return main, aux
    block = torch.cat([main, aux.to(torch.int32)[:, None]], 1)
    if to_all:
        parts = [torch.empty_like(block) for _ in range(axis.size)]
        dist.all_gather(parts, block, group=axis.group)
    else:
        first = axis.index == 0
        parts = ([torch.empty_like(block) for _ in range(axis.size)]
                 if first else None)
        dist.gather(block, parts, dst=axis.ranks[0], group=axis.group)
        if not first:
            return None
    block = torch.cat(parts, 2)
    return block[:, :-1].contiguous(), block[:, -1].to(torch.uint8)


def gather_summed(main: torch.Tensor, aux: torch.Tensor, axis: mesh.Axis,
                  m: int):
    """One call's whole wire block of `_step`'s replicated lanes (bs = 0,
    m a step, summed over `axis`) on the axis's first rank (on the
    device), None elsewhere: the ranks' reduce-scatter slices end to end
    in rank order, or the first rank's own lanes where the all-reduce left
    every rank all of them (the axis does not divide m)."""
    if m % axis.size:
        return None if axis.index else (main, aux)
    return gather_lanes(main, aux, axis)


def band_of(state: SurfaceState, band: mesh.Axis,
            cfg: FlowConfig) -> SurfaceState:
    """This rank's rows of an array-geometry [W, Ha] state: band index i
    of the band's n ranks holds rows [i * W / n, (i + 1) * W / n)."""
    rows = cfg.array_width // band.size
    sl = slice(band.index * rows, (band.index + 1) * rows)
    return SurfaceState(*(a[sl].contiguous() for a in (
        state.t_surf, state.epoch, state.flow_len, state.flow_vx,
        state.flow_vy)), state.step)


def gather_bands(state: SurfaceState, band: mesh.Axis,
                 cfg: FlowConfig) -> SurfaceState | None:
    """The bands of every rank of `band` gathered on its first rank at the
    semantic [W, H] geometry (the padding stripped; pad cells are never
    written); None on the band's other ranks."""
    f32 = [a.view(torch.int32) for a in
           (state.flow_len, state.flow_vx, state.flow_vy)]
    block = torch.stack([state.t_surf, state.epoch, *f32])  # [5, rows, Ha]
    if band.size > 1:
        first = band.index == 0
        parts = ([torch.empty_like(block) for _ in range(band.size)]
                 if first else None)
        dist.gather(block, parts, dst=band.ranks[0], group=band.group)
        if not first:
            return None
        block = torch.cat(parts, 1)
    block = block[:, :cfg.width, :cfg.height].contiguous()
    return SurfaceState(block[0], block[1], block[2].view(torch.float32),
                        block[3].view(torch.float32),
                        block[4].view(torch.float32), state.step)


class HaloFlowEngine(FlowEngine):
    """FlowEngine sharded over the ranks of a torch.distributed group.

    Construct it in every rank of the group (parallel/mesh.py `run`), or in
    a process without a group for one rank. Each rank keeps its [rows, Ha]
    band of every surface on `device` (its own card under NCCL).
    """

    def __init__(self, cfg: FlowConfig, device="cuda"):
        if not cfg.use_dense:
            raise ValueError("halo sharding requires the dense compute path")
        if cfg.aperture_sub_phases > cfg.sub_phases:
            raise ValueError(
                "the halo engine supports aperture_sub_phases equal to or a "
                "divisor of sub_phases (coarse pooling); finer aperture "
                "phasing is a FlowEngine feature")
        self.band = mesh.Axis.world()
        self.rank, self.n_shards = self.band.index, self.band.size
        # the base constructor (the kernel build) sees the semantic
        # geometry; the shards hold the padded one: non-divisible widths
        # pad up, and the pad rows are never written
        super().__init__(cfg, device)
        n = self.n_shards
        self.cfg = cfg.padded_to(n)
        blk = cfg.chunk_size // (cfg.sub_phases * cfg.causal_snapshots)
        # owner-sharded sub-group segments: 2x slack plus a small constant
        # (binomial fluctuation dominates tiny sub-groups)
        self._bs = min(blk, 2 * -(-blk // n) + 4) if n > 1 else blk
        self.reset()

    def reset(self):
        super().reset()
        self.state = band_of(self.state, self.band, self.cfg)

    def set_state(self, state: SurfaceState) -> None:
        """Adopt a whole-sensor [W, H] state (a restored checkpoint): each
        surface is padded to the array geometry (pad rows as never
        written) and this rank keeps its band of rows."""
        super().set_state(state)
        self.state = band_of(self.state, self.band, self.cfg)

    def whole_state(self) -> SurfaceState | None:
        """The bands of every rank gathered on rank 0 at the semantic
        [W, H] geometry; None on the other ranks."""
        return gather_bands(self.state, self.band, self.cfg)

    # ---- host-side packing -------------------------------------------------
    def pack_halo(self, ev: EventBatch, steps_per_call: int | None = None):
        """The 5-row layout and its owner-shard reorder (JAX:
        HaloFlowEngine.pack, farms_tpu/parallel/halo.py:738).

        Returns (packed, n, perm, centers). packed is int32 [n_calls, spc,
        rows, m]: pack()'s 5-row layout of (x, y, t, lane_valid, winner)
        lanes (padded lanes x = y = 0, invalid, never winners), plus the
        corrected-lane flag row under correction; centers is then the
        int32 [n_calls, spc, array W, array H] rank-2 center surfaces
        (pack_r2), else None. With more than one rank, each scatter
        sub-group's lanes are reordered by owning row shard into bs-lane
        segments with 2x slack: packed becomes [n_calls, spc, n, rows,
        G*bs + P], a P-lane tail of global phase start stamps in the stamp
        row, and perm [n_calls, spc, n, G*bs] the source lane of each
        segment lane (-1 for padding). A sub-group that overflows its slack
        gives the replicated layout for the whole stream (perm None).
        """
        cfg = self.cfg
        packed, nn = self.pack(ev, steps_per_call=steps_per_call)
        centers = None
        if cfg.center_correction:
            fl, ctr = self.pack_r2(ev, steps_per_call=steps_per_call)
            packed = np.concatenate(
                [packed, fl[:, :, None, :].astype(np.int32)], axis=2)
            centers = self.array_centers(ctr)
        n = self.n_shards
        if n == 1:
            return packed, nn, None, centers
        n_calls, spc, n_rows, m = packed.shape
        G = cfg.sub_phases * cfg.causal_snapshots
        blk = m // G
        bs = self._bs
        mp = m // cfg.sub_phases
        rows = cfg.array_width // n
        owner = np.minimum(packed[:, :, 0, :] // rows, n - 1)
        # padded lanes sit at x = 0 and would all pile onto shard 0; they
        # never scatter and their outputs are discarded, so spread them
        # round-robin instead
        pad = packed[:, :, 3, :] == 0
        owner = np.where(pad, np.arange(m, dtype=np.int64) % n, owner)
        msh = G * bs + cfg.sub_phases
        shard_pack = np.zeros((n_calls, spc, n, n_rows, msh), np.int32)
        shard_pack[:, :, :, 2, G * bs:] = (
            packed[:, :, 2, ::mp][:, :, None, :cfg.sub_phases])
        perm = np.full((n_calls, spc, n, G * bs), -1, np.int64)
        for c in range(n_calls):
            for s in range(spc):
                for g in range(G):
                    lanes = np.arange(g * blk, (g + 1) * blk)
                    ow = owner[c, s, lanes]
                    for k in range(n):
                        src = lanes[ow == k]
                        if src.size > bs:
                            return packed, nn, None, centers
                        dst = np.arange(g * bs, g * bs + src.size)
                        shard_pack[c, s, k][:, dst] = packed[c, s][:, src]
                        perm[c, s, k, dst] = src
        return shard_pack, nn, perm, centers

    # ---- processing --------------------------------------------------------
    def process(self, ev: EventBatch,
                steps_per_call: int | None = None) -> FlowOutput | None:
        """Process an event stream (or a continuation of one) on every rank.

        Every rank must be given the same stream. Each uploads only its
        own lanes on the owner-sharded layout (all lanes on the replicated
        one) and its rows of the center surfaces; rank 0 gathers the wire
        outputs and returns the FlowOutput, the other ranks None.
        """
        refuse_sparse(self.cfg)
        if len(ev) == 0:
            return _empty_output() if self.rank == 0 else None
        nn, perm, calls = self._halo_calls(ev, steps_per_call)
        sharded = perm is not None
        blocks = [self._gather(*self._run_halo_call(call, sharded), sharded)
                  for call in calls]
        if self.rank:
            return None
        with tracing.span("halo.decode"):
            return self._unpack(blocks, ev, nn, perm)

    def process_resident(self, ev: EventBatch):
        """The halo engine's FlowEngine.process_resident: the whole stream
        (len(ev) > 0) as one call of pack_halo's layout, uploaded once
        (this rank's lanes and rows of the center surfaces). fn() runs
        every micro-step on every rank (call it on every rank) and returns
        this rank's wire lanes on the device."""
        spc = max(1, -(-len(ev) // self.cfg.chunk_size))
        _, perm, calls = self._halo_calls(ev, spc)
        call = next(calls)

        def fn():
            return self._run_halo_call(call, perm is not None)

        return fn, len(ev)

    def _halo_calls(self, ev: EventBatch, steps_per_call: int | None):
        """(n, perm, calls): pack_halo's stream, and a generator of each
        call's (this rank's batch int32 [spc, rows, lanes], its rows of
        the center surfaces or None) on the device.

        While a profiler records (utils/tracing.py), the pack is the span
        `halo.pack`, the layout vote `halo.vote` (on the host, the wait
        for the slowest rank's pack) and each call's copies `halo.upload`;
        `_run_halo_call`, `_gather` and process()'s decode are
        `halo.launch`, `halo.gather` and `halo.decode`."""
        cfg = self.cfg
        n, rank = self.n_shards, self.rank
        with tracing.span("halo.pack"):
            packed, nn, perm, centers = self.pack_halo(ev, steps_per_call)
        sharded = perm is not None
        if n > 1:
            # the layout is chosen from the stream alone; ranks that chose
            # differently would issue different collectives
            with tracing.span("halo.vote"):
                votes = torch.tensor([int(sharded)], device=self.device)
                dist.all_reduce(votes)
                agreed = int(votes)
            if agreed not in (0, n):
                raise RuntimeError(f"ranks disagree on the batch layout "
                                   f"({agreed} of {n} owner-sharded)")
        rows = cfg.array_width // n

        def calls():
            for c in range(packed.shape[0]):
                chunk = packed[c][:, rank] if sharded else packed[c]
                # each call's center surfaces travel with its own batch
                with tracing.span("halo.upload"):
                    call = (torch.from_numpy(np.ascontiguousarray(chunk)).to(
                        self.device), None if centers is None else
                        torch.from_numpy(np.ascontiguousarray(
                            centers[c][:, rank * rows:(rank + 1) * rows])).to(
                                self.device))
                yield call

        return nn, perm, calls()

    def _run_halo_call(self, call, sharded: bool):
        """One call's micro-steps on this rank: its wire lanes (int32
        [spc, C, k], uint8 [spc, k]) on the device."""
        chunk, t_c2 = call
        bs = self._bs if sharded else 0
        mains, auxs = [], []
        with tracing.span("halo.launch"):
            for i, b in enumerate(chunk):
                self.state, (main, aux) = _step(
                    self.state, b[0], b[1], b[2], b[4] != 0, self.cfg,
                    self.band, None if t_c2 is None else b[5] != 0,
                    None if t_c2 is None else t_c2[i], bs)
                mains.append(main)
                auxs.append(aux)
            return torch.stack(mains), torch.stack(auxs)

    def _gather(self, main: torch.Tensor, aux: torch.Tensor, sharded: bool):
        """One call's wire block on rank 0 (on the device), None elsewhere.

        Each rank holds its lanes of every step: its owner-sharded
        segments, in rank order along the lane axis, or the replicated
        layout's summed lanes (gather_summed)."""
        with tracing.span("halo.gather"):
            if sharded:
                return gather_lanes(main, aux, self.band)
            return gather_summed(main, aux, self.band, self.cfg.chunk_size)

    def _unpack(self, blocks, ev: EventBatch, nn: int, perm) -> FlowOutput:
        """Stream-order wire blocks from the gathered ones (JAX:
        HaloFlowEngine._unpack_outputs), reordered on the blocks' device,
        then the base decode."""
        if perm is None:
            return self._unpack_outputs(blocks, ev, nn)
        C = wire_n_main_rows(self.cfg)
        m = self.cfg.chunk_size
        out = []
        for c, (mo, ao) in enumerate(blocks):
            spc = mo.shape[0]
            p = torch.as_tensor(perm[c], device=mo.device)  # [spc, n, gbs]
            held = p >= 0
            # each segment lane's place in the call's stream-order lanes
            lane = (torch.arange(spc, device=mo.device)[:, None, None] * m
                    + p)[held]
            gm = mo.new_zeros((C, spc * m))
            gm[:, lane] = mo.reshape(spc, C, *p.shape[1:]).transpose(
                0, 1)[:, held]
            ga = ao.new_zeros(spc * m)
            ga[lane] = ao.reshape(p.shape)[held]
            out.append((gm.reshape(C, spc, m).transpose(0, 1), ga.reshape(
                spc, m)))
        return self._unpack_outputs(out, ev, nn)


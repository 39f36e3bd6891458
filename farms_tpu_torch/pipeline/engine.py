"""Chunked streaming flow engine, PyTorch main path.

Counterpart of `farms_tpu.pipeline.engine` for one device: the
replacement of the reference's per-event hot loop
(runFileCopy, vFlow.cpp:223-414). Events are processed in fixed-size
micro-batches (`micro_step`); the host resolves each scatter group's
winners and packs the events as delta-coded 4-byte words (compact2,
`pack2`), the device decodes them, scatters the winning stamps, fits the
local planes, updates the flow surfaces, pools the aperture scales and
gathers the per-event results into the wire format, which
`kernels.decode_wire` decodes into the 11 output columns (on the card on
a CUDA engine, with `decode_wire_columns` on a CPU engine). The sparse
wire (`wire="sparse"`) compacts each call's output on the device to the
lanes that carry flow (`_sparse_pack_outputs`); `process_resident` runs a
whole stream as one uploaded call of the explicit 5-row layout, for timing.
Every engine runs the one micro-step here, looped by `scan_chunk`, over
its shard (`Sensor`: the whole sensor; parallel/halo.py's `Band` and
`Tile`: a row band and a tile of it).

Sequential-semantics note: the reference is strictly event-serial. A
micro-batch instead scatters its events first, then computes every flow
against a causal view of that surface, so the residual error is bounded by
the micro-batch's time span; chunk_size=1 reproduces the reference, which
the tests check against the float64 oracle (pipeline/oracle.py).
"""
from __future__ import annotations

import numpy as np
import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, FlowOutput
from farms_tpu_torch.ops import _build, kernels
from farms_tpu_torch.ops.aperture import aperture_batch, build_integral
# decode_wire_columns: this module's name for it in the JAX package
from farms_tpu_torch.ops.dense_flow import (decode_wire_columns,  # noqa: F401
                                            onehot_gather, trig_tail)
from farms_tpu_torch.ops.local_flow import local_flow_batch
from farms_tpu_torch.state.surfaces import (SurfaceState, init_state,
                                            kill_stale_flow,
                                            kill_stale_flow_in_phase,
                                            pad_state, strip_state)
from farms_tpu_torch.utils import nativeio, tracing

# compact2 escape slots per micro-step: stamp deltas too large for the
# word's field ride as exact (lane, delta) pairs
_C2_ESCAPES = 16

# events a host->device call holds where the caller does not size calls
# (farms_tpu/pipeline/engine.py:1148): a chunk this large runs one
# micro-step a call, so a stream's last call pads at most one step
_CALL_EVENTS = 131072

# the compact layout keeps the winner flag in bit 30 of the flat pixel
# index: a sensor of this many pixels or more packs the 5-row layout
_COMPACT_PIXELS = 1 << 30

# lanes of the sparse wire's payload that ride the aux buffer
# (_sparse_pack_outputs)
_SPARSE_RIDER_LANES = 65536


def call_steps(cfg: FlowConfig, steps_per_call: int | None = None) -> int:
    """Micro-steps per host->device call: `steps_per_call` where given,
    else steps_per_scan capped at the steps that hold _CALL_EVENTS events
    (farms_tpu/pipeline/engine.py:1161-1170). Every packer sizes its calls
    here, so process() and a direct pack agree."""
    if steps_per_call:
        return steps_per_call
    return max(1, min(cfg.steps_per_scan, -(-_CALL_EVENTS // cfg.chunk_size)))


def compact2_bits(cfg: FlowConfig) -> tuple[int, int]:
    """(index_bits, delta_bits) of the compact2 word for this sensor."""
    idx_bits = (cfg.width * cfg.height).bit_length()
    return idx_bits, 31 - idx_bits


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2^32 into int32 (two's complement)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# --------------------------------------------------------------------------
# device->host wire format: the 4 flow components plus one aux byte (valid
# flag in bit 7, scale id in bits 0-6); the magnitude/angle columns
# (vFlow.cpp:370-396) are derived from it (decode_wire_columns, or on the
# card the decode_wire kernel).
# --------------------------------------------------------------------------

def _f16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pack two f32 tensors into one int32 tensor of f16 bit-halves
    (a in the low half). Saturating: clipped to the f16 finite range so the
    host never decodes a spurious inf; NaN propagates."""
    pair = torch.stack([torch.clamp(a, -65504.0, 65504.0).half(),
                        torch.clamp(b, -65504.0, 65504.0).half()], -1)
    return pair.view(torch.int32).squeeze(-1)


def wire_pack(vx, vy, tvx_g, tvy_g, aux_f, cfg: FlowConfig):
    """Pack per-lane outputs into (main int32 [C, m], aux uint8 [m]).

    `tvx_g`/`tvy_g` are the true-flow components pre-gated to 0 on invalid
    lanes; `aux_f` is the aux byte as f32 (128 * valid + scale_id).
    """
    aux = aux_f.to(torch.uint8)
    if cfg.wire != "f32":
        main = torch.stack([_f16_pair(vx, vy), _f16_pair(tvx_g, tvy_g)], 0)
    else:
        main = torch.stack([vx, vy, tvx_g, tvy_g], 0).view(torch.int32)
    return main, aux


def wire_n_main_rows(cfg: FlowConfig) -> int:
    return 4 if cfg.wire == "f32" else 2


def _decode_batch(batch: dict, cfg: FlowConfig):
    """(x, y, t, is_winner) int32/bool lanes of a packed micro-step.

    compact2 ("ev" int32 [1, m] words, "base" the step's first stamp,
    "esc" int32 [2, E] (lane, delta) escape pairs): bits 0..ib-1 flat pixel
    index (sentinel W*H on padded lanes), bit ib the host-resolved winner
    flag, the upper bits the unsigned stamp delta to the previous lane;
    every lane at or past an escape lane re-adds that escape's delta.
    compact ("ev" int32 [2, m]): flat index | winner << 30, stamp.
    5-row ("ev" int32 [5, m]): x, y, t, lane_valid, winner; a padded lane
    (lane_valid 0, packed at x = y = 0) decodes to the compact layout's
    sentinel pixel (x = W, y = 0), so it cannot reach pixel (0, 0).
    """
    ev = batch["ev"]
    H = cfg.height
    if ev.shape[0] == 5:
        valid = ev[3] != 0
        return (torch.where(valid, ev[0], cfg.width),
                torch.where(valid, ev[1], 0), ev[2], ev[4] != 0)
    if "base" in batch:
        word = ev[0]
        esc_l, esc_d = batch["esc"][0], batch["esc"][1]
        ib, db = compact2_bits(cfg)
        is_winner = ((word >> ib) & 1).to(torch.bool)
        dt = (word >> (ib + 1)) & ((1 << db) - 1)
        # int64 sums reduced mod 2^32: the stamps wrap past 2^31
        t = batch["base"].to(torch.int64) + torch.cumsum(dt, 0,
                                                         dtype=torch.int64)
        lane = torch.arange(word.shape[0], device=word.device)
        t = t + torch.where(lane[None, :] >= esc_l[:, None],
                            esc_d[:, None].to(torch.int64), 0).sum(0)
        t = _wrap_i32(t)
        xy = word & ((1 << ib) - 1)
    else:
        word, t = ev[0], ev[1]
        is_winner = ((word >> 30) & 1).to(torch.bool)
        xy = word & 0x3FFFFFFF
    x = xy // H
    y = xy - x * H
    return x, y, t, is_winner


def _scatter(surf: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """A copy of the [W, H] `surf` with flat cells `idx` set to `values`
    (W, H its own extent: the array geometry, or a shard's band).

    The scatter goes into a flat [W*H + 1] buffer whose spare cell absorbs
    the sentinel index W*H of non-winner and padded lanes; real indices
    are unique (host-resolved winners, vFlow.cpp:264-273).
    """
    W, H = surf.shape
    flat = torch.cat([surf.reshape(-1), surf.new_zeros(1)])
    flat[idx] = values
    return flat[:W * H].view(W, H)


def _scrub(a: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)


def _take(tables: list, idx: torch.Tensor) -> torch.Tensor:
    """One flat gather from [F, W, H] tables laid end to end: idx =
    table * W*H + pixel. A spare zero column takes the padded lanes'
    sentinel pixel W*H of the last table."""
    F_ = tables[0].shape[0]
    flat = torch.cat([t.reshape(F_, -1) for t in tables]
                     + [tables[0].new_zeros((F_, 1))], 1)
    return flat[:, idx]


def _phasing(m: int, cfg: FlowConfig) -> tuple[int, int, tuple]:
    """Scatter groups of an m-lane micro-step: P phases (1 where
    sub_phases does not divide m), S snapshot sub-groups per phase (1
    where causal_snapshots does not divide a phase), and the sub-groups
    whose end surface joins the correction pass's chunk chain (the
    phase's last on the coarse chain, every one on the full chain)."""
    P = cfg.sub_phases if m % cfg.sub_phases == 0 else 1
    S = cfg.causal_snapshots if (m // P) % cfg.causal_snapshots == 0 else 1
    links = (S - 1,) if cfg.correction_coarse_chain else tuple(range(S))
    return P, S, links


def lane_range(sl: slice, lanes: tuple[int, int]) -> slice | None:
    """The lanes of `sl` that lie in the window [lo, hi), or None."""
    start, stop = max(sl.start, lanes[0]), min(sl.stop, lanes[1])
    return slice(start, stop) if start < stop else None


def _coarse(cfg: FlowConfig, P: int) -> int:
    """Aperture groups of a P-phase micro-step under coarse pooling (A < P
    aperture phases dividing P), else 0."""
    A = cfg.aperture_sub_phases
    return A if A and A < P and P % A == 0 else 0


class _LaneRows:
    """The per-pixel rows a micro-step gathers for its lanes, and the wire
    pair they become.

    On the f16 wire each component pair is packed at map level into one
    f16-pair word (viewed as f32, so one gather moves every row): the
    same wire bytes as packing after the gather. Lanes summed across
    ranks keep f32 rows and are packed after the sum, since f32
    arithmetic on packed f16-pair words is not bit-preserving; so are the
    f32 wire's lanes and the per-event phases'. This is the one place
    that decides. Non-finite components are scrubbed (they arise only
    with min_evts_on_plane <= 0).
    """

    def __init__(self, cfg: FlowConfig, summed: bool):
        self.cfg = cfg
        self.packed = cfg.wire != "f32" and cfg.use_dense and not summed

    def table(self, a, b, last) -> torch.Tensor:
        """A [F, W, H] table: the component maps a, b as one f16 pair (f32
        bits) or two f32 rows, then `last` as f32. The plane fit's table
        is (vx, vy, gate), the aperture's (true_vx, true_vy, scale),
        ungated."""
        last = last.to(torch.float32)
        if self.packed:
            pair = _f16_pair(_scrub(a), _scrub(b)).view(torch.float32)
            return torch.stack([pair, last])
        return torch.stack([_scrub(a), _scrub(b), last])

    def merge(self, loc: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
        """Wire lanes from gathered plane-fit rows `loc` and aperture rows
        `tf` (table rows): the true flow and the aux byte (128 + scale id)
        are gated by the plane fit's validity. A zero f32 pattern is the
        f16 pair (0, 0), so the gating is bit-exact on either wire."""
        gate = loc[-1] != 0
        aux_f = torch.where(gate, 128 + tf[-1] // self.cfg.window_jump, 0.0)
        if self.packed:
            return torch.stack([loc[0], torch.where(gate, tf[0], 0.0), aux_f])
        return torch.stack([loc[0], loc[1], torch.where(gate, tf[0], 0.0),
                            torch.where(gate, tf[1], 0.0), aux_f])

    def maps(self, gate_map, vx_map, vy_map, tvx_map, tvy_map, scale_map):
        """The dense maps of every wire row: packed [3, W, H] (the two f16
        pairs, the aux byte value), else [5, W, H] f32 (vx, vy, gated
        true_vx, gated true_vy, aux byte value)."""
        aux_f = torch.where(gate_map, 128 + scale_map // self.cfg.window_jump,
                            0).to(torch.float32)
        tvx_g = torch.where(gate_map, tvx_map, 0.0)
        tvy_g = torch.where(gate_map, tvy_map, 0.0)
        if self.packed:
            p0 = _f16_pair(_scrub(vx_map), _scrub(vy_map)).view(torch.float32)
            p1 = _f16_pair(_scrub(tvx_g), _scrub(tvy_g)).view(torch.float32)
            return torch.stack([p0, p1, aux_f], 0)
        maps = _scrub(torch.stack([vx_map, vy_map, tvx_g, tvy_g], 0))
        return torch.cat([maps, aux_f[None]], 0)

    def wire(self, rows: torch.Tensor):
        """The wire pair (int32 [C, k], uint8 [k]) of [F, k] lane rows."""
        if self.packed:
            return rows[:2].view(torch.int32), rows[2].to(torch.uint8)
        return wire_pack(rows[0], rows[1], rows[2], rows[3], rows[4],
                         self.cfg)


class Sensor:
    """The shard of the sensor that a micro-step runs on: by default the
    whole sensor; parallel/halo.py's `Band` and `Tile` are a row band and
    a tile of it on a group of ranks. A shard owns what differs between
    them: its core extent (rows, cols), the time surfaces' support halo,
    the plane-fit and pooling calls, and whether the lanes are summed
    across ranks. The whole sensor has no halo and sums nothing.
    """

    bs = 0           # lanes of an owner-sharded segment (Band), 0: none
    summed = None    # the mesh.Axis over whose ranks the lanes are summed

    def __init__(self, cfg: FlowConfig):
        self.cfg = cfg
        self.rows, self.cols = cfg.array_width, cfg.array_height

    def lanes(self, x, y, is_winner):
        """(gx, gy, pix, wpix, in_core) of a step's lanes: the cell whose
        outputs a lane gathers, its flat index, the flat index a winner
        scatters to (the others go to the spare cell rows * cols, which
        nothing reads), and the lanes this shard owns (None: all)."""
        pix = x.to(torch.int64) * self.cols + y.to(torch.int64)
        return x, y, pix, torch.where(is_winner, pix,
                                      self.rows * self.cols), None

    def ext(self, surf: torch.Tensor) -> torch.Tensor:
        """A time surface with the plane fit's support halo."""
        return surf

    def core(self, surf_ext: torch.Tensor) -> torch.Tensor:
        """The shard's own cells of an ext() surface."""
        return surf_ext

    def fit(self, chain, center, fold_center: bool = True):
        """kernels.local_flow over ext() surfaces; in correction mode
        (fold_center False) `center` is the shard's own cells."""
        return kernels.local_flow(chain, center, self.cfg, fold_center)

    def pool(self, flow_len, flow_vx, flow_vy):
        """kernels.aperture over the shard's flow surfaces."""
        return kernels.aperture(flow_len, flow_vx, flow_vy, self.cfg)

    def own(self, rows: torch.Tensor, in_core, sl: slice) -> torch.Tensor:
        """Gathered [F, k] rows of the lanes `sl`, as the sum over
        `summed` takes them."""
        return rows

    def sum(self, rows: torch.Tensor) -> torch.Tensor:
        """[F, k] lane rows summed over `summed`."""
        return rows


def micro_step(state: SurfaceState, batch: dict, cfg: FlowConfig,
               lanes: tuple[int, int] | None = None,
               shard: Sensor | None = None):
    """Process one micro-batch of events against the carried surfaces.

    `batch` is the dict of one packed micro-step (see _decode_batch), with
    the correction pass's "r2f" [m] corrected-lane flags and "r2c" int32
    stamp1 center surface (FlowEngine.pack_r2; the shard's cells of it),
    and "step", state.step on the device as an int32 0-d tensor
    (scan_chunk's step vector): the phases' write epochs are computed
    from it on the card, so the step copies nothing from the host and a
    captured CUDA graph reads the step's number from device memory.
    Returns the new state and the wire pair (int32 [C, k], uint8 [k]); the
    state passed in is not modified. Every lane scatters; `lanes` = (lo,
    hi) is the window of lanes whose outputs are gathered, k = hi - lo
    (all by default): an event-parallel rank's shard (parallel/dp.py).

    `shard` is the part of the sensor the state holds (Sensor: the whole
    sensor by default; parallel/halo.py: a row band or a tile, whose
    engines build it from their mesh). Its surfaces are at the config's
    array geometry: a padded config's pad cells are never written, and
    its lanes' flat indices (semantic x * H + y in the batch) address the
    array's x * Ha + y. On an owner-sharded band (shard.bs > 0) the batch
    holds this rank's P*S sub-group segments of bs lanes, then P lanes
    whose stamps start the phases.

    The chunk's lanes run as cfg.sub_phases = P chronological groups in
    turn: each group's winners are scattered and its flows computed against
    the surfaces every earlier group left, and the staleness kill re-runs
    at each group's start. All phases' scatters (and a shard's halo
    exchanges) come first, then the stencils: every rank of a band group
    issues the same collectives in the same order. Fidelity features
    (farms_tpu.config):

    - causal_snapshots S > 1: a phase scatters as S chronological
      sub-groups and the plane fit folds its causal view over every
      boundary surface (one local-flow pass per phase);
    - aperture_sub_phases A < P, a divisor (coarse): pooling runs once per
      P / A phases, the kill only at those groups' starts, and the
      plane-fit lanes wait for their pooling pass; A > P (fine): A / P
      pooling passes per phase, the later ones after the in-phase kill
      (kill_stale_flow_in_phase);
    - center_correction: one more local-flow pass per chunk, in correction
      mode, fits each flagged rank-2 lane at its own stamp against the
      chunk's chain, and every lane is assembled at the end from merged
      plane-fit and aperture tables.

    With cfg.use_dense False (the whole sensor only) a phase runs the
    per-event formulation instead (ops/local_flow.py, ops/aperture.py):
    each lane gathers its own support and pools its own windows, and only
    the phase's winners write the flow surfaces. It has none of the
    features above but the phases.
    """
    shard = shard or Sensor(cfg)
    x, y, t, is_winner = _decode_batch(batch, cfg)
    r2f, r2c = batch.get("r2f"), batch.get("r2c")
    corr = cfg.center_correction > 0 and r2f is not None and r2c is not None
    # an owner-sharded batch ends in the P lanes of phase start stamps
    head = x.shape[0] - (cfg.sub_phases if shard.bs else 0)
    P, S, links = _phasing(head, cfg)
    seg = head // P                     # lanes of one phase
    sub = seg // S                      # lanes of one scatter sub-group
    lo, hi = lanes or (0, head)
    A = cfg.aperture_sub_phases
    coarse = _coarse(cfg, P) if cfg.use_dense else 0
    # fine aperture groups per phase; a count that does not divide the
    # phase would drop its trailing lanes, and correction and the
    # owner-sharded layout forbid it
    kf = max(1, A // P) if A else 1
    if shard.bs or seg % kf or corr:
        kf = 1
    mg = seg // kf
    rows_of = _LaneRows(cfg, shard.summed is not None)
    gx, gy, pix, wpix, in_core = shard.lanes(x, y, is_winner)
    t1 = t + 1                                  # stamp1 encoding

    def gather(maps, sl):
        return shard.own(onehot_gather(maps, gx[sl], gy[sl], shard.rows,
                                       shard.cols), in_core, sl)

    # ---- pass 1: every phase's scatters of the winners' stamp1 as S
    # chronological sub-groups, keeping each boundary surface (with its
    # halo) for the causal fold; a phase's pre-scatter surface is the
    # previous phase's post one ----
    t_surf, epoch = state.t_surf, state.epoch
    ep0 = batch["step"] * P                 # phase 0's write epoch
    pre = shard.ext(t_surf)
    chunk_chain = [pre] if corr else None
    phases = []
    for p in range(P):
        surfs = []
        for si in range(S):
            ssl = slice(p * seg + si * sub, p * seg + (si + 1) * sub)
            t_surf = _scatter(t_surf, wpix[ssl], t1[ssl])
            surfs.append(shard.ext(t_surf))
        if corr:
            chunk_chain += [surfs[si] for si in links]
        # the phase's write epoch step * P + p (unique, monotone), one
        # scatter for all S sub-groups: every write of the phase carries
        # the same value, so `written` holds each pixel a winner wrote,
        # equal-stamp rewrites included (t_surf != t_pre misses those)
        ep = ep0 + p if p else ep0
        epoch = _scatter(epoch, wpix[p * seg:(p + 1) * seg], ep)
        phases.append((pre, surfs, epoch == ep if cfg.use_dense else None))
        pre = surfs[-1]

    # ---- pass 2: the stencils, phase by phase ----
    flow_len, flow_vx, flow_vy = state.flow_len, state.flow_vx, state.flow_vy
    loc_maps, ap_tables, pending, lanes_out = [], [], [], []
    for p, (pre, surfs, written) in enumerate(phases):
        sl = slice(p * seg, (p + 1) * seg)
        osl = lane_range(sl, (lo, hi))    # this phase's gathered lanes
        post = surfs[-1]

        # ---- permanent staleness kill (exact; see state/surfaces.py)
        # against the phase's pre-scatter surface; with coarse pooling
        # only at aperture-group starts: flow_len feeds pooling alone, and
        # an earlier kill would erase the group's temporal neighborhood
        # before its pooling pass ----
        if not coarse or p % (P // coarse) == 0:
            flow_len = kill_stale_flow(
                flow_len, shard.core(pre),
                t[head + p] if shard.bs else t[sl.start], cfg)
        if not cfg.use_dense:
            plane, flow_len, flow_vx, flow_vy = _perevent_phase(
                pre, post, flow_len, flow_vx, flow_vy, x[sl], y[sl], t1[sl],
                wpix[sl], cfg)
            if osl:
                lanes_out.append(plane[:, osl.start - sl.start:
                                       osl.stop - sl.start])
            continue

        # ---- local plane fit (kernel 1 or 2) and its trig tail ----
        chain = torch.stack([pre, *surfs[:-1]]) if S > 1 else pre[None]
        vx_map, vy_map, gate_map, len_map, _ = trig_tail(
            *shard.fit(chain, post)[:4])

        # flow-surface writes for every pixel written this group
        # (vFlow.cpp:349-356 valid / 398-402 invalid)
        flow_len = torch.where(
            written, torch.where(gate_map, len_map, 0.0), flow_len)
        flow_vx = torch.where(
            written, torch.where(gate_map, vx_map, 0.0), flow_vx)
        flow_vy = torch.where(
            written, torch.where(gate_map, vy_map, 0.0), flow_vy)

        # ---- multi-scale aperture pooling (kernel 3) ----
        if corr:
            # every lane is assembled after the correction pass
            loc_maps.append(rows_of.table(vx_map, vy_map, gate_map))
        elif coarse and osl:
            # the plane-fit lanes wait for their group's pooling pass
            pending.append((osl, gather(rows_of.table(vx_map, vy_map,
                                                      gate_map), osl)))
        if coarse and (p + 1) % (P // coarse):
            continue
        for g in range(kf):
            if g:
                # fine phasing: the in-phase kill against the phase's
                # post-scatter surface
                flow_len = kill_stale_flow_in_phase(
                    flow_len, shard.core(post), t[sl.start + g * mg], cfg)
            tvx_map, tvy_map, scale_map = shard.pool(flow_len, flow_vx,
                                                     flow_vy)
            if corr:
                ap_tables.append(rows_of.table(tvx_map, tvy_map, scale_map))
            elif coarse:
                amaps = rows_of.table(tvx_map, tvy_map, scale_map)
                for gsl, gloc in pending:
                    lanes_out.append(rows_of.merge(gloc, gather(amaps, gsl)))
                pending = []
            else:
                gsl = lane_range(slice(sl.start + g * mg,
                                       sl.start + (g + 1) * mg), (lo, hi))
                if gsl:
                    lanes_out.append(gather(rows_of.maps(
                        gate_map, vx_map, vy_map, tvx_map, tvy_map,
                        scale_map), gsl))

    if corr:
        # ---- rank-2 center correction: one local-flow pass per chunk in
        # correction mode, each flagged lane fitted at its own stamp
        # (r2c) against the chunk's chain; then one flat gather per table
        # set: a lane reads its plane-fit rows from its phase's table, or
        # from the correction pass's where flagged, and its true-flow rows
        # from its aperture pass's table ----
        vx2, vy2, gate2, _, _ = trig_tail(*shard.fit(
            torch.stack(chunk_chain), r2c, fold_center=False)[:4])
        loc_maps.append(rows_of.table(vx2, vy2, gate2))
        lane = torch.arange(lo, hi, device=x.device)
        table = torch.where(r2f[lo:hi] != 0, len(loc_maps) - 1, lane // seg)
        cells = shard.rows * shard.cols
        held = slice(lo, hi)
        loc = shard.own(_take(loc_maps, table * cells + pix[held]), in_core,
                        held)
        tf = shard.own(_take(ap_tables, lane // (head // len(ap_tables))
                             * cells + pix[held]), in_core, held)
        rows = rows_of.merge(loc, tf)
    else:
        rows = torch.cat(lanes_out, 1)
    new_state = SurfaceState(t_surf, epoch, flow_len, flow_vx, flow_vy,
                             state.step + 1)
    return new_state, rows_of.wire(shard.sum(rows))


def _perevent_phase(t_pre, t_surf, flow_len, flow_vx, flow_vy, xs, ys, t1s,
                    wpix, cfg: FlowConfig):
    """One phase of the per-event formulation (farms_tpu/pipeline/
    engine.py:559-586): each lane's plane fit against the causal view of
    the phase's pre- and post-scatter surfaces, the winners' flow writes
    (vFlow.cpp:349-356 valid / 398-402 invalid; `wpix` sends the other
    lanes to the spare cell), then each lane's aperture pooling over the
    float64 integral of the written surfaces. Returns the [5, mp] f32 wire
    lanes (vx, vy, gated true_vx, gated true_vy, aux byte value) and the
    new flow surfaces."""
    vx, vy, gate, length, _ = local_flow_batch(t_pre, t_surf, xs, ys, t1s,
                                               cfg)
    flow_len = _scatter(flow_len, wpix, torch.where(gate, length, 0.0))
    flow_vx = _scatter(flow_vx, wpix, torch.where(gate, vx, 0.0))
    flow_vy = _scatter(flow_vy, wpix, torch.where(gate, vy, 0.0))
    tvx, tvy, scale = aperture_batch(
        build_integral(flow_len, flow_vx, flow_vy), flow_vx, flow_vy, xs, ys,
        cfg)
    aux_f = torch.where(gate, 128 + scale // cfg.window_jump,
                        0).to(torch.float32)
    lanes = torch.stack([vx, vy, torch.where(gate, tvx, 0.0),
                         torch.where(gate, tvy, 0.0), aux_f])
    return lanes, flow_len, flow_vx, flow_vy


def _sparse_pack_outputs(main: torch.Tensor, aux: torch.Tensor):
    """A call's f16 wire blocks (int32 [steps, 2, m], uint8 [steps, m]) as
    the sparse wire (farms_tpu/pipeline/engine.py:691): (aux_plus uint8
    [N + 8 + 4 R], pay int32 [2 N]), N = steps * m, R = min(
    _SPARSE_RIDER_LANES, 2 N).

    The aux byte stays dense (valid bit 7, scale id bits 0-5) and gains
    bit 6 where the lane's raw vx/vy word is nonzero ("present"; it is
    exactly 0 wherever the plane fit did not accept). `pay` holds the
    present lanes' vx/vy words in stream order, then from offset count_p
    the valid lanes' true-flow words (valid lanes are present ones), 0
    after. aux_plus is the dense aux bytes, then the two counts (present,
    valid) as int32 bytes, then pay[:R] as bytes: a call whose payload
    fits the rider needs no second read. Both scatters write unique
    prefix-sum slots; lanes that do not write go to a spare slot 2 N.
    """
    steps, _, m = main.shape
    N = steps * m
    vx_word = main[:, 0, :].reshape(N)
    tf_word = main[:, 1, :].reshape(N)
    auxf = aux.reshape(N)
    present = vx_word != 0
    valid = (auxf & 0x80) != 0
    aux_out = auxf | (present.to(torch.uint8) << 6)
    idx_p = torch.cumsum(present, 0, dtype=torch.int32) - 1
    idx_v = torch.cumsum(valid, 0, dtype=torch.int32) - 1
    count_p = idx_p[-1] + 1
    counts = torch.stack([count_p, idx_v[-1] + 1])
    pay = main.new_zeros(2 * N + 1)
    pay[torch.where(present, idx_p, 2 * N).to(torch.int64)] = vx_word
    pay[torch.where(valid, idx_v + count_p, 2 * N).to(torch.int64)] = tf_word
    pay = pay[:2 * N]
    R = min(_SPARSE_RIDER_LANES, 2 * N)
    aux_plus = torch.cat([aux_out, counts.view(torch.uint8),
                          pay[:R].view(torch.uint8)])
    return aux_plus, pay


def _fetch_sparse(out):
    """One call's sparse wire on the host: (dense aux uint8 [N], present
    lanes' vx/vy words, valid lanes' true-flow words). Reads aux_plus
    (counts and rider included), then the payload prefix only where it
    is longer than the rider."""
    aux_plus, pay = out
    N2 = pay.shape[0]
    R = (aux_plus.shape[0] - N2 // 2 - 8) // 4
    a = aux_plus.cpu().numpy()
    rider = a[a.size - 4 * R:].view(np.int32)
    cp, cv = (int(v) for v in a[a.size - 4 * R - 8:a.size - 4 * R]
              .view(np.int32))
    k = cp + cv
    both = rider[:k] if k <= R else pay[:k].cpu().numpy()
    return a[:a.size - 4 * R - 8], both[:cp], both[cp:k]


def refuse_sparse(cfg: FlowConfig) -> None:
    """The sharded engines ship the dense wire (farms_tpu/pipeline/
    engine.py:1172-1175)."""
    if cfg.wire == "sparse":
        raise ValueError(
            "wire='sparse' requires the base (unsharded) engine "
            "dispatch; sharded engines ship the dense f16/f32 wire")


def scan_chunk(state: SurfaceState, chunk: dict, cfg: FlowConfig,
               lanes: tuple[int, int] | None = None,
               shard: Sensor | None = None):
    """Run the micro-steps of one call in order: the step loop of every
    engine.

    `chunk` is a micro_step batch dict with a leading [n_steps] axis on
    every entry. Its "step" vector, the steps' numbers on the device, is
    made here by one fill from state.step unless the chunk carries it (a
    captured CUDA graph computes it from its input: _ResidentGraph).
    Returns the final state and the stacked wire pair (int32 [n_steps,
    C, k], uint8 [n_steps, k]) of the gathered `lanes` of the `shard`
    (micro_step; all lanes of the whole sensor by default).
    """
    mains, auxs = [], []
    n_steps = chunk["ev"].shape[0]
    if "step" not in chunk:
        chunk = dict(chunk, step=torch.arange(
            state.step, state.step + n_steps, dtype=torch.int32,
            device=chunk["ev"].device))
    for i in range(n_steps):
        state, (main, aux) = micro_step(
            state, {k: v[i] for k, v in chunk.items()}, cfg, lanes, shard)
        mains.append(main)
        auxs.append(aux)
    return state, (torch.stack(mains), torch.stack(auxs))


class FlowEngine:
    """Host-side streaming loop carrying device state across calls."""

    # micro_step's defaults: every lane gathered, on the whole sensor; the
    # sharded engines set a rank's lane window or its shard geometry
    lanes: tuple[int, int] | None = None
    shard: Sensor | None = None

    def __init__(self, cfg: FlowConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        if device.type == "cuda":
            # build the kernels now, outside any timed region of process()
            _build.load()
        self.cfg = cfg
        self.device = device
        self.reset()

    def reset(self):
        self.state = init_state(self.cfg, self.device)
        self._t0 = None

    def set_state(self, state: SurfaceState) -> None:
        """Adopt a whole-sensor [W, H] state (e.g. a restored checkpoint),
        padded to the array geometry."""
        self.state = pad_state(state, self.cfg)

    def whole_state(self) -> SurfaceState | None:
        """The state at the semantic [W, H] geometry, as a checkpoint
        stores it (None on ranks that do not write checkpoints)."""
        return strip_state(self.state, self.cfg)

    # ---- host-side packing -------------------------------------------------
    def pack(self, ev: EventBatch, steps_per_call: int | None = None,
             compact: bool = False):
        """Normalize, pad, and pack an event stream for the device.

        Returns (packed int32 [n_calls, steps, rows, m] host array, n)
        where n is the real event count; rows is 5 (x, y, t, lane_valid,
        winner; padded lanes at x = y = 0, invalid, never winners) or, with
        `compact`, 2 (x*H+y | winner<<30, t; padded lanes at the sentinel
        W*H). A sensor of 2^30 pixels or more would alias the winner bit,
        so it packs 5 rows whatever `compact` says. The compact pack runs
        in the native library where it is built. The first call latches
        t0 = first stamp (vFlow.cpp:194, 241); later calls continue the
        same timeline.
        """
        cfg = self.cfg
        if compact and cfg.width * cfg.height >= _COMPACT_PIXELS:
            compact = False
        n = len(ev)
        if self._t0 is None and n:
            self._t0 = np.uint32(ev.t[0])

        m = cfg.chunk_size
        spc = call_steps(cfg, steps_per_call)
        per_call = m * spc
        n_calls = max(1, -(-n // per_call))
        total = n_calls * per_call
        pad_total = total - n

        if compact:
            nat = nativeio.pack_compact(
                ev.x, ev.y, ev.t, int(self._t0 or 0), cfg.width, cfg.height,
                m, n_calls * spc,
                subphases=cfg.sub_phases * cfg.causal_snapshots)
            if nat is not None:
                return nat.reshape(n_calls, spc, 2, m), n

        x = np.clip(ev.x.astype(np.int32), 0, cfg.width - 1)
        y = np.clip(ev.y.astype(np.int32), 0, cfg.height - 1)
        t = (ev.t.astype(np.uint32) - (self._t0 or np.uint32(0))).view(np.int32)

        def padded(arr, fill):
            if not pad_total:
                return arr
            out = np.empty(total, dtype=np.int32)
            out[:n] = arr
            out[n:] = fill
            return out

        xp = padded(x, 0)
        yp = padded(y, 0)
        tp = padded(t, t[-1] if n else 0)

        # host-side winner resolution per scatter group: the last event at
        # each pixel within a group wins (vFlow.cpp:264-273). NumPy
        # fancy-index assignment keeps the last write. Padded lanes go to
        # a sentinel bucket so they cannot steal pixel (0, 0).
        blk = m // (cfg.sub_phases * cfg.causal_snapshots)
        flat = xp * np.int64(cfg.height) + yp
        flat[n:] = cfg.width * cfg.height
        flat = flat.reshape(-1, blk)
        lanes = np.arange(blk)
        seen = np.empty(cfg.width * cfg.height + 1, dtype=np.int64)
        winner = np.empty((flat.shape[0], blk), dtype=np.int32)
        for b in range(flat.shape[0]):
            seen[flat[b]] = lanes
            winner[b] = seen[flat[b]] == lanes
        winner = winner.reshape(-1)
        winner[n:] = 0

        if compact:
            word = flat.reshape(-1).astype(np.int32)
            word |= winner << 30
            packed = np.empty((n_calls, spc, 2, m), dtype=np.int32)
            packed[:, :, 0, :] = word.reshape(n_calls, spc, m)
            packed[:, :, 1, :] = tp.reshape(n_calls, spc, m)
            return packed, n

        packed = np.empty((n_calls, spc, 5, m), dtype=np.int32)
        for row, arr in enumerate((xp, yp, tp, np.arange(total) < n,
                                   winner)):
            packed[:, :, row, :] = arr.reshape(n_calls, spc, m)
        return packed, n

    def pack_r2(self, ev: EventBatch, steps_per_call: int | None = None):
        """Rank-2 lane data of the center-correction pass, built on the host.

        Returns (flags uint8 [n_calls, spc, m], centers int32 [n_calls,
        spc, W, H], at the semantic geometry: array_centers pads them)
        with B = cfg.center_correction: per micro-step, the
        second-latest event at each pixel within its plane-fit phase,
        deduplicated per (pixel, step) keeping the latest occurrence (one
        center surface per step holds one stamp per pixel) and capped at
        the latest B. `flags` marks the corrected lanes; `centers` is the
        step's stamp1 center surface.
        """
        cfg = self.cfg
        m = cfg.chunk_size
        P = cfg.sub_phases
        mp = m // P
        B = cfg.center_correction
        W, H = cfg.width, cfg.height
        WH = W * H
        n = len(ev)
        if self._t0 is None and n:
            self._t0 = np.uint32(ev.t[0])
        spc = call_steps(cfg, steps_per_call)
        per_call = m * spc
        n_calls = max(1, -(-n // per_call))
        x = np.clip(ev.x.astype(np.int64), 0, W - 1)
        y = np.clip(ev.y.astype(np.int64), 0, H - 1)
        flat = np.full(n_calls * per_call, WH, dtype=np.int64)
        flat[:n] = x * H + y
        t1 = np.zeros(n_calls * per_call, dtype=np.int32)
        t1[:n] = ((ev.t.astype(np.uint32) - self._t0 + np.uint32(1))
                  ).view(np.int32)
        flat = flat.reshape(n_calls * spc, P, mp)
        t1 = t1.reshape(n_calls * spc, P * mp)
        flags = np.zeros((n_calls * spc, m), dtype=np.uint8)
        centers = np.zeros((n_calls * spc, WH), dtype=np.int32)
        lanes_mp = np.arange(mp, dtype=np.int64)
        seen = np.empty(WH + 1, dtype=np.int64)
        for s in range(n_calls * spc):
            cand = []
            for p in range(P):
                f = flat[s, p]
                seen[f] = lanes_mp
                final = seen[f] == lanes_mp
                nf = ~final & (f < WH)
                f2, l2 = f[nf], lanes_mp[nf]
                if f2.size:
                    seen[f2] = l2
                    r2 = seen[f2] == l2     # the last of the non-final lanes
                    cand.append((l2[r2] + p * mp, f2[r2]))
            if cand:
                c = np.concatenate([a for a, _ in cand])
                fc = np.concatenate([b for _, b in cand])
                seen[fc] = np.arange(c.size)
                keep = seen[fc] == np.arange(c.size)   # latest per pixel
                c = c[keep][-B:]
                fc = fc[keep][-B:]
                flags[s, c] = 1
                centers[s, fc] = t1[s, c]
        return (flags.reshape(n_calls, spc, m),
                centers.reshape(n_calls, spc, W, H))

    def pack2(self, ev: EventBatch, steps_per_call: int | None = None):
        """Delta-coded 4 B/event repack of the compact layout.

        Returns (packed, aux, n): int32 [n_calls, spc, 1, m] words
        (flat idx | winner << ib | stamp-delta << ib+1, ib from
        compact2_bits) and aux = (bases int32 [n_calls, spc] per-step
        first stamps, escapes int32 [n_calls, spc, 2, E] oversized-delta
        (lane, true delta) pairs). `aux` is None and `packed` pack()'s
        compact (or, at 2^30 pixels, 5-row) layout when a step overflows
        the escape budget or the sensor leaves fewer than 8 delta bits:
        exact stamps always win over wire size.
        """
        packed, n = self.pack(ev, steps_per_call=steps_per_call,
                              compact=True)
        ib, db = compact2_bits(self.cfg)
        if packed.shape[2] != 2 or db < 8:
            return packed, None, n
        E = _C2_ESCAPES
        pu = packed.view(np.uint32)
        word1 = pu[:, :, 0, :]
        t = pu[:, :, 1, :]
        n_calls, spc, m = t.shape
        dt = t.copy()
        dt[:, :, 1:] -= t[:, :, :-1]
        dt[:, :, 0] = 0
        escapes = np.empty((n_calls, spc, 2, E), np.int32)
        escapes[:, :, 0, :] = m           # sentinel lane: unused slot
        escapes[:, :, 1, :] = 0
        over = dt > np.uint32((1 << db) - 1)   # incl. wrapped negatives
        if over.any():
            cnt = over.sum(axis=2)
            if cnt.max() > E:
                return packed, None, n
            for c, s in zip(*np.nonzero(cnt)):
                lanes = np.nonzero(over[c, s])[0]
                escapes[c, s, 0, :lanes.size] = lanes
                escapes[c, s, 1, :lanes.size] = dt[c, s, lanes].view(np.int32)
            dt = np.where(over, np.uint32(0), dt)
        win = (word1 >> np.uint32(30)) & np.uint32(1)
        flat = word1 & np.uint32(0x3FFFFFFF)
        word2 = (flat | (win << np.uint32(ib))
                 | (dt << np.uint32(ib + 1))).view(np.int32)
        bases = np.ascontiguousarray(t[:, :, 0]).view(np.int32)
        return word2[:, :, None, :], (bases, escapes), n

    def _unpack_outputs(self, out_blocks, ev: EventBatch, n: int) -> FlowOutput:
        """Decode wire blocks [(main int32 [steps, C, m], aux uint8
        [steps, m])], device tensors or host arrays, or on the sparse wire
        [(aux uint8 [N], present lanes' vx/vy words, valid lanes'
        true-flow words)] (_fetch_sparse), into the 11-column FlowOutput
        (first n lanes); the span `engine.decode` while a profiler
        records. Each block is decoded on the engine's device
        (_decode_call): host blocks of a CUDA engine are uploaded first."""
        with tracing.span("engine.decode"):
            if self.cfg.wire == "sparse":
                # re-expand the payloads to lane order (absent lanes are
                # exactly 0) and clear the present bit for the scale decode
                blocks = []
                for a, pp, pv in out_blocks:
                    vxw = np.zeros(a.size, np.int32)
                    vxw[(a & 0x40) != 0] = pp
                    tfw = np.zeros(a.size, np.int32)
                    tfw[(a & 0x80) != 0] = pv
                    blocks.append((np.stack([vxw, tfw])[None],
                                   (a & np.uint8(0xBF))[None]))
            else:
                blocks = out_blocks
            cols, dev_cols = self._column_blocks(n)
            offset = 0
            for block in blocks:
                mo, ao = (torch.as_tensor(a, device=self.device).contiguous()
                          for a in block)
                offset += self._decode_call(mo, ao, dev_cols, cols, offset)
            return self._flow_output(cols, ev)

    def _flow_output(self, cols: dict, ev: EventBatch) -> FlowOutput:
        """The FlowOutput of `ev` with its seven decoded columns: each event
        column one allocation, the stamps relative to the stream's first."""
        return FlowOutput(
            x=ev.x.astype(np.int32),
            y=ev.y.astype(np.int32),
            t=np.subtract(ev.t, self._t0, dtype=np.uint32, casting="unsafe"),
            pol=ev.pol.astype(np.int32),
            **cols,
        )

    def _column_blocks(self, n: int) -> tuple[dict, torch.Tensor]:
        """The seven output columns of n lanes as fresh host arrays (the
        FlowOutput owns them: nothing reuses them), an array each as
        decode_wire_columns gives them, and decode_wire's float32 [7, n]
        block on the engine's device."""
        cols = {name: np.empty(n, np.int32 if name == "scale" else
                               np.float32) for name in kernels.WIRE_COLUMNS}
        return cols, torch.empty((7, n), dtype=torch.float32,
                                 device=self.device)

    def _decode_call(self, main: torch.Tensor, aux: torch.Tensor,
                     dev_cols: torch.Tensor, cols: dict, offset: int) -> int:
        """Decode one call's wire (main int32 [steps, C, k], aux uint8
        [steps, k], on the engine's device) with kernels.decode_wire into
        columns offset.. of dev_cols (_column_blocks), as many lanes as
        the wire holds or the block has left, and copy them into the same
        lanes of the host columns `cols`. A CUDA engine decodes on the
        card, a CPU engine with decode_wire_columns. Returns the count."""
        n = dev_cols.shape[1]
        count = min(main.shape[0] * main.shape[2], n - offset)
        kernels.decode_wire(main, aux, dev_cols, offset, count,
                            self.cfg.window_jump)
        for r, name in enumerate(kernels.WIRE_COLUMNS):
            torch.from_numpy(cols[name][offset:offset + count].view(
                np.float32)).copy_(dev_cols[r, offset:offset + count])
        tracing.count("engine.decoded_lanes", count)
        if dev_cols.is_cuda:
            tracing.count("engine.device_decoded_lanes", count)
        return count

    def array_centers(self, centers: np.ndarray) -> np.ndarray:
        """pack_r2's [..., W, H] center surfaces at the array geometry
        (pad cells 0, never written)."""
        cfg = self.cfg
        pad = [(0, 0)] * (centers.ndim - 2) + [
            (0, cfg.array_width - cfg.width),
            (0, cfg.array_height - cfg.height)]
        return np.pad(centers, pad)

    # ---- processing --------------------------------------------------------
    def device_calls(self, ev: EventBatch, steps_per_call: int | None = None,
                     center_rows=slice(None), rows5: bool = False,
                     center_cols=slice(None)):
        """Pack a stream (len(ev) > 0) and yield each call's micro_step
        batch dict on the device, in order; each call's center surfaces
        travel with its own batch. `center_rows` and `center_cols` are the
        cells of the center surfaces a rank uploads; `rows5` packs the
        explicit 5-row layout instead of the delta-coded words (pack2).

        While a profiler records (utils/tracing.py), each packer is a span
        (`engine.pack`, `engine.pack_r2`), each call's copies to the
        device one `engine.upload`, and the counters `engine.calls` and
        `engine.epoch_calls` (dense calls, whose step finds each phase's
        written pixels by the epoch scatter) count the calls."""
        with tracing.span("engine.pack"):
            if rows5:
                packed, _ = self.pack(ev, steps_per_call=steps_per_call)
                aux2 = None
            else:
                packed, aux2, _ = self.pack2(ev,
                                             steps_per_call=steps_per_call)
        r2 = None
        if self.cfg.center_correction:
            with tracing.span("engine.pack_r2"):
                r2 = self.pack_r2(ev, steps_per_call=steps_per_call)
        dev = self.device
        for c in range(packed.shape[0]):
            with tracing.span("engine.upload"):
                chunk = {"ev": torch.from_numpy(packed[c]).to(dev)}
                if aux2 is not None:
                    chunk["base"] = torch.from_numpy(aux2[0][c]).to(dev)
                    chunk["esc"] = torch.from_numpy(aux2[1][c]).to(dev)
                if r2 is not None:
                    chunk["r2f"] = torch.from_numpy(r2[0][c]).to(dev)
                    chunk["r2c"] = torch.from_numpy(np.ascontiguousarray(
                        self.array_centers(r2[1][c])[:, center_rows,
                                                     center_cols])).to(dev)
            tracing.count("engine.calls")
            if self.cfg.use_dense:
                tracing.count("engine.epoch_calls")
            yield chunk

    def _run_call(self, chunk: dict):
        """One call's micro-steps; returns the call's wire blocks on the
        device. The span `engine.launch` is the host's time enqueuing
        them (and waiting where a step reads the device)."""
        with tracing.span("engine.launch"):
            self.state, out = scan_chunk(self.state, chunk, self.cfg)
        return out

    def process(self, ev: EventBatch,
                steps_per_call: int | None = None) -> FlowOutput:
        """Process an event stream (or a continuation of one).

        Single-threaded: packs on the host, uploads each call's batch, runs
        its micro-steps, and brings the outputs back: each call's wire
        decoded into the output columns (`_decode_call`: on the card on a
        CUDA engine, with decode_wire_columns on a CPU engine) and copied
        into host columns; on the sparse wire (compacted on the device
        first) the wire, re-expanded on the host and decoded after the
        last call (`_unpack_outputs`). A call holds call_steps(cfg,
        steps_per_call) micro-steps.
        """
        n = len(ev)
        if n == 0:
            return _empty_output()
        sparse = self.cfg.wire == "sparse"
        cols, offset = None, 0
        blocks = []
        for chunk in self.device_calls(ev, steps_per_call):
            main, aux = self._run_call(chunk)
            # `engine.fetch` includes the wait for the call's device work
            with tracing.span("engine.fetch"):
                if sparse:
                    blocks.append(_fetch_sparse(_sparse_pack_outputs(main,
                                                                     aux)))
                    continue
                if cols is None:
                    # taken once the stream is packed, from the heap the
                    # packers' temporaries left: taken before them, the
                    # columns leave the packers to fault in fresh pages on
                    # every call (PERF.md §6)
                    cols, dev_cols = self._column_blocks(n)
                offset += self._decode_call(main, aux, dev_cols, cols, offset)
        if sparse:
            return self._unpack_outputs(blocks, ev, n)
        with tracing.span("engine.decode"):
            return self._flow_output(cols, ev)

    def process_resident(self, ev: EventBatch):
        """Upload a whole stream (len(ev) > 0) once, as one call of the
        explicit 5-row layout (JAX: farms_tpu/pipeline/engine.py:1309).

        Returns (fn, n): fn() runs every micro-step of the stream from the
        engine's current state, leaves the new state in the engine and
        returns the call's wire blocks on the device; n is the event
        count. The call carries its correction data as process() does.
        Replaying fn() from the state before its first call
        (`engine.state`, which no step modifies in place) reproduces the
        same outputs; the benchmark harness times it so.

        On a CUDA device, where the engine's micro-steps run on the whole
        sensor and keep every lane (no `lanes` window, no `shard`: nothing
        crosses ranks), the dense path captures the call's `_run_call`
        once as a CUDA graph (_ResidentGraph), and each fn() replays it:
        one graph launch instead of every micro-step's eager ops. Every
        other engine and path enqueues the steps eagerly. While a profiler
        records, the counter `engine.resident_calls` counts every fn() and
        `engine.graph_replays` those that replayed a graph.
        """
        spc = max(1, -(-len(ev) // self.cfg.chunk_size))
        chunk = next(self.device_calls(ev, spc, rows5=True))
        graph = None
        if (self.device.type == "cuda" and self.cfg.use_dense
                and self.lanes is None and self.shard is None):
            graph = _ResidentGraph(self, chunk)

        def fn():
            tracing.count("engine.resident_calls")
            return graph.replay() if graph else self._run_call(chunk)

        return fn, len(ev)


def _maps(state: SurfaceState) -> tuple:
    return (state.t_surf, state.epoch, state.flow_len, state.flow_vx,
            state.flow_vy)


class _ResidentGraph:
    """A resident call (the engine's `_run_call` over its uploaded chunk)
    captured once as a CUDA graph, replayed from the engine's state.

    The call runs once eagerly first and is discarded: that loads every
    kernel's module (a capture cannot) and warms the allocator. It is then
    captured on a side stream over static inputs: a copy of the engine's
    five maps and the first step's number on the device, from which the
    graph computes the chunk's step vector (scan_chunk) and so every
    phase's write epoch. A replay fills that number, copies the engine's
    maps in, launches the graph on the current stream and clones the
    outputs, so a state or wire block one replay returned is never
    changed by a later one. The capture launches nothing: the kernel
    wrappers' counts of it (kernels.LAUNCHES, and kernels.COUNTERS: the
    counters kernels.local_flow_general_launches and
    kernels.local_flow_correction_launches) are taken back, and each
    replay adds them again, so that a replay counts as an eager call.
    """

    def __init__(self, engine: FlowEngine, chunk: dict):
        st, dev = engine.state, engine.device
        self.engine = engine
        self.n_steps = chunk["ev"].shape[0]
        engine._run_call(chunk)             # the eager run, discarded
        self.step = torch.full((), st.step, dtype=torch.int32, device=dev)
        self.maps = [m.clone() for m in _maps(st)]
        engine.state = SurfaceState(*self.maps, st.step)
        before = [dict(c) for c in (kernels.LAUNCHES, kernels.COUNTERS)]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                steps = self.step + torch.arange(self.n_steps,
                                                 dtype=torch.int32, device=dev)
                self.wire = engine._run_call(dict(chunk, step=steps))
            self.out = _maps(engine.state)
        finally:
            engine.state = st
        self.counts = [{k: n - b[k] for k, n in c.items()} for c, b in
                       zip((kernels.LAUNCHES, kernels.COUNTERS), before)]
        self._count(-1)

    def replay(self):
        """One fn(): the engine's state in, the graph, the outputs out (the
        span `engine.launch`); the new state left in the engine."""
        eng = self.engine
        with tracing.span("engine.launch"):
            st = eng.state
            self.step.fill_(st.step)
            for dst, src in zip(self.maps, _maps(st)):
                dst.copy_(src)
            self.graph.replay()
            eng.state = SurfaceState(*(m.clone() for m in self.out),
                                     st.step + self.n_steps)
            wire = tuple(w.clone() for w in self.wire)
        self._count(1)
        tracing.count("engine.graph_replays")
        return wire

    def _count(self, sign: int) -> None:
        """Add `sign` times the capture's counts to kernels.LAUNCHES,
        kernels.COUNTERS and the counters of utils/tracing (these only
        while a profiler records)."""
        launches, counters = self.counts
        for k, n in launches.items():
            kernels.LAUNCHES[k] += sign * n
        for k, n in counters.items():
            kernels.COUNTERS[k] += sign * n
            if n:
                tracing.count(k, sign * n)


def _empty_output() -> FlowOutput:
    z = np.zeros(0)
    zi = np.zeros(0, dtype=np.int32)
    return FlowOutput(zi, zi, np.zeros(0, dtype=np.uint32), zi,
                      z, z, z, z, z, z, zi)

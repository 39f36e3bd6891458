"""Per-event local plane fit (the per-event formulation, plain PyTorch).

Counterpart of `farms_tpu.ops.local_flow`: the reference's per-event
`computeLocalFlow` + `computeGrads` (vFlow.cpp:841-949, 1214-1381) as one
computation over a micro-batch of events -

1. one gather of the (4*f_rad+1)^2 support cells around each event covers
   the 9 candidate k x k windows at offsets {-f_rad, 0, +f_rad}^2;
2. each candidate's score is the mean of (t_ev - t_cell) over its window,
   and the first strict minimum in the reference's scan order (x offset
   outer, y inner) wins, among windows wholly inside the sensor;
3. the winning window feeds the closed-form 3x3 normal-equation solve.

In `farms_tpu` this path is plain XLA (per-event gathers, sums, argmin), so
its counterpart here is plain PyTorch, on either device. The sums that
decide accept flags and candidate ids at near-ties (the window means, the
8 normal-equation sums and the inlier count) are left folds in the cell
order of ops/dense_flow.local_flow_core (x outer, y inner), so the card
and the CPU compute them in one order and agree bitwise, and a winner's
plane equals the dense path's. Stamps are stamp1 values (uint32 in int32,
state/surfaces.py) and are ordered only through int32 differences.
"""
from __future__ import annotations

import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.ops.dense_flow import _HALF_WRAP, _WRAP, _full, trig_tail


def _candidate_cells(offs: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """int64 [9, k*k]: the flat support index of each cell of each
    candidate window, candidates in scan order (x offset outer), cells x
    outer, y inner; `offs` holds the candidate offsets (-f, 0, f). Built
    on the device: a tensor made from a host list would be a copy that
    waits for the stream."""
    f, R = cfg.f_rad, cfg.support_radius
    w = torch.arange(-f, f + 1, dtype=torch.int64, device=offs.device)
    rows = offs[:, None] + w[None, :] + R       # [offset, cell]: support row
    cells = rows[:, None, :, None] * (2 * R + 1) + rows[None, :, None, :]
    return cells.reshape(9, -1)


def _fold(cells: torch.Tensor) -> torch.Tensor:
    """Left fold over the last axis (cell order), from its first cell."""
    acc = cells[..., 0]
    for j in range(1, cells.shape[-1]):
        acc = acc + cells[..., j]
    return acc


def local_flow_batch(t_pre: torch.Tensor, t_post: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor, t_ev: torch.Tensor,
                     cfg: FlowConfig):
    """Local flow of a micro-batch of events.

    t_pre / t_post: int32 [W, H] stamp1 surfaces before and after the
    batch's scatter; x, y: integer [m] event pixels; t_ev: int32 [m] the
    events' stamp1 values. Returns (raw_vx, raw_vy, gate_valid, length,
    theta), each [m]: the reference's FlowEvent values (0 where the fit is
    rejected), the reference's validity gate (vFlow.cpp:315), and the polar
    local flow (meaningful where gate_valid).
    """
    W, H = cfg.width, cfg.height
    f, R = cfg.f_rad, cfg.support_radius
    side = 2 * R + 1
    dev = t_post.device
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    m = x.shape[0]

    # ---- support gather [m, side^2], coordinates clamped to the sensor ----
    du = torch.arange(-R, R + 1, dtype=torch.int64, device=dev)
    cgx = (x[:, None, None] + du[None, :, None]).clamp(0, W - 1).expand(
        m, side, side).reshape(m, -1)
    cgy = (y[:, None, None] + du[None, None, :]).clamp(0, H - 1).expand(
        m, side, side).reshape(m, -1)
    flat = cgx * H + cgy
    post = t_post.reshape(-1)[flat]
    te = t_ev[:, None]
    # causal view: the event is serial in the reference, so a cell shows
    # its post-scatter stamp only where that is not in the event's future
    # (an int32 difference, exact mod 2^32; a signed compare of stamp1
    # values breaks past 2^31), else its pre-batch stamp. The event's own
    # pixel shows the event (vFlow.cpp:267 writes before it reads).
    t_patch = torch.where((te - post) >= 0, post, t_pre.reshape(-1)[flat])
    own = (cgx == x[:, None]) & (cgy == y[:, None])
    t_patch = torch.where(own, te, t_patch)
    touched = (t_patch != 0) | own          # stamp1: 0 <=> never written
    # untouched cells hold the t=0 initializer (stamp1 value 1)
    t_patch = torch.where(t_patch == 0, 1, t_patch)
    # the difference in us mod 2^32, as the reference takes it: stamps from
    # the future get +MAXSTAMP (vFlow.cpp:897-902)
    d = (te - t_patch).to(torch.float32)
    d = torch.where(d < 0, d + _WRAP, d)

    # ---- 9 candidate windows: scores, border rule, first strict minimum ----
    offs = (torch.arange(3, dtype=torch.int64, device=dev) - 1) * f
    cand = _candidate_cells(offs, cfg)                  # [9, k*k]
    score = _fold(d[:, cand]) / _full(d, float(cfg.plane_size))   # [m, 9]
    ca = offs.repeat_interleave(3)                      # x offset outer
    cb = offs.repeat(3)                                 # y offset inner
    ok = ((x[:, None] + (ca - f) >= 0) & (x[:, None] + (ca + f) <= W - 1)
          & (y[:, None] + (cb - f) >= 0) & (y[:, None] + (cb + f) <= H - 1))
    score = torch.where(ok, score, float("inf"))        # vFlow.cpp:889
    # argmin returns the first minimum on either device: the strict scan
    # (candidate 0 where none fits, whose fit is never accepted)
    bc = score.argmin(1)
    local_ok = torch.isfinite(score.gather(1, bc[:, None])[:, 0])

    # ---- the winning window and its plane fit (computeGrads,
    # vFlow.cpp:1241-1381) ----
    sel = cand[bc]                                      # [m, k*k]
    d_w = d.gather(1, sel)
    tch = touched.gather(1, sel)
    # A's rows are the stored events' coordinates: the pixel where it was
    # ever written, else (0, 0) from the Event() initializer
    # (vFlow.cpp:80-93); centered on the event
    u = torch.where(tch, cgx.gather(1, sel) - x[:, None],
                    -x[:, None]).to(torch.float32)
    v = torch.where(tch, cgy.gather(1, sel) - y[:, None],
                    -y[:, None]).to(torch.float32)
    yv = d_w * -cfg.ts_to_sec
    su, sv, suu, svv, suv, b0, b1, b2 = _fold(torch.stack(
        [u, v, u * u, v * v, u * v, u * yv, v * yv, yv]))
    n = float(cfg.plane_size)
    det = (suu * (svv * n - sv * sv)
           - suv * (suv * n - sv * su)
           + su * (suv * sv - svv * su))
    det_ok = det >= cfg.det_threshold                   # vFlow.cpp:1323
    safe = torch.where(det_ok, det, 1.0)
    adj00 = svv * n - sv * sv
    adj01 = su * sv - suv * n
    adj02 = suv * sv - svv * su
    adj11 = suu * n - su * su
    adj12 = su * suv - suu * sv
    a_coef = (adj00 * b0 + adj01 * b1 + adj02 * b2) / safe
    b_coef = (adj01 * b0 + adj11 * b1 + adj12 * b2) / safe
    dtdp = torch.sqrt(a_coef * a_coef + b_coef * b_coef)

    # inliers (vFlow.cpp:1352-1369): |planedt - actualdt| < dtdp / 2 and
    # Y > 0, i.e. a positive stored stamp (stamp1 not 1) not wrapped past
    # the event (d < 2^31)
    eligible = (t_patch.gather(1, sel) != 1) & (d_w < _HALF_WRAP)
    hit = (torch.abs(a_coef[:, None] * u + b_coef[:, None] * v - yv)
           < (dtdp * 0.5)[:, None]) & eligible
    inliers = hit.sum(1)
    accept = local_ok & det_ok & (inliers >= cfg.min_evts_on_plane)
    return trig_tail(accept.to(torch.int32), a_coef, b_coef, dtdp)

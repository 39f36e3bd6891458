"""Dense (per-pixel) flow stages in plain PyTorch.

Counterpart of `farms_tpu.ops.dense_flow`. These are the plain versions of
the two CUDA kernels (ops/kernels.py): the CPU path, and the reference the
kernels are checked against on the card. Each function computes in the
same order as its kernel (left folds over the same cell order, divisions
by a device tensor), so on one device the two agree bitwise.

Per-event quantities are recomputed as dense maps over the whole sensor:
the per-pixel center time is the latest write at that pixel, the causal
view of each neighbor is folded over the snapshot chain, and every
reference rule (candidate scan order, mod-2^32 future penalty, det >= 1,
inlier gate with Y > 0, atan2(a, b) convention, vx != 0 validity gate) is
kept. Non-winner events (earlier co-batch events at a pixel that fires
again within the batch) inherit the winner's result; chunk_size=1 is exact.

Reference: computeLocalFlow vFlow.cpp:841-949, computeGrads
vFlow.cpp:1214-1381, computeTrueFlow vFlow.cpp:952-1210.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from farms_tpu_torch.config import FlowConfig

_WRAP = 2.0 ** 32
_HALF_WRAP = 2.0 ** 31


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor on `like`'s device: dividing by it is a true IEEE
    division on every device (PyTorch's CUDA path multiplies by the
    reciprocal when the divisor is a host scalar)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _cell_maps(chain: torch.Tensor, center: torch.Tensor, cfg: FlowConfig):
    """Per-offset causal-view quantities over the (2R+1)^2 support.

    Returns stacked [(2R+1)^2, W, H] maps (d, eli, u, v, yv), offset index
    (ox + R) * (2R + 1) + (oy + R).
    """
    W, H = center.shape
    R = cfg.support_radius
    # out-of-sensor cells read 0 (never written), the kernels' pad
    surfs = F.pad(torch.cat([chain, center[None]], 0), (R, R, R, R))
    px = torch.arange(W, dtype=torch.int32, device=center.device)[:, None]
    py = torch.arange(H, dtype=torch.int32, device=center.device)[None, :]
    pxf = px.to(torch.float32).expand(W, H)
    pyf = py.to(torch.float32).expand(W, H)
    t_c = center
    neg_ts = -cfg.ts_to_sec
    D, ELI, U, V, YV = [], [], [], [], []
    for ox in range(-R, R + 1):
        for oy in range(-R, R + 1):
            if ox == 0 and oy == 0:
                d = torch.zeros((W, H), dtype=torch.float32, device=t_c.device)
                # eligibility: stamp1 not in {0, 1}, an unsigned-domain test
                eli = (t_c != 0) & (t_c != 1)
                u = torch.zeros_like(d)
                v = torch.zeros_like(d)
            else:
                sh = surfs[:, R + ox:R + ox + W, R + oy:R + oy + H]
                # the neighbor's newest chain value not in the center's
                # future: order stamp1 (uint32 in int32) values through the
                # int32 difference, exact mod 2^32; a signed compare of the
                # values themselves breaks past 2^31
                vis = sh[0]
                for s in range(1, sh.shape[0]):
                    vis = torch.where((t_c - sh[s]) >= 0, sh[s], vis)
                tch = vis != 0                 # stamp1: 0 <=> never written
                # untouched cells hold the t=0 initializer (stamp1 value 1)
                vis = torch.where(vis == 0, 1, vis)
                d = (t_c - vis).to(torch.float32)
                d = torch.where(d < 0, d + _WRAP, d)
                # reference inlier rule Y > 0 <=> stamp1 not in {0, 1}
                eli = (vis != 1) & (d < _HALF_WRAP)
                # untouched cells contribute the Event(0,0,0,0)
                # initializer's coordinates (vFlow.cpp:80-93): u = 0 - px
                u = torch.where(tch, float(ox), -pxf)
                v = torch.where(tch, float(oy), -pyf)
            D.append(d)
            ELI.append(eli)
            U.append(u)
            V.append(v)
            YV.append(d * neg_ts)
    return (torch.stack(D), torch.stack(ELI), torch.stack(U), torch.stack(V),
            torch.stack(YV))


def local_flow_core(chain: torch.Tensor, center: torch.Tensor,
                    cfg: FlowConfig):
    """Local plane fit for every pixel against its causal surface view.

    `chain` is the int32 [S, W, H] stack of stamp1 surfaces before the
    batch scatter and at any intra-batch boundaries (oldest first, S >= 1),
    `center` the int32 [W, H] stamp1 surface after it; each pixel's event
    is its latest write (center[p]). Returns exactly what the CUDA kernel
    writes: accept i32, a f32, b f32, dtdp f32 and the winning candidate
    id i32 in scan order (-1 where no candidate window is in bounds),
    each [W, H].
    """
    W, H = cfg.width, cfg.height        # semantic bounds (border rules)
    f = cfg.f_rad
    R = cfg.support_radius
    side = 2 * R + 1
    dev = center.device
    D, ELI, U, V, YV = _cell_maps(chain, center, cfg)
    px = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    py = torch.arange(H, dtype=torch.int32, device=dev)[None, :]

    cand_offsets = [(a, b) for a in (-f, 0, f) for b in (-f, 0, f)]
    win_cells = [(wx, wy) for wx in range(-f, f + 1)
                 for wy in range(-f, f + 1)]
    n = float(cfg.plane_size)
    n_t = _full(center, n)

    # ---- scores of the 9 candidate windows, first strict minimum ----
    inf = float("inf")
    best = torch.full((W, H), inf, dtype=torch.float32, device=dev)
    bc = torch.zeros((W, H), dtype=torch.int32, device=dev)
    for ci, (a, b) in enumerate(cand_offsets):
        ssum = None
        for wx, wy in win_cells:
            c = D[(a + wx + R) * side + (b + wy + R)]
            ssum = c if ssum is None else ssum + c
        score = ssum / n_t
        # full-window in-bounds requirement (vFlow.cpp:889)
        vm = ((px + (a - f) >= 0) & (px + (a + f) <= W - 1)
              & (py + (b - f) >= 0) & (py + (b + f) <= H - 1))
        scorem = torch.where(vm, score, inf)
        better = scorem < best
        best = torch.where(better, scorem, best)
        bc = torch.where(better, ci, bc)
    local_ok = torch.isfinite(best)

    # ---- the winner's normal equations only (candidate 0 where no
    # window fits; its outputs are never accepted) ----
    wa = (bc.to(torch.int64) // 3 - 1) * f
    wb = (bc.to(torch.int64) % 3 - 1) * f
    cells = []
    for wx, wy in win_cells:
        gi = ((wa + wx + R) * side + (wb + wy + R))[None]
        cells.append(tuple(q.gather(0, gi)[0] for q in (ELI, U, V, YV)))
    su = sv = suu = svv = suv = b0 = b1 = b2 = None
    for _, u, v, yv in cells:
        if su is None:
            su, sv, suu, svv, suv = u, v, u * u, v * v, u * v
            b0, b1, b2 = u * yv, v * yv, yv
        else:
            su = su + u
            sv = sv + v
            suu = suu + u * u
            svv = svv + v * v
            suv = suv + u * v
            b0 = b0 + u * yv
            b1 = b1 + v * yv
            b2 = b2 + yv

    # ---- closed-form 3x3 adjugate solve (vFlow.cpp:1307-1341) ----
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

    # ---- inlier count with the winner's plane (vFlow.cpp:1360-1366) ----
    half = dtdp * 0.5
    inl = torch.zeros((W, H), dtype=torch.int32, device=dev)
    for eli, u, v, yv in cells:
        hit = (torch.abs(a_coef * u + b_coef * v - yv) < half) & eli
        inl = inl + hit.to(torch.int32)

    accept = local_ok & det_ok & (inl >= cfg.min_evts_on_plane)
    cand = torch.where(local_ok, bc, -1)
    return accept.to(torch.int32), a_coef, b_coef, dtdp, cand


def trig_tail(accept: torch.Tensor, a_coef: torch.Tensor,
              b_coef: torch.Tensor, dtdp: torch.Tensor):
    """Velocity inversion and validity gate, shared by both paths.

    vFlow.cpp:1373-1377 (speed = 1/dtdp along atan2(a, b)) and the
    vFlow.cpp:315 gate. The trig form is kept deliberately: on axis-aligned
    planes the vx != 0 gate depends on cos(atan2(...)) not rounding to 0.
    Returns per-pixel maps (raw_vx, raw_vy, gate_valid, length, theta).
    """
    acc = accept > 0
    speed = 1.0 / dtdp
    angle = torch.atan2(a_coef, b_coef)
    raw_vx = torch.where(acc, speed * torch.cos(angle), 0.0)
    raw_vy = torch.where(acc, speed * torch.sin(angle), 0.0)
    gate_valid = (~torch.isnan(raw_vx) & ~torch.isnan(raw_vy)
                  & (raw_vx != 0) & (raw_vy != 0))
    length = torch.sqrt(raw_vx * raw_vx + raw_vy * raw_vy)
    theta = torch.atan2(raw_vy, raw_vx)
    return raw_vx, raw_vy, gate_valid, length, theta


def build_integral(flow_len: torch.Tensor, flow_vx: torch.Tensor,
                   flow_vy: torch.Tensor) -> torch.Tensor:
    """The 4-field integral image [4, W+1, H+1] the aperture stage reads.

    Fields: gate = (len > 0), len*gate, vx*gate, vy*gate, formed in f32;
    a double cumsum with a leading zero row and column, in float64. The
    f32 integral of `farms_tpu` breaks mathematically exact ties between
    scales (an isolated flow pixel has the same mean length at every scale
    whose window holds only it) by rounding noise, and the noise differs
    with the summation order: torch.cumsum accumulates f32 in double on the
    CPU and in f32 on CUDA. In float64 the box sums of such windows are
    exact, so the tie resolves to the first scale as in the float64
    reference, and the CPU and CUDA paths agree.
    """
    gate = (flow_len > 0).to(torch.float32)
    fields = torch.stack(
        [gate, flow_len * gate, flow_vx * gate, flow_vy * gate], 0)
    integ = torch.cumsum(torch.cumsum(fields.to(torch.float64), 1), 2)
    return F.pad(integ, (1, 0, 1, 0))


def aperture_y_clip(cfg: FlowConfig) -> int:
    """Last integral column a corner may read: the window's y-range clamps
    at H - 1, or at W - 1 under the reference's y-by-width quirk
    (vFlow.cpp:998-1000), never past the array."""
    y_hi = (cfg.width if cfg.replicate_y_clamp_quirk else cfg.height) - 1
    return min(y_hi + 1, cfg.height)


def dense_aperture(flow_len: torch.Tensor, flow_vx: torch.Tensor,
                   flow_vy: torch.Tensor, cfg: FlowConfig,
                   want_ids: bool = False):
    """Multi-scale aperture pooling for every pixel (plain path).

    The plain version of the aperture kernel, over the integral image of
    build_integral: for each scale s, 4-corner box sums with clamped
    windows (vFlow.cpp:998-1000), taken in float64 and rounded once to
    f32, strict first maximum of the mean length (vFlow.cpp:1052-1059),
    and the center-flow, scale-0 fallback when that maximum is <= 0
    (vFlow.cpp:1086-1094). The freshness (KILL_OLD_FLOW_TIME) gate is
    applied upstream by state.surfaces.kill_stale_flow. Returns
    (true_vx, true_vy, scale).
    """
    integ = build_integral(flow_len, flow_vx, flow_vy)
    W, H = cfg.width, cfg.height
    dev = flow_vx.device
    yc = aperture_y_clip(cfg)
    px = torch.arange(W, dtype=torch.int64, device=dev)
    py = torch.arange(H, dtype=torch.int64, device=dev)
    one = _full(flow_vx, 1.0)
    best_ml = torch.full((W, H), -1.0, dtype=torch.float32, device=dev)
    best_vx = torch.zeros((W, H), dtype=torch.float32, device=dev)
    best_vy = torch.zeros_like(best_vx)
    best_s = torch.zeros((W, H), dtype=torch.int32, device=dev)
    mls = []
    for s in cfg.scales:
        xh = torch.clamp(px + s + 1, 0, W)[:, None]
        xl = torch.clamp(px - s, 0, W)[:, None]
        yh = torch.clamp(py + s + 1, 0, yc)[None, :]
        yl = torch.clamp(py - s, 0, yc)[None, :]
        box = (integ[:, xh, yh] - integ[:, xl, yh]
               - integ[:, xh, yl] + integ[:, xl, yl]).to(torch.float32)
        cnt = box[0]
        has = cnt > 0.5
        safe = torch.where(has, cnt, one)
        ml = torch.where(has, box[1] / safe, 0.0)
        if want_ids:
            mls.append(ml)
        better = ml > best_ml                      # strict: first max wins
        best_ml = torch.where(better, ml, best_ml)
        best_vx = torch.where(better, box[2] / safe, best_vx)
        best_vy = torch.where(better, box[3] / safe, best_vy)
        best_s = torch.where(better, s, best_s)
    pooled = best_ml > 0
    tvx = torch.where(pooled, best_vx, flow_vx)
    tvy = torch.where(pooled, best_vy, flow_vy)
    scale = torch.where(pooled, best_s, 0)
    if want_ids:
        # per-scale mean-length stack, to identify legitimate near-tie
        # scale winners in the equivalence tests
        return tvx, tvy, scale, torch.stack(mls)
    return tvx, tvy, scale


def onehot_gather(maps: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  W: int, H: int) -> torch.Tensor:
    """maps: [F, W, H]; returns [F, m] = maps[:, x, y].

    Padded lanes carry the flat sentinel W*H (x = W, y = 0); the table
    gains one zero column for them, so no index is ever out of bounds.
    Only the first n (real) lanes are meaningful.
    """
    flat = maps.reshape(maps.shape[0], W * H)
    flat = torch.cat([flat, flat.new_zeros((maps.shape[0], 1))], 1)
    return flat[:, x.to(torch.int64) * H + y.to(torch.int64)]

"""Bit-faithful NumPy float64 oracle of the reference FARMS_Flow semantics.

This is the golden reference for the test suite (the reference repo ships no
tests; SURVEY.md SS4). It reproduces, event by event, the behavior of the
reference batch driver `vFlowManager::runFileCopy` (vFlow.cpp:111-460) with
`computeLocalFlow` (vFlow.cpp:841-949), `computeTrueFlow` (vFlow.cpp:952-1210)
and `computeGrads` (vFlow.cpp:1214-1381), in double precision, including the
quirk behaviors that shape the output files:

- surfaces initialized with Event(0,0,0,0), so untouched pixels contribute
  (x=0, y=0, t=0) rows to plane fits (vFlow.cpp:80-93);
- validity gate `!isnan(vx) && !isnan(vy) && vx != 0 && vy != 0`
  (vFlow.cpp:315);
- invalid rows carry zeros for R/Theta but the raw Vx/Vy (vFlow.cpp:384-396);
- the +-MAXSTAMP wraparound corrections (vFlow.cpp:897-902, 1229-1233);
- first-strict-maximum scale selection (vFlow.cpp:1052-1059);
- On/Off surfaces are written identically (vFlow.cpp:349-356), so one set of
  surfaces suffices.

Deviations (each provably output-identical or gated by a config flag):
- The re-gather around the best candidate clamps the high side too
  (the reference's unclamped read at vFlow.cpp:924-930 is dead code: only
  fully in-bounds candidate windows can win, and the all-skipped case
  returns early at vFlow.cpp:915-918).
- `replicate_y_clamp_quirk` controls whether the aperture scan clamps y by
  `width` (reference bug, vFlow.cpp:998-1000) or `height` (correct).

Intended for small inputs only (it is a Python per-event loop).
"""
from __future__ import annotations

import math

import numpy as np

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, FlowOutput

MAXSTAMP = 2.0 ** 32  # reference: vFlow.h:27


def run_oracle(ev: EventBatch, cfg: FlowConfig) -> FlowOutput:
    W, H = cfg.width, cfg.height
    f_rad = cfg.f_rad
    plane_size = cfg.plane_size
    kill = float(cfg.kill_old_flow_time_us)

    # Surfaces (reference indexes [x][y]; we use [W, H] arrays).
    surf_t = np.zeros((W, H), dtype=np.float64)    # cSurf stamps
    surf_x = np.zeros((W, H), dtype=np.int64)      # cSurf stored event x
    surf_y = np.zeros((W, H), dtype=np.int64)      # cSurf stored event y
    flow_len = np.zeros((W, H), dtype=np.float64)
    flow_theta = np.zeros((W, H), dtype=np.float64)
    last_t = np.zeros((W, H), dtype=np.float64)

    n = len(ev)
    out = {
        k: np.zeros(n, dtype=np.float64)
        for k in ("r_true", "theta_true", "vx", "vy", "r_local", "theta_local")
    }
    out_scale = np.zeros(n, dtype=np.int32)
    out_t = np.zeros(n, dtype=np.uint32)

    t0 = np.uint32(ev.t[0]) if n else np.uint32(0)
    scales = cfg.scales
    y_clamp = (W if cfg.replicate_y_clamp_quirk else H) - 1

    for e in range(n):
        x = int(ev.x[e])
        y = int(ev.y[e])
        t = float(np.uint32(ev.t[e] - t0))  # unsigned normalize, vFlow.cpp:241
        out_t[e] = np.uint32(ev.t[e] - t0)

        # surface writes before compute (vFlow.cpp:264-273)
        last_t[x, y] = t
        surf_t[x, y] = t
        surf_x[x, y] = x
        surf_y[x, y] = y

        vx, vy = _compute_local_flow(
            surf_t, surf_x, surf_y, x, y, t, f_rad, plane_size,
            cfg.min_evts_on_plane, cfg.det_threshold, W, H,
        )

        valid = (
            not math.isnan(abs(vx)) and not math.isnan(abs(vy))
            and vx != 0 and vy != 0
        )  # vFlow.cpp:315

        if valid:
            length = math.sqrt(vx * vx + vy * vy)
            theta = math.atan2(vy, vx)
            flow_len[x, y] = length
            flow_theta[x, y] = theta

            tvx, tvy, scale = _compute_true_flow(
                flow_len, flow_theta, last_t, x, y, t, kill, scales,
                W - 1, y_clamp,
            )
            out["r_true"][e] = math.sqrt(tvx * tvx + tvy * tvy)
            out["theta_true"][e] = math.atan2(tvy, tvx)
            out["vx"][e] = vx
            out["vy"][e] = vy
            out["r_local"][e] = length
            out["theta_local"][e] = theta
            out_scale[e] = scale
        else:
            out["vx"][e] = vx
            out["vy"][e] = vy
            flow_len[x, y] = 0.0
            flow_theta[x, y] = 0.0

        last_t[x, y] = t  # vFlow.cpp:407 (same value again)

    return FlowOutput(
        x=ev.x.astype(np.int32),
        y=ev.y.astype(np.int32),
        t=out_t,
        pol=ev.pol.astype(np.int32),
        r_true=out["r_true"],
        theta_true=out["theta_true"],
        vx=out["vx"],
        vy=out["vy"],
        r_local=out["r_local"],
        theta_local=out["theta_local"],
        scale=out_scale,
    )


def _compute_local_flow(surf_t, surf_x, surf_y, x, y, t, f_rad, plane_size,
                        min_evts, det_threshold, W, H):
    """Local plane-fit flow for one event (vFlow.cpp:841-949)."""
    best_score = MAXSTAMP + 1.0
    best_i = best_j = 0
    for i in (x - f_rad, x, x + f_rad):          # vFlow.cpp:870 (x outer)
        for j in (y - f_rad, y, y + f_rad):      # vFlow.cpp:872 (y inner)
            x_lo, x_hi = max(0, i - f_rad), min(W - 1, i + f_rad)
            y_lo, y_hi = max(0, j - f_rad), min(H - 1, j + f_rad)
            count = (x_hi - x_lo + 1) * (y_hi - y_lo + 1)
            if count < plane_size:               # border skip, vFlow.cpp:889
                continue
            patch = surf_t[x_lo:x_hi + 1, y_lo:y_hi + 1]
            diff = t - patch
            diff = diff + (patch > t) * MAXSTAMP  # wraparound, vFlow.cpp:897
            score = float(diff.sum()) / count
            if score < best_score:
                best_score = score
                best_i, best_j = i, j
    if best_score > MAXSTAMP:                    # vFlow.cpp:915
        return 0.0, 0.0

    x_lo, x_hi = max(0, best_i - f_rad), min(W - 1, best_i + f_rad)
    y_lo, y_hi = max(0, best_j - f_rad), min(H - 1, best_j + f_rad)
    ts = surf_t[x_lo:x_hi + 1, y_lo:y_hi + 1].ravel()
    ax = surf_x[x_lo:x_hi + 1, y_lo:y_hi + 1].ravel().astype(np.float64)
    ay = surf_y[x_lo:x_hi + 1, y_lo:y_hi + 1].ravel().astype(np.float64)

    # computeGrads overload 1 (vFlow.cpp:1214-1238)
    Y = np.where(ts > t, (ts - MAXSTAMP), ts) * 1e-6
    return _compute_grads(ax, ay, Y, float(x), float(y), t * 1e-6,
                          min_evts, det_threshold)


def _compute_grads(ax, ay, Y, cx, cy, cz, min_evts, det_threshold):
    """Normal-equation plane fit + inlier count (vFlow.cpp:1241-1381).

    Returns (vx, vy); zeros when the plane is rejected (det or inliers).
    """
    n = ax.shape[0]
    ones = np.ones(n)
    A = np.stack([ax, ay, ones], axis=1)
    AtA = A.T @ A
    det = (
        AtA[0, 0] * (AtA[1, 1] * AtA[2, 2] - AtA[2, 1] * AtA[1, 2])
        - AtA[0, 1] * (AtA[1, 0] * AtA[2, 2] - AtA[2, 0] * AtA[1, 2])
        + AtA[0, 2] * (AtA[1, 0] * AtA[2, 1] - AtA[2, 0] * AtA[1, 1])
    )
    if det < det_threshold:                       # vFlow.cpp:1323
        return 0.0, 0.0
    # 3x3 adjugate inverse (vFlow.cpp:1326-1336)
    inv = np.empty((3, 3))
    m = AtA
    inv[0, 0] = m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
    inv[0, 1] = m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]
    inv[0, 2] = m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]
    inv[1, 0] = m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]
    inv[1, 1] = m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
    inv[1, 2] = m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]
    inv[2, 0] = m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]
    inv[2, 1] = m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]
    inv[2, 2] = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    abc = (inv / det) @ (A.T @ Y)

    dtdp = math.sqrt(abc[0] ** 2 + abc[1] ** 2)   # vFlow.cpp:1349
    plane_dt = abc[0] * (ax - cx) + abc[1] * (ay - cy)
    actual_dt = Y - cz
    inliers = int(np.sum((np.abs(plane_dt - actual_dt) < dtdp / 2) & (Y > 0)))
    if inliers < min_evts:
        return 0.0, 0.0
    speed = 1.0 / dtdp if dtdp != 0 else math.inf
    angle = math.atan2(abc[0], abc[1])            # note arg order, vFlow.cpp:1375
    return speed * math.cos(angle), speed * math.sin(angle)


def _compute_true_flow(flow_len, flow_theta, last_t, x, y, t, kill, scales,
                       x_clamp, y_clamp):
    """Multi-scale aperture correction for one event (vFlow.cpp:952-1095).

    The pol==1 and pol==0 branches of the reference are equivalent because
    both surface sets receive identical writes; a single branch suffices.
    """
    n_scales = len(scales)
    pool_len = np.zeros(n_scales)
    pool_vx = np.zeros(n_scales)
    pool_vy = np.zeros(n_scales)
    for si, s in enumerate(scales):
        x_lo, x_hi = max(0, x - s), min(x + s, x_clamp)
        y_lo, y_hi = max(0, y - s), min(y + s, y_clamp)
        win_len = flow_len[x_lo:x_hi + 1, y_lo:y_hi + 1]
        win_theta = flow_theta[x_lo:x_hi + 1, y_lo:y_hi + 1]
        win_last = last_t[x_lo:x_hi + 1, y_lo:y_hi + 1]
        gate = (win_len > 0) & (np.abs(t - win_last) < kill)
        num = int(gate.sum())
        if num > 0:
            pool_len[si] = float(win_len[gate].sum()) / num
            pool_vx[si] = float((win_len[gate] * np.cos(win_theta[gate])).sum()) / num
            pool_vy[si] = float((win_len[gate] * np.sin(win_theta[gate])).sum()) / num
    # first strict maximum (vFlow.cpp:1052-1059)
    max_val = 0.0
    max_idx = 0
    for si in range(n_scales):
        if pool_len[si] > max_val:
            max_val = pool_len[si]
            max_idx = si
    if max_val > 0:
        return pool_vx[max_idx], pool_vy[max_idx], scales[max_idx]
    # fallback (dead for valid events: the center pixel always pools)
    return (
        flow_len[x, y] * math.cos(flow_theta[x, y]),
        flow_len[x, y] * math.sin(flow_theta[x, y]),
        0,
    )

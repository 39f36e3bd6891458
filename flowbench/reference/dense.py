"""Plain reference of the dense flow semantics, frozen with the benchmark.

A straightforward PyTorch statement of what one micro-step of the dense
engine computes, kept beside the benchmark so that a later change to the
program cannot move the yardstick. It imports nothing of the program: it
takes raw events (x, y, raw microsecond stamps), resolves each scatter
group's winners, the rank-2 correction lanes and the written pixels
itself, and keeps its own surfaces. Each stage computes in the order the
engine's plain path states (left folds over the same cell order, a
float64 integral folded down the columns then along the rows, divisions by
a device tensor), so on one device it agrees with the program bit for bit
where the program is right.

Semantics (the reference C++ program's rules, vFlow.cpp):
- a micro-step of `chunk_size` lanes runs as `sub_phases` chronological
  phases, each scattered as `causal_snapshots` sub-groups; in a sub-group
  the last event at a pixel wins (vFlow.cpp:264-273);
- the time surface holds stamp + 1 ("stamp1", 0 = never written);
- the local plane fit scans 9 candidate windows, fits the winner's plane
  by the 3x3 adjugate solve, gates on det >= threshold and on the inlier
  count (computeGrads, vFlow.cpp:1214-1381), and inverts it to a velocity
  (vFlow.cpp:1373-1377) with the vx != 0 gate (vFlow.cpp:315);
- the flow surfaces take every written pixel's result; entries older than
  the freshness window die (vFlow.cpp:1002, 961);
- the multi-scale aperture pool takes the first strict maximum of the mean
  length over box sums of a float64 integral image (vFlow.cpp:987-1094);
- under `center_correction` the second-latest event of a pixel in a phase
  is refitted at its own stamp against the chunk's chain;
- the wire carries f16 component pairs and an aux byte (valid bit 7,
  scale id below), decoded on the host into the 11 output columns.

`Precision` lowers the arithmetic for the benchmark's control: the same
reference with its float32 stages in bfloat16 and its float64 integral in
float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

_WRAP = 2.0 ** 32
_HALF_WRAP = 2.0 ** 31


@dataclasses.dataclass(frozen=True)
class Precision:
    """Floating types of the reference: `work` for the plane fit, the
    trigonometric tail and the pooling, `integral` for the integral."""
    work: torch.dtype = torch.float32
    integral: torch.dtype = torch.float64


FULL = Precision()
LOWER = Precision(torch.bfloat16, torch.float32)


@dataclasses.dataclass(frozen=True)
class Semantics:
    """The settings of a configuration that the semantics read."""
    width: int
    height: int
    filter_size: int = 3
    min_evts_on_plane: int = 5
    window_jump: int = 5
    max_window: int = 50
    kill_old_flow_time_us: int = 500
    ts_to_sec: float = 1e-6
    det_threshold: float = 1.0
    chunk_size: int = 2048
    sub_phases: int = 1
    aperture_sub_phases: int = 0
    causal_snapshots: int = 1
    center_correction: int = 0
    correction_coarse_chain: bool = False
    wire: str = "f32"
    replicate_y_clamp_quirk: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Semantics":
        names = {f.name for f in dataclasses.fields(cls)}
        s = cls(**{k: v for k, v in d.items() if k in names})
        k = s.filter_size
        k = 3 if k < 5 else k
        k = k - 1 if k % 2 == 0 else k
        return dataclasses.replace(s, filter_size=k)

    @property
    def f_rad(self) -> int:
        return self.filter_size // 2

    @property
    def support_radius(self) -> int:
        return 2 * self.f_rad

    @property
    def scales(self) -> tuple:
        return tuple(range(0, self.max_window + 1, self.window_jump))


# --------------------------------------------------------------------------
# host side: normalisation, winners, rank-2 lanes
# --------------------------------------------------------------------------

def lanes_of(sem: Semantics, x, y, t, t0: int):
    """A stream's lanes padded to whole micro-steps: (flat pixel int64,
    normalised stamp int32, real-lane count). Coordinates clip to the
    sensor; stamps are (t - t0) mod 2^32 in int32 bits; padded lanes take
    the sentinel pixel W*H and the last stamp."""
    W, H = sem.width, sem.height
    n = len(x)
    total = max(1, -(-n // sem.chunk_size)) * sem.chunk_size
    flat = np.full(total, W * H, np.int64)
    flat[:n] = (np.clip(np.asarray(x, np.int64), 0, W - 1) * H
                + np.clip(np.asarray(y, np.int64), 0, H - 1))
    tn = np.zeros(total, np.int32)
    tn[:n] = (np.asarray(t, np.uint32) - np.uint32(t0)).view(np.int32)
    tn[n:] = tn[n - 1] if n else 0
    return flat, tn, n


def last_in_block(flat: np.ndarray, blk: int, sentinel: int) -> np.ndarray:
    """bool per lane: the last lane at its pixel within each block of
    `blk` lanes; sentinel lanes never win."""
    lanes = np.arange(flat.size) % blk
    key = (np.arange(flat.size) // blk) * (sentinel + 1) + flat
    order = np.lexsort((lanes, key))
    ks = key[order]
    last = np.ones(flat.size, bool)
    last[:-1] = ks[:-1] != ks[1:]
    win = np.zeros(flat.size, bool)
    win[order] = last
    return win & (flat < sentinel)


def rank2_lanes(sem: Semantics, flat: np.ndarray, t1: np.ndarray):
    """The correction pass's lanes of one micro-step: (flags uint8 [m],
    centers int32 [W*H] stamp1). In each phase, the last of a pixel's
    non-final lanes; over the step, the latest per pixel; the latest
    `center_correction` of them."""
    m = flat.size
    P = sem.sub_phases
    mp = m // P
    WH = sem.width * sem.height
    flags = np.zeros(m, np.uint8)
    centers = np.zeros(WH, np.int32)
    cand_l, cand_f = [], []
    for p in range(P):
        f = flat[p * mp:(p + 1) * mp]
        final = last_in_block(f, mp, WH)
        nf = np.nonzero(~final & (f < WH))[0]
        if nf.size:
            r2 = last_in_block(f[nf], nf.size, WH)
            cand_l.append(nf[r2] + p * mp)
            cand_f.append(f[nf[r2]])
    if cand_l:
        c = np.concatenate(cand_l)
        fc = np.concatenate(cand_f)
        keep = last_in_block(fc, fc.size, WH)
        c = c[keep][-sem.center_correction:]
        fc = fc[keep][-sem.center_correction:]
        flags[c] = 1
        centers[fc] = t1[c]
    return flags, centers


# --------------------------------------------------------------------------
# device side: the stages of a micro-step
# --------------------------------------------------------------------------

def _full(like: torch.Tensor, value: float, dtype) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=like.device)


def kill_stale(flow_len, t_surf, t_now, sem: Semantics, in_phase=False):
    """Zero flow lengths that can no longer pass the freshness gate; in a
    later aperture group of a phase, stamps of the near future stay."""
    age = (t_now + 1) - t_surf
    if in_phase:
        stale = (((age >= sem.kill_old_flow_time_us) & (age < (1 << 30)))
                 | (age < -(1 << 30)))
    else:
        stale = (age >= sem.kill_old_flow_time_us) | (age < 0)
    return torch.where(stale, torch.zeros_like(flow_len), flow_len)


def plane_fit(chain, center, sem: Semantics, fold_center: bool,
              prec: Precision):
    """The local plane fit of every pixel against the causal view of its
    neighbours folded over `chain` (and `center` when `fold_center`).
    Returns (accept int32, a, b, dtdp) maps."""
    ft = prec.work
    W, H = sem.width, sem.height
    f = sem.f_rad
    R = sem.support_radius
    side = 2 * R + 1
    dev = center.device
    rows, cols = center.shape
    folded = torch.cat([chain, center[None]], 0) if fold_center else chain
    surfs = F.pad(folded, (R, R, R, R))
    px = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    py = torch.arange(cols, dtype=torch.int32, device=dev)[None, :]
    pxf = px.to(ft).expand(rows, cols)
    pyf = py.to(ft).expand(rows, cols)
    t_c = center
    neg_ts = -sem.ts_to_sec
    D, ELI, U, V, YV = [], [], [], [], []
    for ox in range(-R, R + 1):
        for oy in range(-R, R + 1):
            if ox == 0 and oy == 0:
                d = torch.zeros((rows, cols), dtype=ft, device=dev)
                eli = (t_c != 0) & (t_c != 1)
                u = torch.zeros_like(d)
                v = torch.zeros_like(d)
            else:
                sh = surfs[:, R + ox:R + ox + rows, R + oy:R + oy + cols]
                vis = sh[0]
                for s in range(1, sh.shape[0]):
                    vis = torch.where((t_c - sh[s]) >= 0, sh[s], vis)
                tch = vis != 0
                vis = torch.where(vis == 0, 1, vis)
                d = (t_c - vis).to(ft)
                d = torch.where(d < 0, d + _WRAP, d)
                eli = (vis != 1) & (d < _HALF_WRAP)
                u = torch.where(tch, float(ox), -pxf)
                v = torch.where(tch, float(oy), -pyf)
            D.append(d)
            ELI.append(eli)
            U.append(u)
            V.append(v)
            YV.append(d * neg_ts)
    D, ELI, U, V, YV = (torch.stack(q) for q in (D, ELI, U, V, YV))

    cand_offsets = [(a, b) for a in (-f, 0, f) for b in (-f, 0, f)]
    win_cells = [(wx, wy) for wx in range(-f, f + 1)
                 for wy in range(-f, f + 1)]
    n = float(sem.filter_size * sem.filter_size)
    n_t = _full(center, n, ft)
    inf = float("inf")
    best = torch.full((rows, cols), inf, dtype=ft, device=dev)
    bc = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
    for ci, (a, b) in enumerate(cand_offsets):
        ssum = None
        for wx, wy in win_cells:
            c = D[(a + wx + R) * side + (b + wy + R)]
            ssum = c if ssum is None else ssum + c
        score = ssum / n_t
        vm = ((px + (a - f) >= 0) & (px + (a + f) <= W - 1)
              & (py + (b - f) >= 0) & (py + (b + f) <= H - 1))
        scorem = torch.where(vm, score, inf)
        better = scorem < best
        best = torch.where(better, scorem, best)
        bc = torch.where(better, ci, bc)
    local_ok = torch.isfinite(best)

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

    det = (suu * (svv * n - sv * sv)
           - suv * (suv * n - sv * su)
           + su * (suv * sv - svv * su))
    det_ok = det >= sem.det_threshold
    safe = torch.where(det_ok, det, 1.0)
    adj00 = svv * n - sv * sv
    adj01 = su * sv - suv * n
    adj02 = suv * sv - svv * su
    adj11 = suu * n - su * su
    adj12 = su * suv - suu * sv
    a_coef = (adj00 * b0 + adj01 * b1 + adj02 * b2) / safe
    b_coef = (adj01 * b0 + adj11 * b1 + adj12 * b2) / safe
    dtdp = torch.sqrt(a_coef * a_coef + b_coef * b_coef)

    half = dtdp * 0.5
    inl = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
    for eli, u, v, yv in cells:
        hit = (torch.abs(a_coef * u + b_coef * v - yv) < half) & eli
        inl = inl + hit.to(torch.int32)
    accept = local_ok & det_ok & (inl >= sem.min_evts_on_plane)
    return accept.to(torch.int32), a_coef, b_coef, dtdp


# PyTorch's CPU kernels may round atan2, cos and sin differently in their
# vector and scalar loops, and cut long runs between threads; on the CPU
# the tail runs over fixed runs of whole vectors so that a pixel's bits do
# not depend on where it lies in its map.
_RUN_QUANTUM = 64
_RUN = 16384


def velocity(accept, a_coef, b_coef, dtdp):
    """(vx, vy, valid, length) maps: speed 1/dtdp along atan2(a, b),
    valid where both components are finite and nonzero."""
    if accept.device.type != "cpu":
        return _velocity(accept, a_coef, b_coef, dtdp)
    shape, n = accept.shape, accept.numel()
    pad = -n % _RUN_QUANTUM
    flat = [torch.cat([t.reshape(-1), t.new_zeros(pad)])
            for t in (accept, a_coef, b_coef, dtdp)]
    runs = [_velocity(*(t[i:i + _RUN] for t in flat))
            for i in range(0, n + pad, _RUN)]
    return tuple(torch.cat(parts)[:n].reshape(shape) for parts in zip(*runs))


def _velocity(accept, a_coef, b_coef, dtdp):
    acc = accept > 0
    speed = 1.0 / dtdp
    angle = torch.atan2(a_coef, b_coef)
    vx = torch.where(acc, speed * torch.cos(angle), 0.0)
    vy = torch.where(acc, speed * torch.sin(angle), 0.0)
    valid = ~torch.isnan(vx) & ~torch.isnan(vy) & (vx != 0) & (vy != 0)
    length = torch.sqrt(vx * vx + vy * vy)
    return vx, vy, valid, length


def integral(flow_len, flow_vx, flow_vy, prec: Precision):
    """[4, W+1, H+1] integral of (count, len, vx, vy) gated by len > 0: a
    sequential fold down each column, then along each row."""
    gate = (flow_len > 0).to(flow_len.dtype)
    fields = torch.stack(
        [gate, flow_len * gate, flow_vx * gate, flow_vy * gate], 0)
    integ = torch.cumsum(fields.to(prec.integral), 1)
    integ = torch.cumsum(integ.transpose(1, 2), 1).transpose(1, 2)
    return F.pad(integ, (1, 0, 1, 0))


def pool(flow_len, flow_vx, flow_vy, sem: Semantics, prec: Precision):
    """Multi-scale aperture pooling of every pixel: (tvx, tvy, scale)."""
    ft = prec.work
    integ = integral(flow_len, flow_vx, flow_vy, prec)
    rows, cols = flow_vx.shape
    dev = flow_vx.device
    xi = integ.shape[1] - 1
    y_hi = (sem.width if sem.replicate_y_clamp_quirk else sem.height) - 1
    yc = min(y_hi + 1, sem.height)
    px = torch.arange(rows, dtype=torch.int64, device=dev)
    py = torch.arange(cols, dtype=torch.int64, device=dev)
    one = _full(flow_vx, 1.0, ft)
    best_ml = torch.full((rows, cols), -1.0, dtype=ft, device=dev)
    best_vx = torch.zeros((rows, cols), dtype=ft, device=dev)
    best_vy = torch.zeros_like(best_vx)
    best_s = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
    for s in sem.scales:
        xh = torch.clamp(px + s + 1, 0, xi)[:, None]
        xl = torch.clamp(px - s, 0, xi)[:, None]
        yh = torch.clamp(py + s + 1, 0, yc)[None, :]
        yl = torch.clamp(py - s, 0, yc)[None, :]
        box = (integ[:, xh, yh] - integ[:, xl, yh]
               - integ[:, xh, yl] + integ[:, xl, yl]).to(ft)
        cnt = box[0]
        has = cnt > 0.5
        safe = torch.where(has, cnt, one)
        ml = torch.where(has, box[1] / safe, 0.0)
        better = ml > best_ml
        best_ml = torch.where(better, ml, best_ml)
        best_vx = torch.where(better, box[2] / safe, best_vx)
        best_vy = torch.where(better, box[3] / safe, best_vy)
        best_s = torch.where(better, s, best_s)
    pooled = best_ml > 0
    tvx = torch.where(pooled, best_vx, flow_vx)
    tvy = torch.where(pooled, best_vy, flow_vy)
    scale = torch.where(pooled, best_s, 0)
    return tvx, tvy, scale


def _f16_pair(a, b):
    """Two maps as one int32 map of f16 bit halves (a low), saturating."""
    pair = torch.stack([torch.clamp(a, -65504.0, 65504.0).half(),
                        torch.clamp(b, -65504.0, 65504.0).half()], -1)
    return pair.view(torch.int32).squeeze(-1)


def _scrub(a):
    return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)


def _table(a, b, last, packed: bool):
    """[F, W, H] float32 rows of the wire: (a, b) as one f16 pair (its
    int32 bits viewed as float32) or as two float32 rows, then `last`."""
    last = last.to(torch.float32)
    if packed:
        return torch.stack([_f16_pair(_scrub(a), _scrub(b))
                            .view(torch.float32), last])
    return torch.stack([_scrub(a).float(), _scrub(b).float(), last])


def _merge(loc, tf, sem: Semantics, packed: bool):
    """Wire rows of gathered plane-fit rows `loc` and aperture rows `tf`:
    the true flow and aux byte gated by the plane fit's validity."""
    gate = loc[-1] != 0
    aux_f = torch.where(gate, 128 + tf[-1] // sem.window_jump, 0.0)
    if packed:
        # gate the pair's bits as integers: a select on float32 values
        # need not keep every bit pattern
        pair = torch.where(gate, tf[0].view(torch.int32), 0)
        return torch.stack([loc[0], pair.view(torch.float32), aux_f])
    return torch.stack([loc[0], loc[1], torch.where(gate, tf[0], 0.0),
                        torch.where(gate, tf[1], 0.0), aux_f])


def _take(tables: list, idx: torch.Tensor) -> torch.Tensor:
    """Columns `idx` = table * W*H + pixel of [F, W, H] tables laid end
    to end, a zero column past them for the sentinel pixel."""
    F_ = tables[0].shape[0]
    flat = torch.cat([t.reshape(F_, -1) for t in tables]
                     + [tables[0].new_zeros((F_, 1))], 1)
    return flat[:, idx]


class Reference:
    """The semantics' surfaces, advanced one micro-step at a time."""

    def __init__(self, sem: Semantics, device, prec: Precision = FULL):
        self.sem = sem
        self.device = torch.device(device)
        self.prec = prec
        W, H = sem.width, sem.height
        z = dict(dtype=prec.work, device=self.device)
        self.t_surf = torch.zeros((W, H), dtype=torch.int32,
                                  device=self.device)
        self.flow_len = torch.zeros((W, H), **z)
        self.flow_vx = torch.zeros((W, H), **z)
        self.flow_vy = torch.zeros((W, H), **z)

    def set_state(self, t_surf, flow_len, flow_vx, flow_vy) -> None:
        """Adopt [W, H] surfaces (stamp1 int32; flow in any float type)."""
        def put(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(self.device, dtype)
        self.t_surf = put(t_surf, torch.int32)
        self.flow_len = put(flow_len, self.prec.work)
        self.flow_vx = put(flow_vx, self.prec.work)
        self.flow_vy = put(flow_vy, self.prec.work)

    def state(self) -> dict:
        """The surfaces as host arrays (flow as float32)."""
        return {"t_surf": self.t_surf.cpu().numpy(),
                **{k: getattr(self, k).float().cpu().numpy()
                   for k in ("flow_len", "flow_vx", "flow_vy")}}

    def run(self, x, y, t, t0: int) -> dict:
        """Advance over a stream (padded to whole micro-steps) and return
        the 7 decoded output columns of its real lanes."""
        sem = self.sem
        flat, tn, n = lanes_of(sem, x, y, t, t0)
        m = sem.chunk_size
        mains, auxs = [], []
        for s in range(flat.size // m):
            main, aux = self.step(flat[s * m:(s + 1) * m],
                                  tn[s * m:(s + 1) * m])
            mains.append(main.cpu().numpy())
            auxs.append(aux.cpu().numpy())
        main = np.concatenate(mains, axis=1)[:, :n]
        aux = np.concatenate(auxs)[:n]
        return decode_wire(main, aux, sem)

    def step(self, flat: np.ndarray, tn: np.ndarray):
        """One micro-step of m lanes (host flat pixels and normalised
        stamps); returns the wire (int32 [C, m], uint8 [m])."""
        sem, prec = self.sem, self.prec
        dev = self.device
        W, H = sem.width, sem.height
        WH = W * H
        m = flat.size
        P = sem.sub_phases if m % sem.sub_phases == 0 else 1
        S = (sem.causal_snapshots
             if (m // P) % sem.causal_snapshots == 0 else 1)
        links = ((S - 1,) if sem.correction_coarse_chain
                 else tuple(range(S)))
        mp, ms = m // P, m // P // S
        A = sem.aperture_sub_phases
        coarse = A if A and A < P and P % A == 0 else 0
        corr = sem.center_correction > 0
        k = max(1, A // P) if A else 1
        if mp % k or corr:
            k = 1
        mg = mp // k
        packed = sem.wire != "f32"

        win = last_in_block(flat, ms, WH)
        t1_host = (tn.astype(np.int64) + 1).astype(np.int32)
        if corr:
            r2f, r2c = rank2_lanes(sem, flat, t1_host)
            r2f = torch.from_numpy(r2f).to(dev)
            r2c = torch.from_numpy(r2c).to(dev).view(W, H)
        pix = torch.from_numpy(flat).to(dev)
        wpix = torch.where(torch.from_numpy(win).to(dev), pix, WH)
        t = torch.from_numpy(tn).to(dev)
        t1 = t + 1

        t_surf = self.t_surf
        flow_len, flow_vx, flow_vy = self.flow_len, self.flow_vx, self.flow_vy
        chunk_chain = [t_surf] if corr else None
        loc_maps, ap_tables, pending, lanes_out = [], [], [], []

        def scatter(surf, idx, values):
            buf = torch.cat([surf.reshape(-1), surf.new_zeros(1)])
            buf[idx] = values
            return buf[:WH].view(W, H)

        def gather(maps, sl):
            flatm = torch.cat([maps.reshape(maps.shape[0], WH),
                               maps.new_zeros((maps.shape[0], 1))], 1)
            return flatm[:, pix[sl]]

        for p in range(P):
            sl = slice(p * mp, (p + 1) * mp)
            if not coarse or p % (P // coarse) == 0:
                flow_len = kill_stale(flow_len, t_surf, t[p * mp], sem)
            t_pre = t_surf
            snaps = []
            for si in range(S):
                ssl = slice(p * mp + si * ms, p * mp + (si + 1) * ms)
                t_surf = scatter(t_surf, wpix[ssl], t1[ssl])
                if si < S - 1:
                    snaps.append(t_surf)
                if corr and si in links:
                    chunk_chain.append(t_surf)
            written = scatter(torch.zeros((W, H), dtype=torch.bool,
                                          device=dev), wpix[sl], True)

            chain = torch.stack([t_pre, *snaps]) if snaps else t_pre[None]
            acc, a_c, b_c, dtdp = plane_fit(chain, t_surf, sem, True, prec)
            vx_map, vy_map, gate_map, len_map = velocity(acc, a_c, b_c, dtdp)
            flow_len = torch.where(written,
                                   torch.where(gate_map, len_map, 0.0),
                                   flow_len)
            flow_vx = torch.where(written,
                                  torch.where(gate_map, vx_map, 0.0), flow_vx)
            flow_vy = torch.where(written,
                                  torch.where(gate_map, vy_map, 0.0), flow_vy)

            if coarse:
                loc = _table(vx_map, vy_map, gate_map, packed)
                if corr:
                    loc_maps.append(loc)
                else:
                    pending.append((sl, gather(loc, sl)))
                if (p + 1) % (P // coarse) == 0:
                    amaps = _table(*pool(flow_len, flow_vx, flow_vy, sem,
                                         prec), packed)
                    if corr:
                        ap_tables.append(amaps)
                    for psl, gloc in pending:
                        lanes_out.append(_merge(gloc, gather(amaps, psl),
                                                sem, packed))
                    pending = []
                continue
            for g in range(k):
                if g:
                    flow_len = kill_stale(flow_len, t_surf,
                                          t[p * mp + g * mg], sem,
                                          in_phase=True)
                tvx, tvy, scale = pool(flow_len, flow_vx, flow_vy, sem, prec)
                loc = _table(vx_map, vy_map, gate_map, packed)
                tf = _table(tvx, tvy, scale, packed)
                if corr:
                    ap_tables.append(tf)
                    loc_maps.append(loc)
                    continue
                gsl = slice(p * mp + g * mg, p * mp + (g + 1) * mg)
                lanes_out.append(_merge(gather(loc, gsl), gather(tf, gsl),
                                        sem, packed))

        if corr:
            acc2, a2, b2, dtdp2 = plane_fit(torch.stack(chunk_chain), r2c,
                                            sem, False, prec)
            vx2, vy2, gate2, _ = velocity(acc2, a2, b2, dtdp2)
            loc_maps.append(_table(vx2, vy2, gate2, packed))
            lane = torch.arange(m, device=dev)
            table = torch.where(r2f != 0, len(loc_maps) - 1, lane // mp)
            loc = _take(loc_maps, table * WH + pix)
            tf = _take(ap_tables, lane // (m // len(ap_tables)) * WH + pix)
            rows = _merge(loc, tf, sem, packed)
        else:
            rows = torch.cat(lanes_out, 1)

        self.t_surf = t_surf
        self.flow_len, self.flow_vx, self.flow_vy = flow_len, flow_vx, flow_vy
        aux = rows[-1].to(torch.uint8)
        if packed:
            return rows[:2].view(torch.int32), aux
        return rows[:4].contiguous().view(torch.int32), aux


def decode_wire(main: np.ndarray, aux: np.ndarray, sem: Semantics) -> dict:
    """The 7 per-lane output columns of wire rows (int32 [C, k], uint8
    [k]): the f16 pairs (or float32 rows) unpacked, the valid bit and the
    scale id of the aux byte, magnitudes and angles in float32
    (vFlow.cpp:370-396); invalid lanes keep their raw vx, vy and zeros
    elsewhere."""
    if sem.wire != "f32":
        p0 = main[0].view(np.uint32)
        p1 = main[1].view(np.uint32)

        def half(bits):
            return bits.astype(np.uint16).view(np.float16).astype(np.float32)

        vx, vy = half(p0 & 0xFFFF), half(p0 >> 16)
        tvx, tvy = half(p1 & 0xFFFF), half(p1 >> 16)
    else:
        vx, vy, tvx, tvy = (main[i].view(np.float32) for i in range(4))
    valid = (aux & 0x80) != 0
    scale = (aux & 0x7F).astype(np.int32) * sem.window_jump
    with np.errstate(invalid="ignore", over="ignore"):
        r_true = np.sqrt(tvx * tvx + tvy * tvy)
        theta_true = np.arctan2(tvy, tvx)
        length = np.sqrt(vx * vx + vy * vy)
        theta_l = np.arctan2(vy, vx)
    zero = np.float32(0.0)
    return dict(r_true=r_true, theta_true=theta_true, vx=vx, vy=vy,
                r_local=np.where(valid, length, zero),
                theta_local=np.where(valid, theta_l, zero), scale=scale)

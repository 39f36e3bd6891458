"""Event-serial streaming mode with per-event phase timing.

Counterpart of `farms_tpu.pipeline.serial`, the reference's serial mode
`run()` (vFlow.cpp:465-826): each event is processed on its own against
the surfaces every earlier event built, with the two compute phases timed
separately and printed as running totals -

    Local <us> <cumulative us>      (every event, vFlow.cpp:641)
    true <us> <cumulative us>       (valid local flow only, vFlow.cpp:719)

- and no output file is written (the reference's writes are commented out,
vFlow.cpp:488-489, 730-737). The returned duration is compute-only
microseconds, the sum of the phase brackets, which is what the reference's
`run()` returns to main's benchmark line (main.cpp:197-200). Each bracket
ends at the host read of its phase's result, which waits for the device.

The phases are the per-event engine's ops at one event
(ops/local_flow.py, ops/aperture.py), so the results equal the chunked
engine's at chunk_size=1 with use_dense=False. They are returned as a
FlowOutput for callers to inspect (the reference discards them).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, FlowOutput
from farms_tpu_torch.ops import _build
from farms_tpu_torch.ops.aperture import aperture_batch, build_integral
from farms_tpu_torch.ops.local_flow import local_flow_batch
from farms_tpu_torch.pipeline.engine import _empty_output, _scatter
from farms_tpu_torch.state.surfaces import (SurfaceState, init_state,
                                            kill_stale_flow)


def _local_phase(state: SurfaceState, x, y, t, cfg: FlowConfig):
    """The staleness kill, the event's stamp and write epoch, and its local
    plane fit (computeLocalFlow, vFlow.cpp:841-949): micro_step's per-event
    phase at m = 1. x, y, t: [1] device tensors (t the normalized stamp)."""
    t1 = t + 1                                  # stamp1 encoding
    pix = x * cfg.height + y
    flow_len = kill_stale_flow(state.flow_len, state.t_surf, t[0], cfg)
    t_surf = _scatter(state.t_surf, pix, t1)
    epoch = _scatter(state.epoch, pix, state.step)
    fit = local_flow_batch(state.t_surf, t_surf, x, y, t1, cfg)
    return SurfaceState(t_surf, epoch, flow_len, state.flow_vx,
                        state.flow_vy, state.step), fit


def _true_phase(state: SurfaceState, x, y, vx, vy, length,
                cfg: FlowConfig):
    """The flow-surface write and the multi-scale aperture pooling of one
    valid event (the reference's timed true-flow bracket,
    vFlow.cpp:652-719)."""
    pix = x * cfg.height + y
    flow_len = _scatter(state.flow_len, pix, length)
    flow_vx = _scatter(state.flow_vx, pix, vx)
    flow_vy = _scatter(state.flow_vy, pix, vy)
    true = aperture_batch(build_integral(flow_len, flow_vx, flow_vy),
                          flow_vx, flow_vy, x, y, cfg)
    return SurfaceState(state.t_surf, state.epoch, flow_len, flow_vx,
                        flow_vy, state.step + 1), true


def _invalid_phase(state: SurfaceState, x, y, cfg: FlowConfig):
    """Invalid local flow: zero the pixel's flow surfaces
    (vFlow.cpp:771-775)."""
    pix = x * cfg.height + y
    return SurfaceState(state.t_surf, state.epoch,
                        _scatter(state.flow_len, pix, 0.0),
                        _scatter(state.flow_vx, pix, 0.0),
                        _scatter(state.flow_vy, pix, 0.0), state.step + 1)


class SerialFlowEngine:
    """Streaming per-event engine (the reference's `--SERIAL 1` mode).

    Runs on `device` (cuda by default; a CUDA request without CUDA
    raises). The t0 latch and the surfaces carry across run() calls.
    """

    def __init__(self, cfg: FlowConfig, device="cuda", print_fn=print):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        if device.type == "cuda":
            _build.load()               # the integral kernel, built now
        self.cfg = cfg
        self.device = device
        self.state = init_state(cfg, device)
        self._t0 = None
        self._print = print_fn

    def run(self, ev: EventBatch, quiet: bool = False):
        """Process events one by one with per-phase timing prints.

        Returns (FlowOutput, compute_us): the flow results and the summed
        compute-only microseconds (the reference run()'s return value).
        """
        cfg = self.cfg
        n = len(ev)
        if n == 0:
            return _empty_output(), 0
        if self._t0 is None:
            self._t0 = np.uint32(ev.t[0])
        xs = np.clip(ev.x.astype(np.int64), 0, cfg.width - 1)
        ys = np.clip(ev.y.astype(np.int64), 0, cfg.height - 1)
        ts = (ev.t.astype(np.uint32) - self._t0).view(np.int32)
        # the whole stream goes up once; each event is a view of it
        xd, yd, td = (torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (xs, ys, ts))

        cols = np.zeros((n, 7), dtype=np.float64)
        local_cum = 0     # durationEventsLocalShow, vFlow.cpp:640
        true_cum = 0      # durationEventsTrueShow, vFlow.cpp:718
        compute_us = 0    # durationEvents (returned), vFlow.cpp:645, 723
        for i in range(n):
            x, y, t = xd[i:i + 1], yd[i:i + 1], td[i:i + 1]

            t_a = time.perf_counter()
            self.state, (vx, vy, gate, length, theta) = _local_phase(
                self.state, x, y, t, cfg)
            loc = torch.stack([vx, vy, gate.to(torch.float32), length,
                               theta])[:, 0].cpu().numpy()
            d_local = int((time.perf_counter() - t_a) * 1e6)
            local_cum += d_local
            compute_us += d_local
            if not quiet:
                self._print(f"Local {d_local} {local_cum}")

            vxf, vyf, valid, lf, thf = (float(v) for v in loc)
            if valid:
                t_b = time.perf_counter()
                self.state, (tvx, tvy, scale) = _true_phase(
                    self.state, x, y, vx, vy, length, cfg)
                tru = torch.stack([tvx, tvy, scale.to(torch.float32)])[
                    :, 0].cpu().numpy()
                d_true = int((time.perf_counter() - t_b) * 1e6)
                true_cum += d_true
                compute_us += d_true
                if not quiet:
                    self._print(f"true {d_true} {true_cum}")
                a32, b32 = tru[0], tru[1]       # f32, as the wire decode
                r_true = float(np.sqrt(a32 * a32 + b32 * b32,
                                       dtype=np.float32))
                th_true = float(np.arctan2(b32, a32, dtype=np.float32))
                cols[i] = (r_true, th_true, vxf, vyf, lf, thf,
                           float(tru[2]))
            else:
                self.state = _invalid_phase(self.state, x, y, cfg)
                # invalid rows keep raw (possibly NaN) vx/vy, zeros
                # elsewhere (vFlow.cpp:390-395)
                cols[i] = (0.0, 0.0, vxf, vyf, 0.0, 0.0, 0.0)

        return FlowOutput(
            x=xs.astype(np.int32), y=ys.astype(np.int32),
            t=(ev.t.astype(np.uint32) - self._t0).astype(np.uint32),
            pol=ev.pol.astype(np.int32),
            r_true=cols[:, 0], theta_true=cols[:, 1],
            vx=cols[:, 2], vy=cols[:, 3],
            r_local=cols[:, 4], theta_local=cols[:, 5],
            scale=cols[:, 6].astype(np.int32),
        ), compute_us

"""Device-resident surface state of the flow engine.

Counterpart of `farms_tpu.state.surfaces`: the reference's seven W x H
EventMatrix surfaces (vFlow.cpp:47-93) collapsed to four maps + a step
counter, all [W, H] and x-major (flat pixel index x*H + y, which the host
packers and the wire share). A config with a padded array geometry
(`FlowConfig.padded_to`, the sharded engines) holds them at
[array_width, array_height] instead: the pad cells are never written, so
they read as "never written" and as zero flow, which is what the stencils
read past the sensor edge. Checkpoints keep the semantic [W, H]
(`pad_state`, `strip_state`):

- `t_surf` stores **stamp + 1** ("stamp1" encoding): 0 means "never
  written" (the Event(0,0,0,0) initializer, vFlow.cpp:80-93), 1 means
  "written at normalized stamp 0", any other value v means "written at
  stamp v - 1" (mod 2^32). Values are uint32 bit patterns stored in int32,
  so consumers compare in the unsigned domain: equality tests against 0/1
  and int32 *differences* are exact, signed </>/max are not once stamps
  pass 2^31 (~35.8 min of stream). The touched test is `v != 0`, the
  inlier-eligibility `stamp > 0` is `v not in {0, 1}`. A raw stamp of
  exactly 2^32 - 1 encodes to 0 and reads back as "never written" until
  that pixel's next write.
- `epoch` records the write epoch (step * sub_phases + phase) of each
  pixel's last write; a phase's written pixels are those holding its
  epoch (micro_step); -1 = never.
- `flow_len/vx/vy` replace the reference's On/Off flow surfaces, which
  always receive identical writes (vFlow.cpp:349-356).
- `step` is the micro-step counter, a host integer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from farms_tpu_torch.config import FlowConfig


@dataclasses.dataclass
class SurfaceState:
    t_surf: torch.Tensor    # int32 [W, H] stamp1: most-recent stamp (us) + 1
    epoch: torch.Tensor     # int32 [W, H] write epoch of last write (-1 = never)
    flow_len: torch.Tensor  # f32   [W, H] local flow magnitude of last valid event
    flow_vx: torch.Tensor   # f32   [W, H]
    flow_vy: torch.Tensor   # f32   [W, H]
    step: int               # micro-step counter


def init_state(cfg: FlowConfig, device) -> SurfaceState:
    W, H = cfg.array_width, cfg.array_height
    return SurfaceState(
        t_surf=torch.zeros((W, H), dtype=torch.int32, device=device),
        epoch=torch.full((W, H), -1, dtype=torch.int32, device=device),
        flow_len=torch.zeros((W, H), dtype=torch.float32, device=device),
        flow_vx=torch.zeros((W, H), dtype=torch.float32, device=device),
        flow_vy=torch.zeros((W, H), dtype=torch.float32, device=device),
        step=0,
    )


def state_from_numpy(t_surf, epoch, flow_len, flow_vx, flow_vy, step,
                     device) -> SurfaceState:
    """Build a state from host arrays, e.g. a `farms_tpu` state or checkpoint."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)

    return SurfaceState(
        t_surf=put(t_surf, np.int32),
        epoch=put(epoch, np.int32),
        flow_len=put(flow_len, np.float32),
        flow_vx=put(flow_vx, np.float32),
        flow_vy=put(flow_vy, np.float32),
        step=int(np.asarray(step)),
    )


def pad_state(state: SurfaceState, cfg: FlowConfig) -> SurfaceState:
    """A [W, H] state at the semantic geometry padded to the array
    geometry: pad cells never written (stamp1 0, epoch -1, zero flow)."""
    pad = (0, cfg.array_height - cfg.height, 0, cfg.array_width - cfg.width)
    if not any(pad):
        return state

    def put(a, fill):
        return torch.nn.functional.pad(a, pad, value=fill)

    return SurfaceState(put(state.t_surf, 0), put(state.epoch, -1),
                        put(state.flow_len, 0.0), put(state.flow_vx, 0.0),
                        put(state.flow_vy, 0.0), state.step)


def strip_state(state: SurfaceState, cfg: FlowConfig) -> SurfaceState:
    """The semantic [W, H] cells of an array-geometry state."""
    W, H = cfg.width, cfg.height
    if tuple(state.t_surf.shape) == (W, H):
        return state

    def cut(a):
        return a[:W, :H].contiguous()

    return SurfaceState(cut(state.t_surf), cut(state.epoch),
                        cut(state.flow_len), cut(state.flow_vx),
                        cut(state.flow_vy), state.step)


def kill_stale_flow(flow_len: torch.Tensor, t_surf: torch.Tensor, t_now,
                    cfg: FlowConfig) -> torch.Tensor:
    """Zero flow entries that can never again pass the freshness gate.

    The reference gates pooling on |t_ev - last_t| < 500us per query
    (vFlow.cpp:1002). Events are chronological, so once t_now - last_t >=
    500us the pixel is dead for every future query unless rewritten:
    zeroing its length here is exact. `t_now` is a normalized stamp (0-d
    int32 tensor); both sides are stamp1, so the int32 difference is the
    real age (negative => ancient, past the wrap).
    """
    age = (t_now + 1) - t_surf
    stale = (age >= cfg.kill_old_flow_time_us) | (age < 0)
    return torch.where(stale, torch.zeros_like(flow_len), flow_len)


def kill_stale_flow_in_phase(flow_len: torch.Tensor, t_surf: torch.Tensor,
                             t_now, cfg: FlowConfig) -> torch.Tensor:
    """The staleness kill at a later aperture group's start inside a phase.

    With aperture_sub_phases finer than sub_phases, the phase's scatter
    has already written stamps of the group's later events, which sit in
    the near future of `t_now` (negative ages) and are fresh for the
    queries that follow. So only entries that are old (age >= the kill
    window, up to 2^30) or ancient (wrapped past -2^30) die; the age is
    the same int32 difference as in kill_stale_flow.
    """
    age = (t_now + 1) - t_surf
    stale = (((age >= cfg.kill_old_flow_time_us) & (age < (1 << 30)))
             | (age < -(1 << 30)))
    return torch.where(stale, torch.zeros_like(flow_len), flow_len)

"""Per-event multi-scale aperture pooling over the integral image.

Counterpart of `farms_tpu.ops.aperture`: for each event and each scale s,
the reference rescans the (2s+1)^2 window around the event
(vFlow.cpp:987-1045) and pools, over pixels with a fresh flow, the count,
the lengths and the two flow components. Those pools are box sums, so each
(event, scale) takes 4 corner reads of the integral image of the gated
fields (count, len, vx, vy). The scale of the first strict maximum of the
mean length wins (vFlow.cpp:1052-1059); where no window pools anything
the event keeps its own (center) flow at scale 0 (vFlow.cpp:1086-1094).
The freshness gate is applied upstream by the staleness kill
(state/surfaces.py).

The integral is the port's float64 one (ops/kernels.integral: the
hand-written kernel on the card, ops/dense_flow.build_integral on the
CPU; the two agree bit for bit), and the box sums are rounded once to f32,
as the dense path's aperture pass does. `farms_tpu` builds an f32
integral with cumsum, and f32 cumsums of different summation orders
(XLA's, torch's on the CPU and on CUDA, NumPy's) disagree, which at an
exact tie between scales (an isolated flow pixel has the same mean length
at every scale whose window holds only it) picks a scale by rounding
noise; in float64 such a tie resolves to the first scale, as in the
float64 oracle. Against `farms_tpu`, scale ids are therefore compared
outside float64 near-ties (pipeline/ties.py).
"""
from __future__ import annotations

import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.ops import kernels
from farms_tpu_torch.ops.dense_flow import _full


def build_integral(flow_len: torch.Tensor, flow_vx: torch.Tensor,
                   flow_vy: torch.Tensor) -> torch.Tensor:
    """The float64 integral image [4, W+1, H+1] of the gated fields
    (count, len, vx, vy), gated by len > 0, with a leading zero row and
    column: the integral kernel on a CUDA tensor (counted in
    kernels.LAUNCHES), its plain version on a CPU one."""
    return kernels.integral(flow_len, flow_vx, flow_vy)


def aperture_batch(integral: torch.Tensor, flow_vx: torch.Tensor,
                   flow_vy: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   cfg: FlowConfig):
    """Pool flow over the scale pyramid and pick each event's scale.

    integral: float64 [4, W+1, H+1] from build_integral; flow_vx/vy: f32
    [W, H] (for the center fallback); x, y: integer [m] event pixels.
    Returns (true_vx f32, true_vy f32, scale int32), each [m].
    """
    W, H = cfg.width, cfg.height
    dev = flow_vx.device
    scales = torch.arange(0, cfg.max_window + 1, cfg.window_jump,
                          dtype=torch.int64, device=dev)     # cfg.scales
    # the reference clamps the window's y-range with the width under its
    # quirk (vFlow.cpp:998)
    y_clamp = (W if cfg.replicate_y_clamp_quirk else H) - 1
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    xs, ys = x[:, None], y[:, None]
    x0 = (xs - scales).clamp(min=0)                       # [m, S]
    x1 = (xs + scales).clamp(max=W - 1)
    y0 = (ys - scales).clamp(min=0)
    y1 = (ys + scales).clamp(max=y_clamp)
    # a corner past the integral's last column (the quirk with W > H)
    # reads that column, as farms_tpu's clamped gather does
    xh, yh = x1 + 1, (y1 + 1).clamp(max=H)
    flat = integral.reshape(4, -1)

    def corner(ix, iy):
        return flat[:, ix * (H + 1) + iy]                 # [4, m, S]

    box = (corner(xh, yh) - corner(x0, yh) - corner(xh, y0)
           + corner(x0, y0)).to(torch.float32)
    cnt = box[0]
    has = cnt > 0.5
    safe = torch.where(has, cnt, _full(cnt, 1.0))
    mean_len = torch.where(has, box[1] / safe, 0.0)
    best = mean_len.argmax(1, keepdim=True)               # first maximum
    pooled = mean_len.gather(1, best)[:, 0] > 0
    best_vx = (box[2] / safe).gather(1, best)[:, 0]
    best_vy = (box[3] / safe).gather(1, best)[:, 0]
    # fallback: the center flow at scale 0 (a padded lane's sentinel
    # pixel reads the clamped one, as in farms_tpu)
    cx, cy = x.clamp(0, W - 1), y.clamp(0, H - 1)
    true_vx = torch.where(pooled, best_vx, flow_vx[cx, cy])
    true_vy = torch.where(pooled, best_vy, flow_vy[cx, cy])
    scale = torch.where(pooled, scales[best[:, 0]], 0).to(torch.int32)
    return true_vx, true_vy, scale

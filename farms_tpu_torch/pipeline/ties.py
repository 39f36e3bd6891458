"""Float64 ties of the aperture stage's scale choice between two runs.

An isolated flow pixel has the same mean length at every scale whose
window holds only it, so two runs whose box sums associate differently
(an f32 integral, or the halo engine's per-shard partials) may pick
different scales with equal means. `scale_ties` finds the lanes where
two outputs chose different scales whose mean lengths are equal within
1e-5 relative, in float64 box sums of the flow_len surface each lane's
aperture pass read. Used by the tests and chip_smoke.py; the engines do
not call it.
"""
from __future__ import annotations

import numpy as np
import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.ops.dense_flow import aperture_y_clip, build_integral


def scale_means_f64(flow_len: torch.Tensor, x, y,
                    cfg: FlowConfig) -> np.ndarray:
    """Mean flow length of each scale's window around pixels (x, y):
    float64 box sums of the port's integral image, [n_scales, n]."""
    integ = build_integral(flow_len, flow_len, flow_len)[:2].cpu().numpy()
    yc = aperture_y_clip(cfg)
    x = np.asarray(x).astype(np.int64)
    y = np.asarray(y).astype(np.int64)
    means = []
    for s in cfg.scales:
        xh, xl = np.minimum(x + s + 1, cfg.width), np.maximum(x - s, 0)
        yh, yl = np.clip(y + s + 1, 0, yc), np.clip(y - s, 0, yc)
        box = (integ[:, xh, yh] - integ[:, xl, yh]
               - integ[:, xh, yl] + integ[:, xl, yl])
        means.append(np.where(box[0] > 0.5,
                              box[1] / np.maximum(box[0], 1.0), 0.0))
    return np.stack(means)


def aperture_passes(cfg: FlowConfig) -> int:
    """Aperture passes per micro-step: A for coarse pooling (A < P, a
    divisor of P), P * A / P for fine pooling (A > P; one per phase under
    correction or where A / P does not divide the phase), else P."""
    P, A = cfg.sub_phases, cfg.aperture_sub_phases
    if A and A < P and P % A == 0:
        return A
    k = max(1, A // P) if A else 1
    if (cfg.chunk_size // P) % k or cfg.center_correction:
        k = 1
    return P * k


def scale_ties(a, b, passes, cfg: FlowConfig) -> np.ndarray:
    """Lanes of two FlowOutputs a, b (same lanes) whose scale ids differ
    and are tied; `passes` are the flow_len surfaces the aperture passes
    read, in pass order (micro-step, then pass).

    With n aperture passes per micro-step, lane i ran in pass
    (i // m) * n + (i % m) // (m / n).
    """
    m, n = cfg.chunk_size, aperture_passes(cfg)
    lane = np.arange(len(b.scale))
    pass_of = (lane // m) * n + (lane % m) // (m // n)
    assert len(passes) >= pass_of[-1] + 1
    tied = np.zeros(len(lane), dtype=bool)
    differ = np.nonzero(a.scale != b.scale)[0]
    for c in np.unique(pass_of[differ]):
        li = differ[pass_of[differ] == c]
        ml = scale_means_f64(passes[c], b.x[li], b.y[li], cfg)
        cols = np.arange(li.size)
        ma = ml[a.scale[li].astype(np.int64) // cfg.window_jump, cols]
        mb = ml[b.scale[li].astype(np.int64) // cfg.window_jump, cols]
        tied[li] = np.abs(mb - ma) <= 1e-5 * (np.abs(mb) + 1e-6)
    return tied

"""The least time the card could take for a kernel's work, from shapes.

Peaks of one NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of device
memory, 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the
tensor cores. A bound is the larger of the bytes over the memory rate and
the operations over their rates, each input read once and each output
written once. The counts are those of the port's kernel checks (the
plane fit's per-pixel operations, the aperture pass's reads, writes and
float64 sums); a serial chain of any one implementation is not counted.
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12


def bound_s(n_bytes: float, f32_ops: float, f64_ops: float = 0.0) -> float:
    return max(n_bytes / PEAK_BYTES, f32_ops / PEAK_F32 + f64_ops / PEAK_F64)


def local_flow_pass(k: int, n_chain: int, pixels: int) -> float:
    """One plane fit over `pixels`: it reads `n_chain` int32 surfaces and
    the centre surface and writes five 4-byte maps (accept, a, b, dtdp,
    candidate). Per pixel: for each of 9 candidates, k^2 cells of (d,
    sum), a division and a compare; k^2 cells of the winner's sums (d,
    yv, 5 products, 8 sums); 46 for the adjugate solve; k^2 cells of the
    inlier test (d, yv, 2 products, 2 sums, abs, compare)."""
    per_pixel = 9 * (2 * k * k + 2) + 15 * k * k + 46 + 8 * k * k
    return bound_s((n_chain + 1) * pixels * 4 + 5 * pixels * 4,
                   per_pixel * pixels)


def aperture_pass(n_scales: int, pixels: int) -> float:
    """One aperture pass (the float64 integral and the pool) over
    `pixels`: it reads flow_len, vx and vy and writes tvx, tvy and the
    scale (4-byte maps each). Per pixel: f32, a compare and 3 products for
    the gated fields, then per scale a compare, 3 divisions and a compare,
    and one more compare; f64, 2 sums for each of 4 fields, then per scale
    3 corner sums for each of 4 fields."""
    return bound_s(6 * pixels * 4, (4 + 5 * n_scales + 1) * pixels,
                   (8 + 12 * n_scales) * pixels)


def _phasing(flow: dict) -> tuple:
    m = flow["chunk_size"]
    P = flow.get("sub_phases", 1)
    P = P if m % P == 0 else 1
    S = flow.get("causal_snapshots", 1)
    S = S if (m // P) % S == 0 else 1
    return P, S


def local_flow_step(flow: dict) -> float:
    """The bound (seconds) of the plane fits of one micro-step: one pass
    a phase over its snapshot chain, and under the centre correction one
    more over the chunk's chain (the phase's last sub-group, or every
    one, each phase)."""
    P, S = _phasing(flow)
    px = flow["width"] * flow["height"]
    k = flow.get("filter_size", 3)
    k = 3 if k < 5 else k - (k % 2 == 0)
    total = P * local_flow_pass(k, S, px)
    if flow.get("center_correction", 0):
        links = 1 if flow.get("correction_coarse_chain") else S
        total += local_flow_pass(k, 1 + P * links, px)
    return total


def aperture_step(flow: dict) -> float:
    """The bound (seconds) of the aperture passes of one micro-step: one a
    phase, one per coarse group, or A / P a phase when finer."""
    P, _ = _phasing(flow)
    A = flow.get("aperture_sub_phases", 0)
    if A and A < P and P % A == 0:
        passes = A
    else:
        k = max(1, A // P) if A else 1
        if (flow["chunk_size"] // P) % k or flow.get("center_correction", 0):
            k = 1
        passes = P * k
    n_scales = flow.get("max_window", 50) // flow.get("window_jump", 5) + 1
    return passes * aperture_pass(n_scales, flow["width"] * flow["height"])

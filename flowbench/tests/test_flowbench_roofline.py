"""The roofline arithmetic against a hand count at one shape."""
from __future__ import annotations

import pytest

from flowbench import roofline


def test_flowbench_local_flow_bound_by_hand():
    # k = 3, chain of 1, 1280 x 720: reads 2 int32 surfaces, writes 5
    # 4-byte maps; 9 * 20 + 135 + 46 + 72 = 433 f32 operations a pixel
    px = 1280 * 720
    by_bytes = 7 * px * 4 / 3.35e12
    by_ops = 433 * px / 67e12
    assert roofline.local_flow_pass(3, 1, px) == pytest.approx(
        max(by_bytes, by_ops), rel=1e-12)
    bound = roofline.local_flow_step(
        {"width": 1280, "height": 720, "chunk_size": 131072,
         "sub_phases": 2, "causal_snapshots": 1, "filter_size": 3})
    assert bound == pytest.approx(2 * max(by_bytes, by_ops), rel=1e-12)


def test_flowbench_aperture_bound_by_hand():
    # 11 scales: f32 4 + 55 + 1 = 60, f64 8 + 132 = 140 a pixel
    px = 240 * 180
    ops = 60 * px / 67e12 + 140 * px / 34e12
    assert roofline.aperture_pass(11, px) == pytest.approx(
        max(24 * px / 3.35e12, ops), rel=1e-12)
    flow = {"width": 240, "height": 180, "chunk_size": 131072,
            "sub_phases": 2, "aperture_sub_phases": 2,
            "causal_snapshots": 8, "center_correction": 32768,
            "correction_coarse_chain": True}
    assert roofline.aperture_step(flow) == pytest.approx(
        2 * roofline.aperture_pass(11, px), rel=1e-12)
    # the fidelity step: 2 passes over chains of 8, one correction pass
    # over the coarse chain (1 + 2 surfaces)
    bound = roofline.local_flow_step(flow)
    assert bound == pytest.approx(
        2 * roofline.local_flow_pass(3, 8, px)
        + roofline.local_flow_pass(3, 3, px), rel=1e-12)

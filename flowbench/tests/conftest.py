"""Tiny copies of the benchmark's cells for the CPU tests."""
from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from flowbench import harness  # noqa: E402

# per driver: traffic sized for a 64 x 48 sensor and 2048-lane steps
TINY = {
    "replay": dict(pool_events=20000, batch_events=4096, rate=2e5),
    "live": dict(pool_events=20000, call_events=2048, rate=1e4,
                 check_within=3),
    "resident": dict(stream_events=8192, rate=2e5),
}


def tiny_cell(name: str, flow: dict | None = None, **traffic):
    """The cell `name` of BENCHMARK.json on a 64 x 48 sensor with
    2048-lane micro-steps (one a call), its traffic cut to match."""
    c = harness.load_cell(name)
    cfg = copy.deepcopy(c.config)
    f = cfg["flow"]
    f.update(width=64, height=48, chunk_size=2048, steps_per_scan=1)
    if f["center_correction"]:
        f["center_correction"] = 512
    f.update(flow or {})
    return dataclasses.replace(c, config=cfg, traffic={
        **c.traffic, **TINY[c.traffic["driver"]], **traffic})


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

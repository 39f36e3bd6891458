"""The plain reference against the port's CPU path, and its imports."""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from flowbench.reference.dense import Reference, Semantics
from flowbench.traffic.gen import rotating_edges

PRESETS = {
    "benchmark": dict(chunk_size=2048, sub_phases=2, aperture_sub_phases=0,
                      causal_snapshots=1, center_correction=0, wire="f16"),
    "fidelity": dict(chunk_size=2048, sub_phases=2, aperture_sub_phases=2,
                     causal_snapshots=8, center_correction=512,
                     correction_coarse_chain=True, wire="f16"),
}


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_flowbench_reference_equals_port_cpu(preset):
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.events.io import EventBatch
    from farms_tpu_torch.pipeline.engine import FlowEngine
    cfg = FlowConfig(width=64, height=48, steps_per_scan=1,
                     **PRESETS[preset])
    s = rotating_edges(64, 48, 2e5, 2 * 2048, 6, seed=2**31 + 3)
    eng = FlowEngine(cfg, device="cpu")
    ref = Reference(Semantics.from_dict(dataclasses.asdict(cfg)), "cpu")
    for c in range(2):                    # two calls: the state carries
        sl = slice(c * 2048, (c + 1) * 2048)
        out = eng.process(EventBatch(s.x[sl], s.y[sl], s.t[sl], s.p[sl]))
        cols = ref.run(s.x[sl], s.y[sl], s.t[sl], int(s.t[0]))
        assert np.mean(cols["r_local"] > 0) > 0.2
        for k, v in cols.items():
            assert np.array_equal(_bits(getattr(out, k)), _bits(v)), k
    st = ref.state()
    assert np.array_equal(eng.state.t_surf.numpy(), st["t_surf"])
    for k in ("flow_len", "flow_vx", "flow_vy"):
        assert np.array_equal(_bits(getattr(eng.state, k).numpy()),
                              _bits(st[k])), k


def test_flowbench_reference_imports_nothing_of_the_program():
    for path in (Path(__file__).resolve().parents[1] / "reference").glob(
            "*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "farms_tpu_torch", "farms_tpu", "jax", "jaxlib",
                    "flax"), (path.name, n)

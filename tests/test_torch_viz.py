"""The port's visualization (farms_tpu_torch/viz.py) against farms_tpu's:
the same figures, pixel for pixel, from the same FlowOutput (the port's
run of tests/test_viz.py's stream). matplotlib runs on the CPU only."""
import os

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")

from farms_tpu_torch import viz as tviz  # noqa: E402
from farms_tpu_torch.config import FlowConfig  # noqa: E402
from farms_tpu_torch.events.io import synthetic_translating_bar  # noqa: E402
from farms_tpu_torch.pipeline.engine import FlowEngine  # noqa: E402

torch.set_num_threads(1)


def test_render_flow_windows_matches_jax(tmp_path):
    pytest.importorskip("jax")
    import matplotlib.image as mpimg
    from farms_tpu import viz as jviz
    from farms_tpu.events import io as jio

    ev = synthetic_translating_bar(width=64, height=64, bar_len=16,
                                   duration_us=25000, jitter_us=10)[:400]
    cfg = FlowConfig(width=64, height=64, chunk_size=64, steps_per_scan=2)
    out = FlowEngine(cfg, device="cpu").process(ev)
    paths = tviz.render_flow_windows(ev, out, str(tmp_path / "port"),
                                     width=64, height=64, max_windows=2)
    want = jviz.render_flow_windows(jio.EventBatch(**vars(ev)),
                                    jio.FlowOutput(**vars(out)),
                                    str(tmp_path / "jax"), width=64,
                                    height=64, max_windows=2)
    assert len(paths) >= 1
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in want]
    for p, w in zip(paths, want):
        assert os.path.getsize(p) > 10_000
        np.testing.assert_array_equal(mpimg.imread(p), mpimg.imread(w))

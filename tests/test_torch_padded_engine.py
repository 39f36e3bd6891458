"""The single engine on a padded array geometry (padded_width/height).

The sharded engines pad the sensor to their band count
(`FlowConfig.padded_to`); the single engine runs such a config too, as
farms_tpu's does (farms_tpu/state/surfaces.py:53-55,
farms_tpu/pipeline/engine.py:262-264): the surfaces sit at the array
geometry, the lanes' semantic flat indices address it, the pad cells are
never written, and a checkpoint keeps the semantic [W, H]. Held bit for
bit against the unpadded engine (the pad cells read as the stencils'
out-of-sensor zeros), and against farms_tpu's FlowEngine on the same
padded config, which runs its plain XLA path there
(farms_tpu/ops/pallas/kernels.py:135-142) while the port runs its
kernels' contracts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.pipeline import checkpoint as tckpt
from farms_tpu_torch.pipeline import engine as teng
from test_torch_dp_engine import BENCH, FIDELITY, assert_bitwise, rank2_bar
from test_torch_engine import (_assert_engines_agree,
                               _process_recording_aperture)

torch.set_num_threads(1)

PAD = dict(padded_width=70, padded_height=53)
SHAPE48 = dict(BENCH, height=48)
CASES = {
    "benchmark": SHAPE48,
    "fidelity": FIDELITY,
    "fine-phasing": dict(SHAPE48, aperture_sub_phases=4),
    "coarse-pooling": dict(SHAPE48, chunk_size=128, sub_phases=4,
                           aperture_sub_phases=2, causal_snapshots=2),
    "filter7": dict(SHAPE48, filter_size=7),
    "y-clamp-quirk": dict(SHAPE48, replicate_y_clamp_quirk=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_padded_single_engine_equals_unpadded(name):
    cfg = TConfig(**CASES[name])
    padded = dataclasses.replace(cfg, **PAD)
    ev = rank2_bar()
    ref = teng.FlowEngine(cfg, device="cpu").process(ev)
    eng = teng.FlowEngine(padded, device="cpu")
    got = eng.process(ev)
    assert tuple(eng.state.t_surf.shape) == (70, 53)
    assert (ref.r_local > 0).sum() > 40
    assert_bitwise(ref, got, name)
    # the pad cells were never written
    for a in (eng.state.t_surf, eng.state.flow_len):
        assert not a[64:].any() and not a[:, 48:].any()
    assert (eng.state.epoch[64:] == -1).all()


def test_padded_checkpoint_keeps_the_semantic_geometry(tmp_path):
    """A padded engine saves [W, H]; the unpadded engine resumes from it
    and a padded one from the unpadded engine's, both bit for bit."""
    cfg = TConfig(**FIDELITY)
    padded = dataclasses.replace(cfg, **PAD)
    ev = rank2_bar()
    cut = 256
    ref_eng = teng.FlowEngine(cfg, device="cpu")
    ref_eng.process(ev[:cut])
    plain = tckpt.save_engine(ref_eng, str(tmp_path / "plain"))
    ref = ref_eng.process(ev[cut:])
    eng = teng.FlowEngine(padded, device="cpu")
    eng.process(ev[:cut])
    path = tckpt.save_engine(eng, str(tmp_path / "padded"))
    with np.load(path) as data:
        assert data["t_surf"].shape == (64, 48)
    resumed = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"), path)
    assert_bitwise(ref, resumed.process(ev[cut:]), "padded-to-plain")
    resumed = tckpt.load_engine(teng.FlowEngine(padded, device="cpu"), plain)
    assert tuple(resumed.state.t_surf.shape) == (70, 53)
    assert_bitwise(ref, resumed.process(ev[cut:]), "plain-to-padded")


@pytest.mark.parametrize("name", ["benchmark", "coarse-pooling"])
def test_padded_single_engine_matches_jax(name, monkeypatch):
    """Not under correction: farms_tpu's single engine hands its [W, H]
    center surfaces to a padded state there and fails (only its
    multi-host engine pads them, farms_tpu/parallel/multihost.py:215-218);
    the port pads them for every engine (FlowEngine.device_calls)."""
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.pipeline.engine import FlowEngine as JEngine

    kw = dict(CASES[name], **PAD)
    ev = rank2_bar()
    want = JEngine(JConfig(use_pallas=False, **kw)).process(ev)
    got, passes = _process_recording_aperture(
        teng.FlowEngine(TConfig(**kw), device="cpu"), ev, monkeypatch)
    _assert_engines_agree(want, got, passes, TConfig(**kw),
                          f"jax padded {name}")

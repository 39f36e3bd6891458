"""farms_tpu_torch.config mirrors farms_tpu.config; the port imports no JAX."""
import ast
import dataclasses
import pathlib

import pytest
import torch

torch.set_num_threads(1)

from farms_tpu_torch import config as tconfig

_PORT_ONLY_ABSENT = {"use_pallas"}
_PROPS = ("array_width", "array_height", "f_rad", "plane_size", "num_scales",
          "scales", "support_radius", "halo_width")


@pytest.fixture
def jax_config():
    pytest.importorskip("jax")
    from farms_tpu import config
    return config


def test_fields_and_defaults_match(jax_config):
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.FlowConfig)
          if f.name not in _PORT_ONLY_ABSENT}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.FlowConfig)}
    assert list(tf) == list(jf)
    assert tf == jf


@pytest.mark.parametrize("kw", [
    {},
    dict(width=640, height=480, filter_size=5, min_evts_on_plane=3),
    dict(filter_size=4), dict(filter_size=2), dict(filter_size=8),
    dict(chunk_size=131072, sub_phases=2, wire="f16"),
    dict(max_window=20, window_jump=4, replicate_y_clamp_quirk=True),
    dict(width=100, height=60, padded_width=128),
])
def test_properties_match(jax_config, kw):
    j = jax_config.FlowConfig(**kw)
    t = tconfig.FlowConfig(**kw)
    for name in [f.name for f in dataclasses.fields(t)] + list(_PROPS):
        assert getattr(t, name) == getattr(j, name), name
    assert (dataclasses.asdict(t.padded_to(16, 8))
            == {k: v for k, v in dataclasses.asdict(j.padded_to(16, 8)).items()
                if k not in _PORT_ONLY_ABSENT})


@pytest.mark.parametrize("kw", [
    dict(sub_phases=0),
    dict(chunk_size=100, sub_phases=3),
    dict(chunk_size=64, sub_phases=2, aperture_sub_phases=3),
    dict(chunk_size=60, sub_phases=2, aperture_sub_phases=8),
    dict(causal_snapshots=0),
    dict(chunk_size=64, sub_phases=2, causal_snapshots=3),
    dict(causal_snapshots=2, use_dense=False),
    dict(center_correction=8, use_dense=False),
    dict(center_correction=-1),
    dict(chunk_size=64, sub_phases=2, aperture_sub_phases=4,
         center_correction=8),
    dict(wire="bf16"),
    dict(max_window=1000, window_jump=1),
    dict(max_window=315, window_jump=5, wire="sparse"),
    dict(width=64, padded_width=32),
    dict(height=64, padded_height=32),
    dict(padded_width=400, use_dense=False),
])
def test_validation_errors_match(jax_config, kw):
    with pytest.raises(ValueError) as je:
        jax_config.FlowConfig(**kw)
    with pytest.raises(ValueError) as te:
        tconfig.FlowConfig(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw, item", [
    (dict(wire="sparse"), "item 8"),
    (dict(width=32768, height=32768), "Queue 1 item 5"),
])
def test_unported_features_raise(kw, item):
    """The two features the port refused until its last slice no longer
    raise: the single engine takes the sparse wire, and a sensor of 2^30
    pixels or more, whose compact packs fall back to the 5-row layout as
    in farms_tpu (engine.py:823-827). The 2^30-pixel engine is built on
    the meta device, which allocates no surface, since only its host
    packing is checked."""
    from farms_tpu_torch.events.io import synthetic_random_events
    from farms_tpu_torch.pipeline.engine import FlowEngine
    cfg = tconfig.FlowConfig(**kw, chunk_size=256)
    big = cfg.width * cfg.height >= 1 << 30
    eng = FlowEngine(cfg, device="meta" if big else "cpu")
    ev = synthetic_random_events(300, width=cfg.width, height=cfg.height)
    packed, aux2, n = eng.pack2(ev)
    assert n == 300
    if big:
        assert packed.shape[2] == 5 and aux2 is None
        assert eng.pack(ev, compact=True)[0].shape[2] == 5
    else:
        assert packed.shape[2] == 1 and aux2 is not None
        assert len(eng.process(ev)) == 300


@pytest.mark.parametrize("kw", [
    dict(chunk_size=64, causal_snapshots=2),
    dict(center_correction=8),
    dict(chunk_size=64, sub_phases=2, aperture_sub_phases=2),
    dict(filter_size=7),
    dict(filter_size=9, chunk_size=131072, sub_phases=2, aperture_sub_phases=2,
         causal_snapshots=8, center_correction=32768,
         correction_coarse_chain=True, wire="f16"),
    dict(use_dense=False),
])
def test_fidelity_features_accepted(kw):
    """The fidelity slice's features, filter sizes past 5 and the
    per-event formulation run."""
    cfg = tconfig.FlowConfig(**kw)
    from farms_tpu_torch.pipeline.engine import FlowEngine
    FlowEngine(cfg, device="cpu")


def test_padded_geometry_accepted():
    """Padded array geometry runs on the single engine (refused before
    the multi-host slice): its state sits at the array geometry."""
    cfg = tconfig.FlowConfig(width=100, padded_width=128)
    from farms_tpu_torch.pipeline.engine import FlowEngine
    eng = FlowEngine(cfg, device="cpu")
    assert tuple(eng.state.t_surf.shape) == (128, 320)


def test_slice_config_accepted():
    from farms_tpu_torch.pipeline.engine import FlowEngine
    FlowEngine(tconfig.FlowConfig(chunk_size=131072, sub_phases=2,
                                  wire="f16"), device="cpu")
    FlowEngine(tconfig.FlowConfig(filter_size=5, wire="f32"), device="cpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_farms_tpu():
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "farms_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "farms_tpu"):
                bad.append(f"{path.relative_to(root)}: {mod}")
    assert not bad, bad

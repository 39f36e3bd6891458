"""The port's spatial engine (parallel/tiling.py) on 1, 2, 4 and 8 gloo
ranks.

The cases of tests/test_tiling.py on the port: x tiles over 2 and 8
ranks, width 60 over 8 (x padding), a (4, 2) grid at height 62 (y
padding); and past them a (2, 2) grid at the fidelity shape with the
rank-2 correction (the correction pass on tiles), at --filtersize 7 and
with finer aperture phasing, the y-clamp quirk on a (1, 8) grid whose
last tiles start past the clamp (the clamp column fetched from its
owner), process_resident, and checkpoints that resume single -> (2, 2)
and back. Each group of ranks is spawned once per module (parallel/
mesh.py `run`, with the rank entry points of test_torch_spatial_ranks.py,
which imports no JAX) and serves every case of its size.

Each case is held against the port's single engine as the halo engine's
are (test_torch_halo_engine._assert_equals_single): valid flags and the
bits of vx, vy, r_local and theta_local; scale ids equal except at
float64 ties of the per-scale mean lengths, and the true flow's bits
where the scale is. The tile integral's two offset folds add partials in
another order than the whole-sensor cumsum, so a tie may break the other
way. The (4, 2) case is also held against farms_tpu's SpatialFlowEngine
on the virtual 8-device mesh (test_torch_engine._assert_engines_agree).
The tile integral itself is held bit for bit against the whole integral's
band (dense_flow.tile_band) on (4, 2), (2, 2) and the quirk's (1, 8).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.tiling import SpatialFlowEngine
from farms_tpu_torch.pipeline import checkpoint as tckpt
from farms_tpu_torch.pipeline import engine as teng
from test_torch_engine import (_assert_engines_agree,
                               _process_recording_aperture)
from test_torch_halo_engine import _assert_equals_single
from test_torch_halo_ops import _four_bars
from test_torch_spatial_ranks import (checkpoint_tiles, integral_tiles,
                                      process_tiles, resident_tiles,
                                      run_jobs)

torch.set_num_threads(1)


def _bar(keep=None):
    # tests/test_tiling.py:16-21, less the events past a cut sensor edge
    ev = tio.synthetic_translating_bar(
        width=64, height=64, bar_len=20, duration_us=30000,
        speed_px_per_sec=1000, jitter_us=20, seed=1)[:512]
    if keep is None:
        return ev
    k = keep(ev)
    return tio.EventBatch(ev.x[k], ev.y[k], ev.t[k], ev.pol[k])


def _quirk_bars():
    """A bar of 56 rows (y 4 .. 59) translating in +x on a 40 x 64
    sensor: flow on both sides of column 40, where the quirk clamps the
    aperture windows, and in the last tile of a (1, 8) grid (y >= 56)."""
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=56,
                                       duration_us=30000, jitter_us=10,
                                       seed=5)
    k = ev.x < 40
    return tio.EventBatch(ev.x[k], ev.y[k], ev.t[k], ev.pol[k])[:768]


_BASE = dict(width=64, height=64, chunk_size=64, steps_per_scan=2,
             max_window=10)
_FIDELITY = dict(width=64, height=48, chunk_size=128, steps_per_scan=2,
                 max_window=10, window_jump=5, sub_phases=4,
                 aperture_sub_phases=2, causal_snapshots=2,
                 center_correction=32, correction_coarse_chain=True,
                 wire="f16")

# name: (ranks, grid shape (None: x tiles), config, stream)
CASES = {
    "x-2": (2, None, _BASE, _bar),
    "x-8": (8, None, _BASE, _bar),
    "x-padded-60-8": (8, None, dict(_BASE, width=60),
                      lambda: _bar(lambda e: e.x < 60)),
    "tile-4x2-h62": (8, (4, 2), dict(_BASE, height=62),
                     lambda: _bar(lambda e: e.y < 62)),
    "fidelity-2x2": (4, (2, 2), _FIDELITY, lambda: _four_bars(True)),
    "filter7-2x2": (4, (2, 2), dict(_BASE, filter_size=7), _bar),
    "fine-aperture-2x2": (4, (2, 2), dict(_BASE, sub_phases=2,
                                          aperture_sub_phases=4), _bar),
    "quirk-1x8": (8, (1, 8), dict(_BASE, width=40,
                                  replicate_y_clamp_quirk=True),
                  _quirk_bars),
}

# name: (ranks, grid shape, width, height, quirk)
INTEGRALS = {
    "integral-4x2-h62": (8, (4, 2), 64, 62, False),
    "integral-quirk-1x8": (8, (1, 8), 40, 64, True),
    "integral-padded-2x2": (4, (2, 2), 60, 62, False),
}

_CUT = 256


def _integral_inputs(W, H, shape, quirk):
    cfg = TConfig(width=W, height=H, max_window=10,
                  replicate_y_clamp_quirk=quirk)
    pc = cfg.padded_to(*shape)
    rng = np.random.default_rng(W + H)
    Wa, Ha = pc.array_width, pc.array_height
    fl = (rng.uniform(100, 3000, (Wa, Ha))
          * (rng.random((Wa, Ha)) < 0.3)).astype(np.float32)
    fl[W:], fl[:, H:] = 0, 0            # pad cells are never written
    vx, vy = (rng.standard_normal((2, Wa, Ha)) * fl).astype(np.float32)
    return cfg, (fl, vx, vy)


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """{name: rank 0's result}: every case, integral and the checkpoint
    and resident runs, one spawned group per rank count."""
    tmp = tmp_path_factory.mktemp("spatial")
    cfg = TConfig(**_BASE)
    eng = teng.FlowEngine(cfg, device="cpu")
    eng.process(_bar()[:_CUT])
    single = tckpt.save_engine(eng, str(tmp / "single"))
    tiles = str(tmp / "tiles.npz")
    jobs = {n: [] for n in (2, 4, 8)}
    for name, (n, shape, kw, stream) in CASES.items():
        jobs[n].append((name, (process_tiles, (TConfig(**kw), stream(),
                                               shape))))
    for name, (n, shape, W, H, quirk) in INTEGRALS.items():
        cfg_i, fields = _integral_inputs(W, H, shape, quirk)
        jobs[n].append((name, (integral_tiles, (cfg_i, fields, shape))))
    jobs[4].append(("checkpoint", (checkpoint_tiles, (
        cfg, _bar(), _CUT, (2, 2), tiles, single))))
    jobs[4].append(("resident", (resident_tiles, (cfg, _bar(), (2, 2)))))
    out = dict(single=single, tiles=tiles)
    for n, named in jobs.items():
        results = mesh.run(run_jobs, n, "cpu", [job for _, job in named])
        out.update(zip([name for name, _ in named], results))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_spatial_engine_matches_single_engine(spatial_runs, name,
                                              monkeypatch):
    n, shape, kw, stream = CASES[name]
    cfg = TConfig(**kw)
    ev = stream()
    ref, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), ev, monkeypatch)
    assert (ref.r_local > 0).sum() > 40
    if cfg.center_correction:
        flags, _ = teng.FlowEngine(cfg, device="cpu").pack_r2(ev)
        assert flags.sum() > 20        # the correction pass has lanes
    _assert_equals_single(ref, spatial_runs[name], passes, cfg, name)


@pytest.mark.parametrize("name", list(INTEGRALS))
def test_tile_integral_equals_the_whole_integrals_band(spatial_runs, name):
    """Each rank's assembled band is the whole integral's band of its tile
    (tile_band), bit for bit: the partials are exact float64 sums here.
    On the quirk's (1, 8) grid the tiles from column 56 on start past the
    clamp (40) + max_window + 1 and take column 40 from its owner."""
    n, shape, W, H, quirk = INTEGRALS[name]
    cfg, fields = _integral_inputs(W, H, shape, quirk)
    pc = cfg.padded_to(*shape)
    whole = tdf.build_integral(*(torch.from_numpy(f) for f in fields))
    tx, ty = shape
    rows, cols = pc.array_width // tx, pc.array_height // ty
    A = pc.max_window + 1
    bands = spatial_runs[name]
    assert len(bands) == n
    for r, band in enumerate(bands):
        want = tdf.tile_band(whole, (r % tx) * rows, rows, (r // tx) * cols,
                             cols, A, tdf.aperture_y_clip(pc))
        assert torch.equal(band.view(torch.int64),
                           want.view(torch.int64)), (name, r)


def test_one_rank_runs_in_process_without_a_group():
    """A one-rank engine needs no process group: both column halos and
    the row halos zero-pad and the tile integral is built locally; its
    outputs are the single engine's bit for bit, correction pass
    included."""
    assert not torch.distributed.is_initialized()
    cfg = TConfig(**_FIDELITY)
    ev = _four_bars(True)
    got = SpatialFlowEngine(cfg, device="cpu").process(ev)
    ref = teng.FlowEngine(cfg, device="cpu").process(ev)
    for col in ("vx", "vy", "r_local", "r_true", "theta_true", "scale"):
        a, b = getattr(got, col), getattr(ref, col)
        np.testing.assert_array_equal(a.view(f"u{a.itemsize}"),
                                      b.view(f"u{b.itemsize}"), err_msg=col)


def test_spatial_engine_matches_jax_spatial_engine(spatial_runs,
                                                   monkeypatch):
    """The (4, 2) grid at height 62 against farms_tpu's SpatialFlowEngine
    on the virtual 8-device mesh (tests/test_tiling.py:58)."""
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.parallel.tiling import SpatialFlowEngine as JSpatial

    _, shape, kw, stream = CASES["tile-4x2-h62"]
    ev = stream()
    want = JSpatial(JConfig(use_pallas=False, **kw),
                    mesh_shape=shape).process(ev)
    cfg = TConfig(**kw)
    _, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), ev, monkeypatch)
    _assert_engines_agree(want, spatial_runs["tile-4x2-h62"], passes, cfg,
                          "jax spatial (4, 2)")


def test_refusals():
    """use_dense=False in JAX's words, the sparse wire as every sharded
    engine refuses it, a grid larger than the world, and the card where
    there is none."""
    with pytest.raises(ValueError, match="requires the dense compute"):
        SpatialFlowEngine(TConfig(**dict(_BASE, use_dense=False)),
                          device="cpu")
    eng = SpatialFlowEngine(TConfig(**dict(_BASE, wire="sparse")),
                            device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        eng.process(_bar())
    with pytest.raises(ValueError, match="need 4 devices"):
        SpatialFlowEngine(TConfig(**_BASE), mesh_shape=(2, 2), device="cpu")
    if not torch.cuda.is_available():
        # no fallback: the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SpatialFlowEngine(TConfig(**_BASE))


@pytest.mark.parametrize("direction", ["single-to-tiles", "tiles-to-single",
                                       "tiles-to-tiles"])
def test_spatial_checkpoint_resumes(spatial_runs, direction, monkeypatch):
    """A single-engine checkpoint resumes on a (2, 2) grid, and a (2, 2)
    checkpoint in the single engine and on the grid, each equal to the
    single engine's continuation (off float64 scale ties)."""
    cfg = TConfig(**_BASE)
    ev = _bar()[_CUT:]
    runs = spatial_runs["checkpoint"]
    ref, passes = _process_recording_aperture(
        tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"),
                          spatial_runs["single"]), ev, monkeypatch)
    assert (ref.r_local > 0).sum() > 40
    if direction == "tiles-to-single":
        got = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"),
                                spatial_runs["tiles"]).process(ev)
    else:
        got = runs["from_single" if direction == "single-to-tiles"
                   else "second"]
    _assert_equals_single(ref, got, passes, cfg, direction)


def test_spatial_process_resident_matches_single_engine(spatial_runs,
                                                        monkeypatch):
    """process_resident on a (2, 2) grid: one uploaded call of the 5-row
    layout, its lanes gathered and decoded as process() decodes them."""
    cfg = TConfig(**_BASE)
    ref, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), _bar(), monkeypatch)
    _assert_equals_single(ref, spatial_runs["resident"], passes, cfg,
                          "resident (2, 2)")


def test_rank_entry_points_import_no_jax():
    """What a spawned rank of these tests imports (the spatial engine and
    the rank entry points) pulls in neither jax nor farms_tpu."""
    code = ("import sys, farms_tpu_torch.parallel.tiling, "
            "test_torch_spatial_ranks; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'farms_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr

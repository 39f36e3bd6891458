"""The port's halo engine on 1, 2, 4 and 8 gloo ranks.

The cases of tests/test_halo.py on the port (parallel/halo.py): thin shards
whose bands span several ring hops (8 shards, max_window 10 and 50),
padding (width 66 over 4), sub-phases, the fidelity shape (P = 8, A = 2,
S = 2), the rank-2 correction (coarse and full chain), the owner-sharded
upload and its overflow fall-back to the replicated layout. Each group of
ranks is spawned once per module (parallel/mesh.py `run`, with the rank
entry point of test_torch_halo_ranks.py, which imports no JAX) and serves
every case of its size.

Each case is held against the port's single engine: valid flags and the
bit patterns of vx, vy, r_local and theta_local (signed zeros included);
scale ids equal except at float64 ties of the per-scale mean lengths
(pipeline/ties.py on the single engine's aperture inputs, which the
shards' surfaces equal), and the true flow's bits equal where the scale
is. The band integral is a per-shard float64 cumsum plus gathered
offsets, not the whole-sensor cumsum, so a tie may break the other way;
the count is printed. The port is also held against `farms_tpu`'s
HaloFlowEngine at the same rank count, with the single engine's tie masks
(test_torch_engine._assert_engines_agree): the replicated layout at 2 and
4 ranks, and at 4 ranks the fidelity shape, the owner-sharded layout and
the correction pass.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.parallel import halo, mesh
from farms_tpu_torch.pipeline import checkpoint as tckpt
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.pipeline.ties import scale_ties
from test_torch_engine import (_assert_engines_agree,
                               _process_recording_aperture)
from test_torch_halo_ops import _four_bars
from test_torch_halo_ranks import checkpoint_runs, pack_halo, process_streams

torch.set_num_threads(1)


def _bar():
    # tests/test_halo.py:16-21
    return tio.synthetic_translating_bar(
        width=64, height=64, bar_len=20, duration_us=30000,
        speed_px_per_sec=1000, jitter_us=20, seed=1)[:512]


def _random():
    # tests/test_torch_engine.py's random stream: isolated flow pixels, so
    # many scale windows tie on mean length
    return tio.synthetic_random_events(6000, width=64, height=64,
                                       rate_hz=1e6, seed=9)


def _bar48():
    # tests/test_halo.py:85-87
    ev = tio.synthetic_translating_bar(width=64, height=48, bar_len=16,
                                       duration_us=15000, jitter_us=10,
                                       seed=4)
    ev.y[:] = np.clip(ev.y, 0, 47)
    return ev


_BASE = dict(width=64, height=64, chunk_size=64, steps_per_scan=2,
             max_window=10)
_SHAPE48 = dict(width=64, height=48, chunk_size=128, steps_per_scan=2,
                max_window=10, window_jump=5)
_OWNER = dict(_SHAPE48, sub_phases=4, aperture_sub_phases=2,
              causal_snapshots=2)

# name: (ranks, config, stream, owner-sharded layout expected (None: any))
CASES = {
    "base-1": (1, _BASE, _bar, None),
    "base-2": (2, _BASE, _bar, None),
    "filter5-2": (2, dict(_BASE, filter_size=5), _bar, None),
    "base-4": (4, _BASE, _bar, None),
    "padded-66-4": (4, dict(_BASE, width=66), _bar, None),
    "sub-phases-4": (4, dict(_SHAPE48, sub_phases=4), _bar48, None),
    "fidelity-shape-4": (4, dict(_SHAPE48, sub_phases=8,
                                 aperture_sub_phases=2, causal_snapshots=2,
                                 wire="f16"), _bar48, None),
    "owner-sharded-4": (4, _OWNER, _four_bars, True),
    "overflow-4": (4, dict(_SHAPE48, sub_phases=2), _bar48, False),
    "correction-coarse-4": (4, dict(_OWNER, center_correction=32,
                                    correction_coarse_chain=True),
                            lambda: _four_bars(repeats=True), True),
    "correction-full-f16-4": (4, dict(_OWNER, center_correction=32,
                                      wire="f16"),
                              lambda: _four_bars(repeats=True), True),
    "correction-overflow-4": (4, dict(_OWNER, center_correction=32),
                              lambda: _four_bars(True, (1, 5, 9, 13)),
                              False),
    "random-4": (4, dict(_BASE, chunk_size=1024, sub_phases=2,
                           wire="f16"), _random, None),
    "thin-8": (8, _BASE, _bar, None),
    "thin-window50-8": (8, dict(_BASE, max_window=50), _bar, None),
}


@pytest.fixture(scope="module")
def halo_outputs():
    """{case: rank 0's FlowOutput}, one spawned group per rank count."""
    out = {}
    for n in sorted({c[0] for c in CASES.values()}):
        names = [k for k, c in CASES.items() if c[0] == n]
        jobs = [(TConfig(**CASES[k][1]), CASES[k][2]()) for k in names]
        out.update(zip(names, mesh.run(process_streams, n, "cpu", jobs,
                                       "cpu")))
    return out


def _bits(a):
    """The bit patterns of an array (-0.0 and +0.0 differ)."""
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


def _assert_equals_single(ref, got, passes, cfg, what):
    """Bitwise local columns; scale ids and true flow equal off float64
    ties. Returns (lanes with another scale, of them tied)."""
    for col in ("x", "y", "t", "vx", "vy", "r_local", "theta_local"):
        np.testing.assert_array_equal(_bits(getattr(got, col)),
                                      _bits(getattr(ref, col)),
                                      err_msg=f"{what} {col}")
    np.testing.assert_array_equal(got.r_local > 0, ref.r_local > 0,
                                  err_msg=f"{what} valid")
    differ = ref.scale != got.scale
    tied = differ & scale_ties(ref, got, passes, cfg)
    assert (tied == differ).all(), (
        f"{what}: {(differ & ~tied).sum()} scale ids differ off ties")
    same = ~differ
    for col in ("r_true", "theta_true"):
        np.testing.assert_array_equal(_bits(getattr(got, col)[same]),
                                      _bits(getattr(ref, col)[same]),
                                      err_msg=f"{what} {col}")
    print(f"{what}: {(ref.r_local > 0).sum()} valid of {len(ref)}; scale "
          f"differs on {differ.sum()} lanes, {tied.sum()} of them float64 "
          "ties")
    return differ.sum(), tied.sum()


@pytest.mark.parametrize("name", list(CASES))
def test_halo_engine_matches_single_engine(halo_outputs, name, monkeypatch):
    n, kw, stream, owner = CASES[name]
    cfg = TConfig(**kw)
    ev = stream()
    ref, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), ev, monkeypatch)
    assert (ref.r_local > 0).sum() > 40
    if owner is not None:
        assert (pack_halo(cfg, ev, n)[2] is not None) == owner
    if cfg.center_correction:
        flags, _ = teng.FlowEngine(cfg, device="cpu").pack_r2(ev)
        assert flags.sum() > 20        # the correction pass has lanes
    _assert_equals_single(ref, halo_outputs[name], passes, cfg, name)


def test_one_rank_runs_in_process_without_a_group():
    """A one-rank engine needs no process group: its exchanges pad and
    its band integral is built locally."""
    assert not torch.distributed.is_initialized()
    cfg = TConfig(**_OWNER)
    ev = _four_bars()
    got = mesh.run(process_streams, 1, "cpu", [(cfg, ev)], "cpu")[0]
    ref = teng.FlowEngine(cfg, device="cpu").process(ev)
    for col in ("vx", "r_local", "r_true", "scale"):
        np.testing.assert_array_equal(getattr(got, col), getattr(ref, col))


@pytest.mark.parametrize("n", [2, 4])
def test_halo_engine_matches_jax_halo_engine(halo_outputs, n, monkeypatch):
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.parallel.halo import HaloFlowEngine as JHalo

    cfg = TConfig(**_BASE)
    ev = _bar()
    want = JHalo(JConfig(use_pallas=False, **_BASE), num_devices=n).process(ev)
    _, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), ev, monkeypatch)
    _assert_engines_agree(want, halo_outputs[f"base-{n}"], passes, cfg,
                          f"jax halo n={n}")


@pytest.mark.parametrize("name", ["fidelity-shape-4", "owner-sharded-4",
                                  "correction-coarse-4"])
def test_halo_engine_matches_jax_halo_engine_at_4_ranks(halo_outputs, name,
                                                        monkeypatch):
    """The layouts and passes past the replicated base case against JAX's
    HaloFlowEngine at 4 ranks, one process() call each (a second call
    would meet the reference's one-shot center-surface queue)."""
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.parallel.halo import HaloFlowEngine as JHalo

    n, kw, stream, owner = CASES[name]
    cfg = TConfig(**kw)
    ev = stream()
    eng = JHalo(JConfig(use_pallas=False, **kw), num_devices=n)
    want = eng.process(ev)
    # the reference took the layout the port's pack_halo takes
    assert (eng._shard_layout is not None) == (
        pack_halo(cfg, ev, n)[2] is not None)
    _, passes = _process_recording_aperture(
        teng.FlowEngine(cfg, device="cpu"), ev, monkeypatch)
    _assert_engines_agree(want, halo_outputs[name], passes, cfg,
                          f"jax halo {name}")


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 1, 0, 2)])
def test_off_shard_fill_keeps_the_owners_bits(order):
    """Lanes of other shards are filled with -0.0, the identity of f32
    addition: the sum over ranks, in any order, is the owner's value bit
    for bit, -0.0 included (a +0.0 fill would give +0.0 there)."""
    lanes = torch.tensor([[-0.0, 0.0, 1.5, -2.25, 3e-39, -0.0],
                          [7.0, -0.0, -0.0, 0.0, -1e-30, 2.0]])
    owner = torch.tensor([0, 1, 2, 3, 1, 3])
    parts = [halo._own(lanes, owner == r) for r in order]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    assert torch.equal(total.view(torch.int32), lanes.view(torch.int32))


def test_rank_failure_raises_with_its_traceback():
    cfg = TConfig(**_BASE)
    with pytest.raises(RuntimeError, match="rank .* failed"):
        # a config the engine refuses, raised inside every rank
        mesh.run(process_streams, 2, "cpu",
                 [(TConfig(**dict(_BASE, aperture_sub_phases=2)), _bar())],
                 "cpu")
    assert cfg.chunk_size == 64


_CUT = 256


@pytest.fixture(scope="module")
def halo_checkpoints(tmp_path_factory):
    """checkpoint_runs on 4 gloo ranks (tests/test_checkpoint.py:30-75),
    with a single-engine checkpoint of the same cut: (rank 0's outputs,
    the halo checkpoint's path, the single engine's path)."""
    tmp = tmp_path_factory.mktemp("halo_ckpt")
    cfg = TConfig(**_BASE)
    eng = teng.FlowEngine(cfg, device="cpu")
    eng.process(_bar()[:_CUT])
    single = tckpt.save_engine(eng, str(tmp / "single"))
    halo_path = str(tmp / "halo.npz")
    outs = mesh.run(checkpoint_runs, 4, "cpu", cfg, _bar(), _CUT, halo_path,
                    single, "cpu")
    return outs, halo_path, single


@pytest.mark.parametrize("direction", ["halo-to-halo", "single-to-halo",
                                       "halo-to-single"])
def test_halo_checkpoint_resumes(halo_checkpoints, direction, monkeypatch):
    """A 4-rank halo checkpoint resumes in a fresh 4-rank halo engine
    equal to the uninterrupted run; a single-engine checkpoint resumes on
    4 ranks, and the 4-rank one in the single engine, each equal to the
    single engine's continuation (bitwise off float64 scale ties, as
    every halo run)."""
    outs, halo_path, single = halo_checkpoints
    cfg = TConfig(**_BASE)
    ev = _bar()
    if direction == "halo-to-halo":
        for col in ("vx", "vy", "r_true", "theta_true", "r_local", "scale",
                    "t"):
            np.testing.assert_array_equal(
                np.concatenate([getattr(outs["first"], col),
                                getattr(outs["second"], col)]),
                getattr(outs["one"], col), err_msg=col)
        assert (outs["second"].r_local > 0).sum() > 40
        return
    path = single if direction == "single-to-halo" else halo_path
    ref, passes = _process_recording_aperture(
        tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"), path),
        ev[_CUT:], monkeypatch)
    got = (outs["from_single"] if direction == "single-to-halo"
           else outs["second"])
    assert (ref.r_local > 0).sum() > 40
    _assert_equals_single(ref, got, passes, cfg, direction)


def test_port_modules_import_no_jax():
    """What a spawned rank imports (the CLI, the halo and spatial engines,
    the launcher) pulls in neither jax nor farms_tpu."""
    code = ("import sys, farms_tpu_torch.cli, farms_tpu_torch.parallel.halo, "
            "farms_tpu_torch.parallel.tiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'farms_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

"""The port's event-parallel engine (parallel/dp.py) on 1, 2 and 4 gloo ranks.

tests/test_sharding.py on the port: dp equals the single engine. Here the
equality is bitwise on every output column, since every rank runs the
single engine's micro_step on the whole batch and only the gathered lanes
are split: at the benchmark shape (2 sub-phases, f16 wire), the fidelity
shape of tests/test_multihost.py:31-35 (snapshots, coarse chain, rank-2
correction; the correction pass assembles every lane at the end, across
the lane shards), the per-event formulation and, at 2 ranks, filter size
7. One group of ranks is spawned per rank count (parallel/mesh.py `run`,
with the rank entry points of test_torch_multihost_ranks.py, which import
no JAX). The port is also held against `farms_tpu`'s ShardedFlowEngine
on 2 devices, and a dp checkpoint resumes in the single engine and the
other way round.
"""
import numpy as np
import pytest
import torch
from unittest import mock

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.dp import ShardedFlowEngine
from farms_tpu_torch.pipeline import checkpoint as tckpt
from farms_tpu_torch.pipeline import engine as teng
from test_torch_engine import (_assert_engines_agree,
                               _process_recording_aperture)
from test_torch_multihost_ranks import (checkpoint_runs, concat,
                                        process_streams)

torch.set_num_threads(1)


def bar():
    # tests/test_sharding.py:12-17
    return tio.synthetic_translating_bar(
        width=64, height=64, bar_len=20, duration_us=30000,
        speed_px_per_sec=1000, jitter_us=20, seed=1)[:512]


def rank2_bar():
    """tests/test_multihost.py:38-52: a bar on 64 x 48 with every 16th
    event moved to its predecessor's pixel, so rank-2 lanes exist."""
    full = tio.synthetic_translating_bar(width=64, height=48, bar_len=20,
                                         speed_px_per_sec=2000.0,
                                         duration_us=20000)
    fx, fy = full.x.copy(), full.y.copy()
    fx[1::16] = fx[::16][:fx[1::16].size]
    fy[1::16] = fy[::16][:fy[1::16].size]
    return tio.EventBatch(fx, fy, full.t, full.pol)


BENCH = dict(width=64, height=64, chunk_size=64, steps_per_scan=2,
             max_window=10, sub_phases=2, wire="f16")
# tests/test_multihost.py:31-35
FIDELITY = dict(width=64, height=48, chunk_size=64, steps_per_scan=2,
                max_window=10, window_jump=5, sub_phases=2,
                causal_snapshots=2, center_correction=16,
                correction_coarse_chain=True)

# name: (ranks, config, stream)
CASES = {f"{shape}-{n}": (n, kw, stream)
         for n in (1, 2, 4)
         for shape, kw, stream in (
             ("benchmark", BENCH, bar), ("fidelity", FIDELITY, rank2_bar),
             ("perevent", dict(BENCH, use_dense=False), bar))}
CASES["filter7-2"] = (2, dict(BENCH, filter_size=7), bar)


@pytest.fixture(scope="module")
def dp_outputs():
    """{case: [every rank's FlowOutput]}, one spawned group per rank
    count; each stream in two process() calls."""
    out = {}
    for n in sorted({c[0] for c in CASES.values()}):
        names = [k for k, c in CASES.items() if c[0] == n]
        jobs = [("dp", TConfig(**CASES[k][1]), CASES[k][2]()) for k in names]
        out.update(zip(names, mesh.run(process_streams, n, "cpu", jobs)))
    return out


def _single(cfg, ev, calls=2):
    """The single engine on the stream in `calls` process() calls."""
    eng = teng.FlowEngine(cfg, device="cpu")
    if calls == 1:
        return eng.process(ev)
    half = len(ev) // 2
    return concat(eng.process(ev[:half]), eng.process(ev[half:]))


def _bits(a):
    """The bit patterns of an array (-0.0 and +0.0 differ)."""
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
           "r_local", "theta_local", "scale")


def assert_bitwise(ref, got, what):
    """Every output column equal bit for bit, signed zeros included."""
    for col in COLUMNS:
        np.testing.assert_array_equal(_bits(getattr(got, col)),
                                      _bits(getattr(ref, col)),
                                      err_msg=f"{what} {col}")


@pytest.mark.parametrize("name", list(CASES))
def test_dp_matches_single_engine(dp_outputs, name):
    n, kw, stream = CASES[name]
    cfg = TConfig(**kw)
    ev = stream()
    ref = _single(cfg, ev)
    assert (ref.r_local > 0).sum() > 40
    if cfg.center_correction:
        flags, _ = teng.FlowEngine(cfg, device="cpu").pack_r2(ev)
        assert flags.sum() > 5         # the correction pass has lanes
    ranks = dp_outputs[name]
    assert len(ranks) == n
    # rank 0 returns the whole output, the other ranks None
    assert all(r is None for r in ranks[1:])
    assert_bitwise(ref, ranks[0], name)


def test_dp_matches_jax_sharded_engine(dp_outputs, monkeypatch):
    """The port's dp on 2 gloo ranks against farms_tpu's ShardedFlowEngine
    on 2 virtual devices, one stream in two calls each."""
    pytest.importorskip("jax")
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.parallel.dp import ShardedFlowEngine as JSharded

    ev = bar()
    half = len(ev) // 2
    eng = JSharded(JConfig(use_pallas=False, **BENCH), num_devices=2)
    want = concat(eng.process(ev[:half]), eng.process(ev[half:]))
    single = teng.FlowEngine(TConfig(**BENCH), device="cpu")
    first, passes = _process_recording_aperture(single, ev[:half],
                                                 monkeypatch)
    second, more = _process_recording_aperture(single, ev[half:],
                                               monkeypatch)
    _assert_engines_agree(want, dp_outputs["benchmark-2"][0], passes + more,
                          TConfig(**BENCH), "jax dp n=2")
    assert_bitwise(concat(first, second), dp_outputs["benchmark-2"][0],
                   "single")


def test_one_rank_runs_in_process_without_a_group():
    assert not torch.distributed.is_initialized()
    cfg = TConfig(**FIDELITY)
    ev = rank2_bar()
    eng = ShardedFlowEngine(cfg, num_devices=1, device="cpu")
    assert eng.lanes == (0, cfg.chunk_size)
    assert_bitwise(_single(cfg, ev, calls=1), eng.process(ev), "dp n=1")


def test_chunk_not_divisible_raises():
    """dp.py:38-41: the lanes of a micro-step split evenly over the
    ranks (a world of 2 as the mesh sees it: no group is needed to
    refuse)."""
    cfg = TConfig(width=64, height=64, chunk_size=63)
    with mock.patch.object(mesh, "rank_and_size", return_value=(0, 2)):
        with pytest.raises(ValueError, match="not divisible"):
            ShardedFlowEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        ShardedFlowEngine(cfg, num_devices=2, device="cpu")


_CUT = 256


@pytest.fixture(scope="module")
def dp_checkpoints(tmp_path_factory):
    """checkpoint_runs on 2 gloo ranks with a single-engine checkpoint of
    the same cut: (rank 0's outputs, dp's checkpoint, the single one)."""
    tmp = tmp_path_factory.mktemp("dp_ckpt")
    cfg = TConfig(**FIDELITY)
    eng = teng.FlowEngine(cfg, device="cpu")
    eng.process(rank2_bar()[:_CUT])
    single = tckpt.save_engine(eng, str(tmp / "single"))
    own = str(tmp / "dp.npz")
    outs = mesh.run(checkpoint_runs, 2, "cpu", "dp", cfg, rank2_bar(), _CUT,
                    own, single)
    return outs, own, single


@pytest.mark.parametrize("direction", ["single-to-dp", "dp-to-single"])
def test_dp_checkpoint_resumes(dp_checkpoints, direction):
    """A single-engine checkpoint resumes on 2 dp ranks and a dp one in
    the single engine, each equal to the single engine's continuation
    bit for bit."""
    outs, own, single = dp_checkpoints
    cfg = TConfig(**FIDELITY)
    ev = rank2_bar()
    ref = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"),
                            single).process(ev[_CUT:])
    assert (ref.r_local > 0).sum() > 40
    if direction == "single-to-dp":
        got = outs["from_single"]
    else:
        got = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"),
                                own).process(ev[_CUT:])
    assert_bitwise(ref, got, direction)
    assert_bitwise(_single(cfg, ev[:_CUT], calls=1), outs["first"], "first")

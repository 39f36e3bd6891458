"""The port's multi-host engine (parallel/multihost.py) on gloo ranks.

tests/test_multihost.py on the port. The (tx, ev) grids (1, 1) in
process, (2, 2), (4, 1) and (1, 4) on 4 spawned ranks and (3, 1) on 3 (a
64-row sensor padded to 66) run the fidelity shape of
tests/test_multihost.py:31-35 (snapshots, coarse chain, rank-2
correction) in two process() calls that carry the state; (2, 2) also the
benchmark shape, filter size 7 and fine aperture phasing (the in-phase
kill in the shard step). Every rank returns the same complete output,
equal to the single engine's bit for bit on every column. These streams
have no scale id at a float64 tie that the band integral breaks the other
way (tests/test_torch_halo_engine.py), so the equality is exact.

Also: write_flow_distributed on the (2, 2) grid, whose event shards span
processes, writes the single engine's file byte for byte with the output
all-gather made to raise; a (2, 2) checkpoint resumes in the single
engine and the other way round; init_distributed joins a world from the
launcher's environment alone (two CLI processes with --multihost); the
engine's refusals; and the port against farms_tpu's MultiHostFlowEngine
on a (2, 2) mesh of virtual devices.
"""
import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.multihost import MultiHostFlowEngine
from farms_tpu_torch.pipeline import checkpoint as tckpt
from farms_tpu_torch.pipeline import engine as teng
from test_torch_dp_engine import (BENCH, FIDELITY, _single, assert_bitwise,
                                  bar, rank2_bar)
from test_torch_engine import (_assert_engines_agree,
                               _process_recording_aperture)
from test_torch_multihost_ranks import (checkpoint_runs, concat,
                                        process_streams, write_distributed)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: ((tx, ev), config, stream)
CASES = {
    "fidelity-2x2": ((2, 2), FIDELITY, rank2_bar),
    "fidelity-4x1": ((4, 1), FIDELITY, rank2_bar),
    "fidelity-1x4": ((1, 4), FIDELITY, rank2_bar),
    "benchmark-2x2": ((2, 2), BENCH, bar),
    "filter7-2x2": ((2, 2), dict(BENCH, filter_size=7), bar),
    "fine-phasing-2x2": ((2, 2), dict(BENCH, aperture_sub_phases=4), bar),
    "padded-3x1": ((3, 1), FIDELITY, rank2_bar),
}


@pytest.fixture(scope="module")
def multihost_outputs():
    """{case: [every rank's FlowOutput]}, one spawned group per rank
    count."""
    out = {}
    for n in sorted({a * b for (a, b), _, _ in CASES.values()}):
        names = [k for k, c in CASES.items() if c[0][0] * c[0][1] == n]
        jobs = [(CASES[k][0], TConfig(**CASES[k][1]), CASES[k][2]())
                for k in names]
        out.update(zip(names, mesh.run(process_streams, n, "cpu", jobs)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_multihost_matches_single_engine(multihost_outputs, name):
    (tx, ev_), kw, stream = CASES[name]
    cfg = TConfig(**kw)
    ev = stream()
    ref = _single(cfg, ev)
    assert (ref.r_local > 0).sum() > 40
    ranks = multihost_outputs[name]
    assert len(ranks) == tx * ev_
    for r, got in enumerate(ranks):
        assert_bitwise(ref, got, f"{name} rank {r}")


def test_one_rank_grid_runs_in_process():
    """The (1, 1) grid of a process without a group: the default mesh."""
    assert not torch.distributed.is_initialized()
    cfg = TConfig(**FIDELITY)
    ev = rank2_bar()
    eng = MultiHostFlowEngine(cfg, device="cpu")
    assert (eng.mesh.tx, eng.mesh.ev) == (1, 1)
    half = len(ev) // 2
    got = concat(eng.process(ev[:half]), eng.process(ev[half:]))
    assert_bitwise(_single(cfg, ev), got, "1x1")


def test_padded_grid_holds_padded_bands():
    """64 rows over tx = 3 pad to 66: three 22-row bands (a world of 3
    as the mesh sees it; no collective runs)."""
    with mock.patch.object(mesh, "rank_and_size", return_value=(2, 3)):
        eng = MultiHostFlowEngine(TConfig(**FIDELITY),
                                  mesh=mesh.make_global_mesh(3, 1),
                                  device="cpu")
    assert eng.cfg.array_width == 66 and eng.cfg.width == 64
    assert tuple(eng.state.t_surf.shape) == (22, 48)


def test_refusals():
    """multihost.py:96-105: the dense path only, and the lanes of a
    micro-step split evenly over ev."""
    with pytest.raises(ValueError, match="dense"):
        MultiHostFlowEngine(TConfig(**dict(BENCH, use_dense=False)),
                            device="cpu")
    with mock.patch.object(mesh, "rank_and_size", return_value=(0, 2)):
        grid = mesh.make_global_mesh(1, 2)
        with pytest.raises(ValueError, match="not divisible"):
            MultiHostFlowEngine(TConfig(width=64, height=64,
                                        chunk_size=63),
                                mesh=grid, device="cpu")
        with pytest.raises(ValueError, match="mesh 3x1"):
            mesh.make_global_mesh(3, 1)


def test_write_flow_distributed_writes_the_single_engines_file(tmp_path):
    cfg = TConfig(**FIDELITY)
    ev = rank2_bar()
    want = tio.write_flow_txt(_single(cfg, ev, calls=1),
                              str(tmp_path / "single"))
    base = str(tmp_path / "dist")
    path = mesh.run(write_distributed, 4, "cpu", (2, 2), cfg, ev, base)
    assert path == base + tio.OUTPUT_SUFFIX
    with open(want, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    # the staged parts are gone
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (want, path))


_CUT = 256


@pytest.fixture(scope="module")
def multihost_checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh_ckpt")
    cfg = TConfig(**FIDELITY)
    eng = teng.FlowEngine(cfg, device="cpu")
    eng.process(rank2_bar()[:_CUT])
    single = tckpt.save_engine(eng, str(tmp / "single"))
    own = str(tmp / "multihost.npz")
    outs = mesh.run(checkpoint_runs, 4, "cpu", (2, 2), cfg, rank2_bar(),
                    _CUT, own, single)
    return outs, own, single


@pytest.mark.parametrize("direction", ["single-to-multihost",
                                       "multihost-to-single"])
def test_multihost_checkpoint_resumes(multihost_checkpoints, direction):
    outs, own, single = multihost_checkpoints
    cfg = TConfig(**FIDELITY)
    ev = rank2_bar()
    ref = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"),
                            single).process(ev[_CUT:])
    assert (ref.r_local > 0).sum() > 40
    if direction == "single-to-multihost":
        got = outs["from_single"]
    else:
        got = tckpt.load_engine(teng.FlowEngine(cfg, device="cpu"),
                                own).process(ev[_CUT:])
    assert_bitwise(ref, got, direction)
    assert_bitwise(_single(cfg, ev[:_CUT], calls=1), outs["first"], "first")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_world(argv, world, local_world):
    """argv in `world` processes, each with the environment a launcher
    gives rank r; returns [(returncode, output)]."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r % local_world),
                   LOCAL_WORLD_SIZE=str(local_world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        results.append((p.returncode, out))
    return results


def test_init_distributed_from_the_environment(tmp_path):
    """Two CLI processes with --multihost and a launcher's environment
    alone (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE = 1, MASTER_ADDR,
    MASTER_PORT) join one world of two hosts, (tx, ev) = (1, 2): rank 0
    alone prints the benchmark line, and the file is the single
    engine's."""
    ev = bar()
    base = str(tmp_path / "events")
    tio.write_events_txt(ev, base)
    point = ["--width", "64", "--height", "64", "--chunk-size", "64",
             "--sub-phases", "2", "--wire", "f16", "--max-window", "10",
             "--device", "cpu"]
    argv = [sys.executable, "-m", "farms_tpu_torch.cli", "--filename", base,
            *point]
    want = tio.write_flow_txt(_single(TConfig(**BENCH), ev, calls=1),
                              str(tmp_path / "single"))
    for attempt in range(2):
        results = _launch_world(argv + ["--multihost", "--engine",
                                        "multihost"], 2, 1)
        # a port taken between the probe and the rendezvous: retry once
        if attempt or not any("EADDRINUSE" in out or "address already in"
                              " use" in out for _, out in results):
            break
    for r, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    assert results[0][1].count("[Benchmark Main]") == 1
    assert "[Benchmark Main]" not in results[1][1]
    with open(want, "rb") as a, open(base + tio.OUTPUT_SUFFIX, "rb") as b:
        assert a.read() == b.read()


def test_multihost_matches_jax_multihost_engine(multihost_outputs,
                                                monkeypatch):
    """The port's (2, 2) grid against farms_tpu's MultiHostFlowEngine on
    a (2, 2) mesh of 4 of the 8 virtual CPU devices, the fidelity shape
    in two calls each."""
    pytest.importorskip("jax")
    import jax
    from jax.sharding import Mesh

    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.parallel.multihost import MultiHostFlowEngine as JMulti

    ev = rank2_bar()
    half = len(ev) // 2
    grid = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("tx", "ev"))
    eng = JMulti(JConfig(use_pallas=False, **FIDELITY), mesh=grid)
    want = concat(eng.process(ev[:half]), eng.process(ev[half:]))
    single = teng.FlowEngine(TConfig(**FIDELITY), device="cpu")
    _, passes = _process_recording_aperture(single, ev[:half], monkeypatch)
    _, more = _process_recording_aperture(single, ev[half:], monkeypatch)
    _assert_engines_agree(want, multihost_outputs["fidelity-2x2"][0],
                          passes + more, TConfig(**FIDELITY),
                          "jax multihost 2x2")

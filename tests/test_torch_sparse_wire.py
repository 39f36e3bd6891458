"""The port's sparse wire (wire="sparse"): the device-side compaction
against farms_tpu's, and the decoded output against the f16 wire.

- `_sparse_pack_outputs` is bitwise equal to farms_tpu's on the same
  wire blocks, rider included (farms_tpu/pipeline/engine.py:691).
- The sparse wire is a re-encoding of the f16 wire: every decoded column
  equals the f16 run's bit for bit (the sparse cases of tests/test_wire.py
  from :63), also where the payload outgrows the rider; the sharded
  engines refuse it as farms_tpu's do.
"""
import numpy as np
import pytest
import torch

from farms_tpu_torch import cli as tcli
from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.pipeline import engine as teng

torch.set_num_threads(1)

COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
           "r_local", "theta_local", "scale")


def _wire_blocks(steps, m, seed, present_frac):
    """Random f16-wire blocks: vx/vy words nonzero on `present_frac` of
    the lanes, the valid bit on a subset of those, scale ids 0-10."""
    rng = np.random.default_rng(seed)
    present = rng.random((steps, m)) < present_frac
    valid = present & (rng.random((steps, m)) < 0.6)
    words = rng.integers(1, 2**31, (steps, 2, m)).astype(np.int32)
    words[:, 0][~present] = 0
    words[:, 1][~valid] = 0
    aux = (rng.integers(0, 11, (steps, m))
           + 128 * valid).astype(np.uint8)
    return words, aux


@pytest.mark.parametrize("steps, m, frac, rider", [
    (2, 512, 0.05, None), (3, 1024, 0.9, None), (2, 256, 0.5, 32),
    (1, 64, 0.0, None),
])
def test_sparse_pack_bitwise_equals_jax(steps, m, frac, rider, monkeypatch):
    """aux_plus and pay equal farms_tpu's byte for byte: counts, rider
    (whole, or 32 lanes), payload order, an empty payload."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from farms_tpu.pipeline import engine as jeng

    if rider is not None:
        monkeypatch.setattr(jeng, "_SPARSE_RIDER_LANES", rider)
        monkeypatch.setattr(teng, "_SPARSE_RIDER_LANES", rider)
    words, aux = _wire_blocks(steps, m, 7 + steps, frac)
    want = jeng._sparse_pack_outputs(jnp.asarray(words), jnp.asarray(aux))
    got = teng._sparse_pack_outputs(torch.from_numpy(words),
                                    torch.from_numpy(aux))
    for g, w, dtype in zip(got, want, (torch.uint8, torch.int32)):
        assert g.dtype == dtype
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_fetch_sparse_decodes_both_ways(monkeypatch):
    """_fetch_sparse reads the payload from the rider where it fits and
    from the payload prefix where it does not; both give the present and
    valid words in lane order."""
    words, aux = _wire_blocks(2, 256, 3, 0.5)
    for rider in (65536, 32):
        monkeypatch.setattr(teng, "_SPARSE_RIDER_LANES", rider)
        a, pp, pv = teng._fetch_sparse(teng._sparse_pack_outputs(
            torch.from_numpy(words), torch.from_numpy(aux)))
        present = words[:, 0].reshape(-1) != 0
        valid = (aux.reshape(-1) & 0x80) != 0
        assert (pp.size + pv.size > rider) == (rider == 32)
        np.testing.assert_array_equal(pp, words[:, 0].reshape(-1)[present])
        np.testing.assert_array_equal(pv, words[:, 1].reshape(-1)[valid])
        np.testing.assert_array_equal(a & 0xBF, aux.reshape(-1))
        np.testing.assert_array_equal((a & 0x40) != 0, present)


def _assert_same_output(a, b):
    for col in COLUMNS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col


def _run(wire, ev, **kw):
    cfg = TConfig(wire=wire, **kw)
    return teng.FlowEngine(cfg, device="cpu").process(ev)


def test_sparse_matches_f16_exactly():
    """test_wire.py:63 on the port."""
    kw = dict(width=128, height=128, chunk_size=512, steps_per_scan=2)
    ev = tio.synthetic_translating_bar(width=128, height=128, bar_len=40,
                                       duration_us=60_000, seed=3)
    a, b = _run("f16", ev, **kw), _run("sparse", ev, **kw)
    assert (a.r_local > 0).sum() > 100
    _assert_same_output(a, b)


def test_sparse_mostly_invalid_stream():
    """test_wire.py:75: almost no valid flow (tiny and empty payloads)."""
    kw = dict(width=128, height=128, chunk_size=512, steps_per_scan=2)
    ev = tio.synthetic_random_events(2048, width=128, height=128,
                                     rate_hz=1e4, seed=7)
    _assert_same_output(_run("f16", ev, **kw), _run("sparse", ev, **kw))


def test_sparse_tail_past_rider(monkeypatch):
    """test_wire.py:91: a payload larger than the rider is read from the
    payload prefix and still decodes exactly."""
    monkeypatch.setattr(teng, "_SPARSE_RIDER_LANES", 32)
    fetched = []
    fetch = teng._fetch_sparse

    def spy(out):
        got = fetch(out)
        fetched.append(got[1].size + got[2].size)
        return got

    monkeypatch.setattr(teng, "_fetch_sparse", spy)
    kw = dict(width=128, height=128, chunk_size=320, steps_per_scan=2)
    ev = tio.synthetic_translating_bar(width=128, height=128, bar_len=40,
                                       duration_us=60_000, seed=3)
    want, got = _run("f16", ev, **kw), _run("sparse", ev, **kw)
    assert max(fetched) > 32, "fixture must overflow the rider"
    _assert_same_output(want, got)


def test_sparse_with_phases_and_correction():
    """The fidelity shape (phases, snapshots, coarse correction) on the
    sparse wire equals its f16 run."""
    kw = dict(width=64, height=64, chunk_size=256, sub_phases=2,
              aperture_sub_phases=2, causal_snapshots=4,
              center_correction=64, correction_coarse_chain=True)
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=24,
                                       duration_us=40_000, jitter_us=15,
                                       seed=2)
    _assert_same_output(_run("f16", ev, **kw), _run("sparse", ev, **kw))


def test_sparse_rejects_sharded_engines():
    """test_wire.py:115: the dp, halo and multihost engines refuse the
    sparse wire with farms_tpu's words (here as one in-process rank)."""
    from farms_tpu_torch.parallel import (HaloFlowEngine, MultiHostFlowEngine,
                                          ShardedFlowEngine)

    cfg = TConfig(width=64, height=64, chunk_size=64, wire="sparse")
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=16,
                                       duration_us=10_000)[:128]
    for make in (ShardedFlowEngine, HaloFlowEngine, MultiHostFlowEngine):
        eng = make(cfg, device="cpu")
        with pytest.raises(ValueError, match="sharded engines ship the "
                                             "dense f16/f32 wire"):
            eng.process(ev)


def test_cli_sparse_writes_the_f16_file(tmp_path, capsys):
    """`--wire sparse` through the CLI writes the `--wire f16` file byte
    for byte."""
    ev = tio.synthetic_translating_bar(width=64, height=64, bar_len=24,
                                       duration_us=40000, jitter_us=15,
                                       seed=2)[:900]
    base = str(tmp_path / "ev")
    tio.write_events_txt(ev, base)
    files = {}
    for wire in ("f16", "sparse"):
        assert tcli.main(["--filename", base, "--width", "64", "--height",
                          "64", "--chunk-size", "256", "--sub-phases", "2",
                          "--device", "cpu", "--wire", wire]) == 0
        with open(base + tio.OUTPUT_SUFFIX, "rb") as fh:
            files[wire] = fh.read()
    assert files["sparse"] == files["f16"]
    assert len(files["f16"].splitlines()) == len(ev)

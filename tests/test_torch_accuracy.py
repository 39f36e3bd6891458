"""The port's accuracy sweep (`farms_tpu_torch.bench.accuracy`) against
`scripts/accuracy_sweep.py`.

- `make_stream` gives the JAX script's streams byte for byte, both kinds.
- `metrics` gives the JAX script's dict on the same inputs.
- On a 64 x 64 bar-plus-noise stream at chunk 256, at both presets'
  (P, A, S) and a correction budget of a quarter of the chunk (the
  fidelity preset's 32768 of 131072), the port's `run_row` on the CPU
  and `farms_tpu`'s FlowEngine on the CPU, each against the same oracle,
  agree. Tolerance: the engines' outputs meet `_assert_engines_agree`
  (validity equal on at least 99.9 % of lanes; scale ids equal or tied
  on at least 99.5 % of the commonly valid ones), so the two validity
  agreements differ by at most the share of lanes whose validity flipped
  between the engines, and the two scale matches by at most the share of
  compared lanes that flipped or whose scale differs at a float64 tie.
- The oracle cache key changes when any event's t, x or y changes.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from farms_tpu_torch.bench import accuracy
from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.pipeline.oracle import run_oracle
from farms_tpu_torch.pipeline.ties import scale_ties

from test_torch_engine import _assert_engines_agree, _multi_pass_bar

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (P, A, S, C, coarse) of the presets at chunk 256 (farms_tpu/cli.py:182,
# :188; the correction budget a quarter of the chunk, as 32768 of 131072)
_PRESETS = {"benchmark": (2, 2, 1, 0, False),
            "fidelity": (2, 2, 8, 64, True)}


@pytest.fixture(scope="module")
def jax_sweep():
    """scripts/accuracy_sweep.py, imported by path."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "accuracy_sweep", os.path.join(REPO, "scripts", "accuracy_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    """The 64 x 64 stream and its oracle columns."""
    ev = _multi_pass_bar(3)
    o = run_oracle(ev, TConfig(width=64, height=64))
    orc = {k: getattr(o, k) for k in ("r_true", "theta_true", "vx", "vy",
                                      "r_local", "theta_local")}
    orc["scale"] = o.scale.astype(np.int32)
    return ev, orc


@pytest.mark.parametrize("kind", ["bar", "random"])
def test_make_stream_equals_jax(jax_sweep, kind):
    want = jax_sweep.make_stream(kind, 3000)
    got = accuracy.make_stream(kind, 3000)
    for col in ("x", "y", "t", "pol"):
        a, b = getattr(want, col), getattr(got, col)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), col


def test_metrics_equal_jax(jax_sweep, small):
    """The same engine output and oracle columns give the same dict."""
    ev, orc = small
    got = teng.FlowEngine(TConfig(width=64, height=64, chunk_size=256,
                                  sub_phases=2, wire="f16"),
                          device="cpu").process(ev)
    want = jax_sweep.metrics(got, orc)
    assert want["n_compared"] > 100
    assert json.dumps(accuracy.metrics(got, orc)) == json.dumps(want)


@pytest.mark.parametrize("preset", list(_PRESETS))
def test_rows_agree_with_jax_engine(jax_sweep, small, preset, monkeypatch):
    from farms_tpu.config import FlowConfig as JConfig
    from farms_tpu.pipeline.engine import FlowEngine as JEngine

    ev, orc = small
    P, A, S, C, coarse = _PRESETS[preset]
    passes = []
    aperture = teng.kernels.aperture

    def recording(flow_len, *a, **kw):
        passes.append(flow_len.clone())
        return aperture(flow_len, *a, **kw)

    monkeypatch.setattr(teng.kernels, "aperture", recording)
    row, got, _ = accuracy.run_row(
        ev, orc, chunk_size=256, sub_phases=P, aperture_sub_phases=A,
        causal_snapshots=S, correction=C, coarse_chain=coarse, device="cpu",
        width=64, height=64)
    cfg = TConfig(width=64, height=64, chunk_size=256, steps_per_scan=8,
                  sub_phases=P, aperture_sub_phases=A, causal_snapshots=S,
                  center_correction=C, correction_coarse_chain=coarse,
                  wire="f16")
    want = JEngine(JConfig(**{f: getattr(cfg, f) for f in (
        "width", "height", "chunk_size", "steps_per_scan", "sub_phases",
        "aperture_sub_phases", "causal_snapshots", "center_correction",
        "correction_coarse_chain", "wire")})).process(ev)
    _assert_engines_agree(want, got, passes, cfg, preset)
    jrow = jax_sweep.metrics(want, orc)
    for key in ("chunk_size", "sub_phases", "aperture_sub_phases",
                "causal_snapshots", "correction", "coarse_chain"):
        assert key in row
    assert row["n_valid_oracle"] == jrow["n_valid_oracle"]
    vj, vt = want.r_local > 0, got.r_local > 0
    flips = int((vj != vt).sum())
    assert abs(row["valid_agreement"] - jrow["valid_agreement"]) \
        <= flips / len(ev) + 1e-12, (row, jrow, flips)
    both = vj & vt
    tied = both & (want.scale != got.scale) & scale_ties(want, got, passes,
                                                         cfg)
    n_min = min(row["n_compared"], jrow["n_compared"])
    assert abs(row["scale_match"] - jrow["scale_match"]) \
        <= (flips + int(tied.sum())) / n_min + 1e-12, (row, jrow)


def test_oracle_key_covers_every_event(tmp_path, monkeypatch):
    """The key changes when any event's t, x or y changes, the last one
    included (the JAX script keys on the first 64 stamps only); a stored
    run is read back."""
    ev = tio.synthetic_random_events(200, width=32, height=32, seed=3)
    cfg = TConfig(width=32, height=32)
    key = accuracy.oracle_key(ev, cfg, "t")
    for col in ("t", "x", "y"):
        for i in (0, len(ev) - 1):
            arr = getattr(ev, col).copy()
            arr[i] += 1
            other = tio.EventBatch(**{**{c: getattr(ev, c) for c in
                                         ("x", "y", "t", "pol")}, col: arr})
            assert accuracy.oracle_key(other, cfg, "t") != key, (col, i)
    assert accuracy.oracle_key(ev, cfg, "u") != key
    assert accuracy.oracle_key(ev, TConfig(width=32, height=32,
                                           filter_size=5), "t") != key
    monkeypatch.setattr(accuracy, "CACHE_DIR", str(tmp_path))
    first = accuracy.oracle_cached(ev, cfg, "t")
    assert os.listdir(tmp_path) == [f"oracle_t_{key}.npz"]
    again = accuracy.oracle_cached(ev, cfg, "t")
    for k in first:
        assert first[k].tobytes() == again[k].tobytes(), k

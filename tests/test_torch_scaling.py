"""The port's scaling sweep (`farms_tpu_torch.bench.scaling`) on gloo
ranks of the CPU.

One sweep at N in {1, 2} of every engine (halo, multihost on (1, 2), dp,
spatial x tiles) at a 128 x 32 sensor: in every rank the engine's
process_resident call, decoded, must equal its process() bit for bit
(the sweep raises otherwise) and, on rank 0, every column of the single
engine's process() (`lanes_unlike_single` 0); the rows written to --out
carry the JAX sweep's keys (scripts/scaling_sweep.py:138-145).
"""
import json

import torch

from farms_tpu_torch.bench import scaling

torch.set_num_threads(1)

_ROW_KEYS = {"devices", "engine", "events_per_sec", "efficiency_vs_1dev",
             "halo_replication_ceiling", "efficiency_vs_ceiling",
             "lanes_unlike_single"}
_CLASSES = {"halo": "HaloFlowEngine", "multihost": "MultiHostFlowEngine",
            "dp": "ShardedFlowEngine", "spatial": "SpatialFlowEngine"}


def test_sweep_rows_on_gloo(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    assert scaling.main(["--devices", "1", "2", "--device", "cpu",
                         "--width", "128", "--height", "32", "--chunk",
                         "256", "--calls", "2", "--replay-events", "2048",
                         "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["backend"] == "cpu" and res["card"] is None
    assert res["devices_run"] == [1, 2]
    assert res["config"]["events"] == 256 * 4 * 2
    assert list(res["engines"]) == list(scaling.ENGINES)
    single = res["engines"]["halo"][0]
    for name, rows in res["engines"].items():
        assert [r["devices"] for r in rows] == [1, 2]
        assert rows[0] == single             # the single engine, run once
        assert rows[0]["engine"] == "FlowEngine"
        assert rows[1]["engine"] == _CLASSES[name]
        for r in rows:
            assert set(r) == _ROW_KEYS
            assert r["events_per_sec"] > 0
            assert r["lanes_unlike_single"] == 0, (name, r)
            assert 0 < r["halo_replication_ceiling"] <= 1
            assert abs(r["efficiency_vs_ceiling"]
                       - r["efficiency_vs_1dev"]
                       / r["halo_replication_ceiling"]) < 1e-3
    # R = 2 at filter size 3: 64-row bands of halo and spatial; every row
    # on every rank of dp and of multihost's (1, 2) grid
    ceil = {n: rows[1]["halo_replication_ceiling"]
            for n, rows in res["engines"].items()}
    assert ceil == {"halo": round(64 / 68, 4), "spatial": round(64 / 68, 4),
                    "dp": 1.0, "multihost": 1.0}
    assert "lanes_unlike_single" in capsys.readouterr().out


def test_resident_output_of_the_single_engine_equals_process():
    """On one rank every engine is the single engine, and its decoded
    resident call is process()'s output bit for bit."""
    from farms_tpu_torch.config import FlowConfig
    from farms_tpu_torch.events.io import synthetic_random_events
    from farms_tpu_torch.pipeline.engine import FlowEngine

    cfg = FlowConfig(width=64, height=32, chunk_size=256, max_window=20,
                     steps_per_scan=4)
    ev = synthetic_random_events(1500, width=64, height=32, rate_hz=5e6)
    eng = scaling.make_engine("halo", cfg, 1, "cpu")
    assert type(eng) is FlowEngine
    want = eng.process(ev)
    eng.reset()
    got = scaling.resident_output(eng, ev)
    assert not scaling._differing(want, got).any()
    assert scaling.halo_ceiling(eng) == 1.0

"""BENCHMARK.json and the files it names: every one loads, obeys the
contract's shapes, and the harness finds an added file by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from flowbench import harness
from flowbench.reference.compare import NUMBERS

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_flowbench_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]
                                                + BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_flowbench_every_cell_loads(cell):
    c = harness.load_cell(cell)
    assert (harness.HERE / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert harness.flow_config(c.flow).width == c.flow["width"]
    assert set(c.limits) == set(NUMBERS)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        mod = harness.load_module(harness.HERE / "metrics"
                                  / f"{m['name']}.py", "m")
        assert callable(mod.read)
        # a reading with nothing traced gives no number, never 0
        assert mod.read({"calls": [], "trace": None, "flow": c.flow,
                         "traffic": c.traffic, "config": c.config}) is None


def test_flowbench_finds_added_files(tmp_path, monkeypatch):
    """A cell, configuration, mix and metric added as files only."""
    for d in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(harness.HERE / d, tmp_path / "flowbench" / d)
    fb = tmp_path / "flowbench"
    cfg = json.loads((fb / "configs" / "gen4hd.json").read_text())
    cfg["flow"]["filter_size"] = 7
    (fb / "configs" / "gen4hd-k7.json").write_text(json.dumps(cfg))
    tr = json.loads((fb / "traffic" / "replay.json").read_text())
    (fb / "traffic" / "slow.json").write_text(json.dumps(dict(tr, rate=5e6)))
    (fb / "checks" / "gen4hd-k7.slow.json").write_text(
        (fb / "checks" / "gen4hd.replay.json").read_text())
    (fb / "metrics" / "added_metric.py").write_text(
        "def read(reading):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="gen4hd-k7",
                                 file="flowbench/configs/gen4hd-k7.json"))
    bench["workloads"].append({"name": "gen4hd-k7.slow",
                               "config": "gen4hd-k7", "traffic": "slow",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "added_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "events_per_s",
                               "workloads": ["gen4hd-k7.slow"]})
    for m in bench["end_to_end"]:
        if m["name"] == "events_per_s":
            m["workloads"].append("gen4hd-k7.slow")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", fb)
    c = harness.load_cell("gen4hd-k7.slow", bench)
    assert c.flow["filter_size"] == 7 and c.traffic["rate"] == 5e6
    assert [m["name"] for m in c.per_layer][-1] == "added_metric"
    mod = harness.load_module(fb / "metrics" / "added_metric.py", "m")
    assert mod.read({}) == 42.0


MESH = {"call": "farms_tpu_torch.parallel.mesh.make_global_mesh",
        "kwargs": {"tx": 1}}


@pytest.mark.parametrize("engine,engine_kwargs,traffic", [
    ("farms_tpu_torch.parallel.tiling.SpatialFlowEngine",
     {"mesh_shape": [1, 1]}, {}),
    ("farms_tpu_torch.parallel.multihost.MultiHostFlowEngine",
     {"mesh": MESH}, {}),
    ("farms_tpu_torch.pipeline.engine.FlowEngine", {}, {
        "generator": {"function": "flowbench.traffic.gen.uniform_random",
                      "hot_fraction": 0.25},
        "bursts": {"factor": 3, "every_s": 0.02, "length_s": 0.004}}),
])
def test_flowbench_engine_and_generator_from_files(engine, engine_kwargs,
                                                   traffic):
    """A configuration names its engine and the engine's keywords (a
    keyword may be built by a call, in the rank), a mix its generator
    and bursts: a cell of each runs correct with no code added."""
    from conftest import tiny_cell
    from flowbench import run
    cell = tiny_cell("gen4hd.replay", **traffic)
    cell.config.update(engine=engine, engine_kwargs=engine_kwargs)
    line, _ = run.execute(cell, 2**31 + 41, 0.4, False, "cpu")
    assert line["correct"] and line["attempted"] >= 1


def test_flowbench_names_stay_in_their_packages():
    with pytest.raises(ValueError):
        harness.resolve("os.system", "flowbench.traffic.")
    with pytest.raises(ValueError):
        harness.resolve("flowbench.harness.load_json", "farms_tpu_torch.")

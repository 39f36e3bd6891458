"""What every driver of the benchmark shares: the cell as its files state
it, the engine it builds, the event pool, the call spans and the
snapshots that the correctness check reads.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
`flowbench/configs/<config>.json` (the port's `FlowConfig` fields under
`flow`, the engine class by its import path and its card count, the
source and the cut), its
traffic mix `flowbench/traffic/<traffic>.json` (which driver runs the
window, `flowbench/drivers/<driver>.py`, the generator by its dotted
name with its keyword arguments, the schedule's bursts), its limits `flowbench/checks/<workload>.json`. Nothing here
names a cell, a generator or an engine.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MEBI = 1 << 20


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (names may hold
    dots, so not through the import system)."""
    if not path.exists():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict

    @property
    def flow(self) -> dict:
        return self.config["flow"]


def _reports(metric: dict, cell: str) -> bool:
    """A metric with `workloads` is reported in the cells it lists, one
    without it in every cell (as `setup_s`)."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json, with its files."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    ws = [w for w in bench["workloads"] if w["name"] == name]
    if not ws:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = ws[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(ROOT / cfg["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=load_json(HERE / "checks" / f"{name}.json")["limits"])


def flow_config(flow: dict):
    from farms_tpu_torch.config import FlowConfig
    return FlowConfig(**flow)


def resolve(name: str, prefix: str):
    """The object a dotted name (`package.module.name`) gives; the name
    has to start with `prefix`."""
    if not name.startswith(prefix):
        raise ValueError(f"{name!r} is not under {prefix!r}")
    module, _, attr = name.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def _built(value):
    """An engine keyword as the configuration states it: a value, or
    `{"call": "<dotted name>", "kwargs": {...}}` called in the rank
    (a mesh that makes process groups, say)."""
    if isinstance(value, dict) and "call" in value:
        return resolve(value["call"], "farms_tpu_torch.")(
            **{k: _built(v) for k, v in value.get("kwargs", {}).items()})
    return value


def make_engine(cell: Cell, device):
    """The engine class the configuration names by its import path
    (`engine`), built from the configuration's `flow`, its
    `engine_kwargs` and `device` (in each rank of a process group for a
    sharded engine)."""
    engine = resolve(cell.config["engine"], "farms_tpu_torch.")
    kwargs = {k: _built(v)
              for k, v in cell.config.get("engine_kwargs", {}).items()}
    return engine(flow_config(cell.flow), device=device, **kwargs)


def make_pool(cell: Cell, seed: int, device, n_events: int | None = None):
    """The cell's event pool from the seed: the generator the mix names
    (`generator.function`, a dotted name under flowbench.traffic,
    called with the sensor, the rate, the count, the seed and the device
    and the mix's keywords), its stamps reshaped by the mix's `bursts`
    where it has them."""
    from flowbench.traffic.gen import Pool, bursts
    tr, flow = cell.traffic, cell.flow
    spec = dict(tr["generator"])
    fn = resolve(spec.pop("function"), "flowbench.traffic.")
    rate = float(tr["rate"])
    s = fn(width=flow["width"], height=flow["height"], rate=rate,
           n_events=n_events or int(tr["pool_events"]), seed=seed,
           device=device, **spec)
    if "bursts" in tr:
        s = bursts(s, rate, **tr["bursts"])
    return Pool(s, rate)


def settle() -> None:
    """The end of set-up: collect what set-up left and freeze the
    survivors, so that the window's collections do not walk them."""
    gc.collect()
    gc.freeze()


def sample_indices(seed: int, within: int, count: int) -> list:
    """`count` window positions in [0, within) drawn from the seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0xF10B])
    return sorted(int(i) for i in rng.choice(within, min(count, within),
                                             replace=False))


def state_arrays(state) -> dict | None:
    """A whole-sensor SurfaceState as host arrays (None stays None)."""
    if state is None:
        return None
    return {"t_surf": state.t_surf.cpu().numpy(),
            "flow_len": state.flow_len.cpu().numpy(),
            "flow_vx": state.flow_vx.cpu().numpy(),
            "flow_vy": state.flow_vy.cpu().numpy()}


def sample_record(ev, prev, out, post) -> dict:
    """A checked call as host arrays: its events, the whole-sensor state
    before it (None: the initial state), its output columns (a
    FlowOutput, or columns already decoded) and the state after it."""
    cols = out if isinstance(out, dict) else output_columns(out)
    return {"x": np.asarray(ev.x), "y": np.asarray(ev.y),
            "t": np.asarray(ev.t), "prev": state_arrays(prev),
            "cols": cols, "post": state_arrays(post)}


def output_columns(out) -> dict:
    """The 7 computed columns of a FlowOutput."""
    return {k: np.asarray(getattr(out, k)) for k in (
        "r_true", "theta_true", "vx", "vy", "r_local", "theta_local",
        "scale")}


class Spans:
    """Host-clock spans of the window's calls: due (open loop only),
    start, end, events. With `annotate`, each call is also a profiler
    range (`flowbench.<name>`), so the device trace can tell where the
    host was."""

    def __init__(self, name: str):
        self.name = name
        self.calls = []

    def call(self, fn, events: int, due: float | None = None,
             annotate: bool = False):
        start = time.perf_counter()
        if annotate:
            import torch
            with torch.profiler.record_function(f"flowbench.{self.name}"):
                out = fn()
        else:
            out = fn()
        end = time.perf_counter()
        self.calls.append({"due": due, "start": start, "end": end,
                           "events": events, "traced": annotate})
        return out


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation (NumPy's)."""
    return float(np.percentile(np.asarray(values, np.float64), q))

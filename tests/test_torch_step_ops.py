"""The one micro-step: every engine runs it, and how many torch ops the
host dispatches for it.

Every engine (single, dp, halo, spatial, multihost) runs its micro-steps
through `pipeline.engine.micro_step` over its shard: one rank of each,
in-process on the CPU, against a counting wrapper.

The host enqueues a micro-step as eager torch ops, and in the
launch-bound cells (the resident replays) their count sets the pace. A
TorchDispatchMode counts every aten op that one `micro_step` dispatches,
views included, and pauses inside `kernels.local_flow`,
`kernels.aperture` and `kernels.integral`: on a card each of those is
one wrapper call that launches a hand-written kernel, here their plain
versions, whose ops are not the step's. The bounds are the counts of the
step before the shard geometry joined the single engine's and the halo
engine's steps into one; a change to the step may lower them, not raise
them.
"""
from __future__ import annotations

import collections
import importlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import synthetic_random_events
from farms_tpu_torch.ops import kernels
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.pipeline import engine as teng

torch.set_num_threads(1)

# the presets' operating points (farms_tpu_torch/cli.py) on a small sensor:
# the count depends on the phasing, not on the sensor's size
_PRESETS = {
    "benchmark": dict(chunk_size=131072, sub_phases=2, wire="f16"),
    "fidelity": dict(chunk_size=131072, sub_phases=2, aperture_sub_phases=2,
                     causal_snapshots=8, center_correction=32768,
                     correction_coarse_chain=True, wire="f16"),
}
# (aten ops outside the kernels, kernel wrapper calls) of one micro-step
_BOUNDS = {"benchmark": (321, 4), "fidelity": (508, 5)}
_KERNELS = ("local_flow", "aperture", "integral")


class _StepOps(TorchDispatchMode):
    """Counts the aten ops dispatched while no kernel wrapper runs."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.kernels = collections.Counter()
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.inside:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))

    def pausing(self, name, fn):
        def run(*args, **kw):
            if not self.inside:
                self.kernels[name] += 1
            self.inside += 1
            try:
                return fn(*args, **kw)
            finally:
                self.inside -= 1
        return run


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_one_micro_step_dispatches_no_more_ops(monkeypatch, preset):
    cfg = FlowConfig(width=96, height=64, steps_per_scan=1,
                     **_PRESETS[preset])
    ev = synthetic_random_events(2 * cfg.chunk_size, 96, 64, seed=3)
    eng = teng.FlowEngine(cfg, device="cpu")
    first, second = ({**{k: v[0] for k, v in chunk.items()},
                      "step": torch.tensor(i, dtype=torch.int32)}
                     for i, chunk in enumerate(eng.device_calls(ev, 1)))
    state, _ = teng.micro_step(eng.state, first, cfg)
    mode = _StepOps()
    for name in _KERNELS:
        monkeypatch.setattr(kernels, name,
                            mode.pausing(name, getattr(kernels, name)))
    with mode:
        teng.micro_step(state, second, cfg)
    n_ops, n_kernels = sum(mode.ops.values()), sum(mode.kernels.values())
    max_ops, want_kernels = _BOUNDS[preset]
    assert n_ops <= max_ops, (n_ops, max_ops)
    assert n_kernels == want_kernels, dict(mode.kernels)


# engine: (module, class, the shard its micro-steps run on at one rank)
_ENGINES = {
    "single": ("farms_tpu_torch.pipeline.engine", "FlowEngine", "Sensor"),
    "dp": ("farms_tpu_torch.parallel.dp", "ShardedFlowEngine", "Sensor"),
    "halo": ("farms_tpu_torch.parallel.halo", "HaloFlowEngine", "Band"),
    "spatial": ("farms_tpu_torch.parallel.tiling", "SpatialFlowEngine",
                "Tile"),
    "multihost": ("farms_tpu_torch.parallel.multihost",
                  "MultiHostFlowEngine", "Sensor"),
}


@pytest.mark.parametrize("engine", sorted(_ENGINES))
def test_every_engine_runs_the_one_micro_step(monkeypatch, engine):
    """One rank of each engine runs every micro-step of a stream through
    micro_step (on its shard) and gives the single engine's output bit
    for bit."""
    cfg = FlowConfig(width=64, height=48, chunk_size=512, sub_phases=2,
                     steps_per_scan=2, wire="f16")
    ev = synthetic_random_events(3 * 512 - 100, 64, 48, seed=5)
    want = teng.FlowEngine(cfg, device="cpu").process(ev)
    module, cls, shard_cls = _ENGINES[engine]
    shards = []
    step = teng.micro_step

    def counted(state, batch, cfg, lanes=None, shard=None):
        shards.append(type(shard).__name__ if shard else "Sensor")
        return step(state, batch, cfg, lanes, shard)

    monkeypatch.setattr(teng, "micro_step", counted)
    eng = getattr(importlib.import_module(module), cls)(cfg, device="cpu")
    got = mesh.run(eng.process, 1, "cpu", ev)
    assert shards == [shard_cls] * 4         # 2 calls of 2 micro-steps
    for name in ("x", "y", "t", "pol", "vx", "vy", "r_true", "theta_true",
                 "r_local", "theta_local", "scale"):
        assert (getattr(got, name).tobytes()
                == getattr(want, name).tobytes()), name

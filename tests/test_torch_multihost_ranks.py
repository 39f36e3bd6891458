"""Rank entry points for the tests of the port's dp and multihost engines.

Spawned ranks (farms_tpu_torch/parallel/mesh.py `run`) import the module
of the function they run, so this one imports the port alone: no jax and
nothing of farms_tpu. It holds no tests.
"""
import dataclasses
from unittest import mock

import numpy as np
import torch.distributed as dist

from farms_tpu_torch.events.io import FlowOutput
from farms_tpu_torch.parallel import mesh, multihost
from farms_tpu_torch.parallel.dp import ShardedFlowEngine
from farms_tpu_torch.parallel.multihost import (MultiHostFlowEngine,
                                                make_global_mesh)
from farms_tpu_torch.pipeline.checkpoint import load_engine, save_engine


def concat(a: FlowOutput, b: FlowOutput) -> FlowOutput:
    """Two FlowOutputs end to end."""
    return FlowOutput(*(np.concatenate([getattr(a, f.name),
                                        getattr(b, f.name)])
                        for f in dataclasses.fields(FlowOutput)))


def every_rank(value):
    """[value of each rank], in rank order, on every rank."""
    world = mesh.rank_and_size()[1]
    if world == 1:
        return [value]
    values = [None] * world
    dist.all_gather_object(values, value)
    return values


def engine(kind, cfg, device="cpu"):
    """"dp": a ShardedFlowEngine over every rank; (tx, ev): a
    MultiHostFlowEngine on a new (tx, ev) mesh."""
    if kind == "dp":
        return ShardedFlowEngine(cfg, device=device)
    return MultiHostFlowEngine(cfg, mesh=make_global_mesh(*kind),
                               device=device)


def process_streams(jobs, device="cpu"):
    """Each (kind, cfg, events) job through a new engine on this rank's
    group, in order, the stream in two process() calls that carry the
    state. Returns, on rank 0, each job's [FlowOutput of every rank] (None
    where dp's other ranks return nothing)."""
    outs = []
    for kind, cfg, ev in jobs:
        eng = engine(kind, cfg, device)
        half = len(ev) // 2
        first, second = eng.process(ev[:half]), eng.process(ev[half:])
        out = None if first is None else concat(first, second)
        outs.append(every_rank(out))
    return outs


def write_distributed(kind, cfg, ev, base_path, device="cpu"):
    """write_flow_distributed on this rank's group with the output
    all-gather made to raise; returns the path rank 0 wrote."""
    eng = engine(kind, cfg, device)
    with mock.patch.object(multihost, "gather_lanes",
                           side_effect=AssertionError(
                               "write_flow_distributed gathered outputs")):
        return eng.write_flow_distributed(ev, base_path)


def checkpoint_runs(kind, cfg, ev, cut, own_path, single_path,
                    device="cpu"):
    """The stream cut at `cut`: its first part in a new engine, saved to
    `own_path`; and the rest from the single engine's checkpoint at
    `single_path` in a new engine. Returns {name: rank 0's FlowOutput}."""
    eng = engine(kind, cfg, device)
    first = eng.process(ev[:cut])
    save_engine(eng, own_path)
    restored = load_engine(engine(kind, cfg, device), single_path)
    return dict(first=first, from_single=restored.process(ev[cut:]))

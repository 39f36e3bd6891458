"""Rank entry points and host-side packing for the halo engine's tests.

Spawned ranks (farms_tpu_torch/parallel/mesh.py `run`) import the module
of the function they run, so this one imports the port alone: no jax and
nothing of farms_tpu. It holds no tests.
"""
from unittest import mock

from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.halo import HaloFlowEngine


def process_streams(jobs, device="cpu"):
    """Each (cfg, events) job through a new HaloFlowEngine on this rank's
    group, in order, so that one spawned group serves several streams.
    Returns the FlowOutputs (None on ranks other than 0)."""
    return [HaloFlowEngine(cfg, device=device).process(ev)
            for cfg, ev in jobs]


def pack_halo(cfg, ev, n):
    """HaloFlowEngine.pack_halo(ev) as rank 0 of n ranks packs it, in a
    process without a group: the host-side packing alone (every rank
    packs the same)."""
    with mock.patch.object(mesh, "rank_and_size", return_value=(0, n)):
        eng = HaloFlowEngine(cfg, device="cpu")
    return eng.pack_halo(ev)

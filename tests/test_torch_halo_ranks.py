"""Rank entry points and host-side packing for the halo engine's tests.

Spawned ranks (farms_tpu_torch/parallel/mesh.py `run`) import the module
of the function they run, so this one imports the port alone: no jax and
nothing of farms_tpu. It holds no tests.
"""
from unittest import mock

from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.halo import HaloFlowEngine
from farms_tpu_torch.pipeline.checkpoint import load_engine, save_engine


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


def checkpoint_runs(cfg, ev, cut, halo_path, single_path, device="cpu"):
    """tests/test_checkpoint.py:30-75 on this rank's group: the whole
    stream in one engine; the stream cut at `cut`, saved to `halo_path`
    and continued in a fresh engine; and the continuation from the
    single-engine checkpoint at `single_path`. Each restored engine must
    hold its own band. Returns {name: FlowOutput} on rank 0."""
    def restored(path):
        eng = load_engine(HaloFlowEngine(cfg, device=device), path)
        rows = eng.cfg.array_width // eng.n_shards
        if tuple(eng.state.t_surf.shape) != (rows, eng.cfg.array_height):
            raise AssertionError(f"restored band {eng.state.t_surf.shape}")
        return eng

    one = HaloFlowEngine(cfg, device=device).process(ev)
    eng = HaloFlowEngine(cfg, device=device)
    first = eng.process(ev[:cut])
    save_engine(eng, halo_path)
    second = restored(halo_path).process(ev[cut:])
    from_single = restored(single_path).process(ev[cut:])
    return dict(one=one, first=first, second=second,
                from_single=from_single)


def resident_runs(cfg, ev, device="cpu"):
    """HaloFlowEngine.process_resident(ev) on this rank's group, replayed
    twice from the state before its first call (as the benchmark harness
    replays it); each replay's lanes gathered and decoded as process()
    decodes them. Returns the two FlowOutputs on rank 0."""
    eng = HaloFlowEngine(cfg, device=device)
    fn, n = eng.process_resident(ev)
    perm = eng.pack_halo(ev, -(-n // cfg.chunk_size))[2]
    start = eng.state
    outs = []
    for _ in range(2):
        eng.state = start
        block = eng._gather(*fn(), perm is not None)
        outs.append(None if block is None
                    else eng._unpack([block], ev, n, perm))
    return outs

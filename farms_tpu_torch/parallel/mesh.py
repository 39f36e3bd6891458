"""Ranks of a multi-device run on torch.distributed.

Counterpart of `farms_tpu.parallel.mesh`: where JAX names a device mesh
inside one program, a torch run is one process per rank in one process
group. `run` starts the ranks (spawned processes, a `file://` rendezvous in
a temporary directory, so concurrent runs never race for a TCP port) with
NCCL on `cuda:rank` on the card and gloo on the CPU, and `rank_and_size`
tells the code in a rank where it is. A run of one rank stays in the
calling process and has no process group at all: the one-rank branches of
parallel/halo.py issue no collective.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import traceback
import warnings
from multiprocessing.connection import wait

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a rank blocked this long in one collective fails instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def rank_and_size() -> tuple[int, int]:
    """(rank, world size) of this process's group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every rank of this process's group (no-op without one)."""
    if rank_and_size()[1] > 1:
        dist.barrier()


def run(fn, world_size: int, device: str, *args):
    """fn(*args) on `world_size` ranks; returns rank 0's result.

    `device` is the torch device type of the ranks: "cuda" (rank r on
    cuda:r, NCCL; needs world_size cards) or "cpu" (gloo). With
    world_size <= 1, fn runs in this process without a process group. A
    failure in any rank raises here with that rank's traceback, and every
    rank process is stopped before this returns. `fn` and `args` are
    pickled into the ranks, so fn is a module-level function.
    """
    if world_size <= 1:
        return fn(*args)
    cuda = torch.device(device).type == "cuda"
    if cuda and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA "
                           f"devices, found {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs, conns = [], []
        for rank in range(world_size):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main,
                            args=(rank, world_size, cuda, init, send, fn,
                                  args), daemon=True)
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        ok = False
        try:
            results = _collect(procs, conns)
            ok = True
            return results[0]
        finally:
            for p in procs:
                if not ok:
                    p.terminate()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
            for c in conns:
                c.close()


def _collect(procs, conns) -> dict:
    """Each rank's (traceback, result) message; raises on the first
    failure or on a rank that ended without one."""
    results = {}
    pending = set(range(len(procs)))
    while pending:
        wait([conns[r] for r in pending] + [procs[r].sentinel
                                            for r in pending])
        for rank in sorted(pending):
            if conns[rank].poll():
                err, value = conns[rank].recv()
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                results[rank] = value
                pending.discard(rank)
            elif procs[rank].exitcode is not None:
                raise RuntimeError(f"rank {rank} exited with code "
                                   f"{procs[rank].exitcode} and no result")
    return results


def _rank_main(rank, world_size, cuda, init, conn, fn, args):
    # 6 test workers may share 8 cores; the host side of a rank is NumPy
    torch.set_num_threads(1)
    # torch 2.13 deprecates all_gather_into_tensor / reduce_scatter_tensor,
    # the names that torch 2.11 on the card also has
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module=r"torch\.distributed")
    # NCCL binds the group to the rank's card and sets up its communicator
    # here, not in the first collective of the caller's work
    device = {}
    if cuda:
        torch.cuda.set_device(rank)
        device = dict(device_id=torch.device("cuda", rank))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            world_size=world_size, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT, **device)
    try:
        value = fn(*args)
        conn.send((None, value if rank == 0 else None))
    except Exception:
        conn.send((traceback.format_exc(), None))
    finally:
        conn.close()
        dist.destroy_process_group()

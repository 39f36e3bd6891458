"""Ranks of a multi-device run on torch.distributed.

Counterpart of `farms_tpu.parallel.mesh` and of the process setup of
`farms_tpu.parallel.multihost`: where JAX names a device mesh inside one
program, a torch run is one process per rank in one process group.

- `run` starts the ranks of one host (spawned processes, a `file://`
  rendezvous in a temporary directory, so concurrent runs never race for a
  TCP port) with NCCL on `cuda:rank` on the card and gloo on the CPU;
- `init_distributed` joins a world that a launcher started (`torchrun`
  and the like: one process per rank, on one or more hosts);
- `rank_and_size` tells the code in a rank where it is, and
  `make_global_mesh` lays the ranks out as a (tx, ev) grid: `tx` shards
  the sensor rows (parallel/halo.py), `ev` the lanes of a micro-batch
  (parallel/dp.py); `make_spatial_mesh_2d` lays them out as a (tx, ty)
  grid of sensor tiles (parallel/tiling.py); `Axis` is one line of a
  grid and its process group.

A run of one rank stays in the calling process and has no process group
at all: the one-rank branches issue no collective.
"""
from __future__ import annotations

import dataclasses
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


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str = "cuda") -> None:
    """Join the world of an externally launched run (JAX:
    farms_tpu/parallel/multihost.py:38).

    Each argument left None comes from the launcher's environment, as
    `torchrun` sets it: WORLD_SIZE, RANK, LOCAL_RANK, and MASTER_ADDR /
    MASTER_PORT for the rendezvous (`coordinator_address` "host:port"
    replaces them). `device` "cuda" (the default) binds this rank to
    cuda:LOCAL_RANK with NCCL and raises RuntimeError where CUDA is not
    available; "cpu" takes gloo. Does nothing where a group exists already
    or the world has one rank.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    if dist.is_initialized():
        return
    env = os.environ
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", "1")))
    if world <= 1:
        return
    rank = process_id if process_id is not None else int(env["RANK"])
    extra = {}
    if torch.device(device).type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        extra = dict(device_id=torch.device("cuda", local))
    init = ("tcp://" + coordinator_address if coordinator_address
            else "env://")
    dist.init_process_group("nccl" if extra else "gloo", init_method=init,
                            world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT, **extra)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One line of the rank grid through this rank: the global ranks on
    it in axis order, this rank's index among them, and their process
    group (None: the default group where the line is the whole world, and
    where it is this rank alone, which issues no collective)."""

    ranks: tuple
    index: int
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @classmethod
    def world(cls) -> "Axis":
        """Every rank of this process's group, in rank order."""
        rank, world = rank_and_size()
        return cls(tuple(range(world)), rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (tx, ev) grid of the world's ranks (JAX:
    farms_tpu/parallel/multihost.py:58). Global rank r sits at
    i_tx = r % tx, j_ev = r // tx, so one band group (the tx ranks of one
    j_ev) is tx consecutive ranks: one host's cards under a launcher that
    numbers each host's ranks together, and the halo exchanges stay on
    that host. `band` is this rank's line along tx (the ranks that share
    its lanes and split its rows), `event` its line along ev (the ranks
    that hold its rows and split the lanes)."""

    tx: int
    ev: int
    band: Axis
    event: Axis

    @property
    def i_tx(self) -> int:
        return self.band.index

    @property
    def j_ev(self) -> int:
        return self.event.index


def make_global_mesh(tx: int | None = None, ev: int | None = None) -> Mesh:
    """This rank's place in a (tx, ev) grid of the world's ranks.

    Defaults: tx = the ranks of one host (LOCAL_WORLD_SIZE from the
    launcher, else the whole world), halved until it divides the world,
    and ev = world / tx. Raises ValueError where tx * ev is not the
    world. Every rank must call it, in the same order relative to its
    other collectives: it creates the process group of every line of the
    grid, on every rank, in one fixed order (torch.distributed requires
    it).
    """
    world = rank_and_size()[1]
    if tx is None:
        tx = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        while world % tx:
            tx //= 2
    if ev is None:
        ev = world // tx
    if tx < 1 or ev < 1 or tx * ev != world:
        raise ValueError(f"mesh {tx}x{ev} != {world} ranks")
    return Mesh(tx, ev, *_grid_lines(tx, ev))


def _grid_lines(n1: int, n2: int) -> tuple[Axis, Axis]:
    """This rank's two lines through an (n1, n2) grid of the world's
    ranks, global rank r at (r % n1, r // n1): the n1 consecutive ranks
    that share its second index, and the n2 that share its first. Creates
    the process group of every line of the grid, on every rank, in one
    fixed order (torch.distributed requires it)."""
    rank, world = rank_and_size()
    firsts = [tuple(j * n1 + i for i in range(n1)) for j in range(n2)]
    seconds = [tuple(j * n1 + i for j in range(n2)) for i in range(n1)]
    groups = {}
    for line in firsts + seconds:
        # the whole world and single ranks need no group of their own
        if 1 < len(line) < world:
            groups[line] = dist.new_group(list(line))
    first, second = firsts[rank // n1], seconds[rank % n1]
    return (Axis(first, rank % n1, groups.get(first)),
            Axis(second, rank // n1, groups.get(second)))


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """The (tx, ty) grid of the spatial engine's ranks (JAX: the ('tx',
    'ty') mesh of farms_tpu/parallel/tiling.py:47), laid out as
    make_global_mesh lays out (tx, ev): global rank r holds tile (i, j) =
    (r % tx, r // tx), row block i and column block j of every surface.
    `x` is its line along tx (the ranks that hold its columns and split
    the rows), `y` its line along ty (the ranks that hold its rows and
    split the columns), `grid` every rank of the grid."""

    tx: int
    ty: int
    x: Axis
    y: Axis
    grid: Axis


def make_spatial_mesh_2d(tx: int, ty: int) -> TileMesh:
    """This rank's place in a (tx, ty) grid of the world's ranks; raises
    ValueError where tx * ty is not the world. Every rank calls it, in the
    same order relative to its other collectives (it creates the lines'
    process groups)."""
    world = rank_and_size()[1]
    if tx < 1 or ty < 1 or tx * ty != world:
        raise ValueError(f"need {tx * ty} devices, have {world}")
    return TileMesh(tx, ty, *_grid_lines(tx, ty), Axis.world())


def make_spatial_mesh(num_devices: int | None = None) -> TileMesh:
    """The (N, 1) grid of x tiles over the world's N ranks; num_devices,
    where given, must be N."""
    world = rank_and_size()[1]
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} ranks, the world has "
                         f"{world}")
    return make_spatial_mesh_2d(world, 1)


def make_event_mesh(num_devices: int | None = None) -> Mesh:
    """The (1, ev) grid of event-parallel ranks; num_devices, where
    given, must be the world's size."""
    world = rank_and_size()[1]
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} ranks, the world has "
                         f"{world}")
    return make_global_mesh(tx=1, ev=world)


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

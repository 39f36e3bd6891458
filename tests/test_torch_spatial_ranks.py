"""Rank entry points for the spatial engine's tests.

Spawned ranks (farms_tpu_torch/parallel/mesh.py `run`) import the module
of the function they run, so this one imports the port alone: no jax and
nothing of farms_tpu. It holds no tests.
"""
import torch

from farms_tpu_torch.ops.dense_flow import aperture_y_clip
from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.parallel.halo import assemble_integral_tile
from farms_tpu_torch.parallel.tiling import SpatialFlowEngine, tile_slices
from farms_tpu_torch.pipeline.checkpoint import load_engine, save_engine


def run_jobs(jobs):
    """Each (function, args) job of this module in order on this rank's
    group, so that one spawned group serves every case of its size.
    Returns their results (rank 0's are kept)."""
    return [fn(*args) for fn, args in jobs]


def process_tiles(cfg, ev, shape, device="cpu"):
    """ev through a new SpatialFlowEngine on a (tx, ty) grid (None: x
    tiles over every rank). Returns the FlowOutput (None on ranks other
    than 0)."""
    return SpatialFlowEngine(cfg, mesh_shape=shape,
                             device=device).process(ev)


def integral_tiles(cfg, fields, shape):
    """assemble_integral_tile on this rank's tile of the whole-sensor
    f32 surfaces `fields` ((flow_len, vx, vy) at the array geometry of
    cfg padded to the grid). Returns every rank's band, in rank order."""
    grid = mesh.make_spatial_mesh_2d(*shape)
    pc = cfg.padded_to(*shape)
    band = assemble_integral_tile(
        *(torch.from_numpy(f)[tile_slices(pc, grid)].contiguous()
          for f in fields), grid, pc.max_window + 1, aperture_y_clip(pc))
    if grid.grid.size == 1:
        return [band]
    parts = [torch.empty_like(band) for _ in range(grid.grid.size)]
    torch.distributed.all_gather(parts, band)
    return parts


def checkpoint_tiles(cfg, ev, cut, shape, tile_path, single_path,
                     device="cpu"):
    """The stream cut at `cut` on a (tx, ty) grid, saved to `tile_path`,
    and the continuation from the single-engine checkpoint at
    `single_path` on the same grid; each restored engine must hold its
    own tile. Returns {name: FlowOutput} on rank 0."""
    def restored(path):
        eng = load_engine(SpatialFlowEngine(cfg, mesh_shape=shape,
                                            device=device), path)
        rows, cols = (s.stop - s.start for s in tile_slices(eng.cfg,
                                                            eng.mesh))
        if tuple(eng.state.t_surf.shape) != (rows, cols):
            raise AssertionError(f"restored tile {eng.state.t_surf.shape}")
        return eng

    eng = SpatialFlowEngine(cfg, mesh_shape=shape, device=device)
    first = eng.process(ev[:cut])
    save_engine(eng, tile_path)
    from_single = restored(single_path).process(ev[cut:])
    second = restored(tile_path).process(ev[cut:])
    return dict(first=first, second=second, from_single=from_single)


def resident_tiles(cfg, ev, shape, device="cpu"):
    """SpatialFlowEngine.process_resident(ev) on a (tx, ty) grid, its
    lanes gathered and decoded as process() decodes them. Returns the
    FlowOutput on rank 0."""
    eng = SpatialFlowEngine(cfg, mesh_shape=shape, device=device)
    fn, n = eng.process_resident(ev)
    block = eng._gather(*fn())
    return None if block is None else eng._unpack_outputs([block], ev, n)

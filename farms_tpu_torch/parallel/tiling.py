"""Spatially tiled flow engine: every surface cut into (tx, ty) tiles.

Counterpart of `farms_tpu.parallel.tiling.SpatialFlowEngine` on
torch.distributed ranks (NCCL on cards, gloo on the CPU, one rank with no
process group). JAX shards every [W, H] surface over a ('tx',) or ('tx',
'ty') mesh and lets GSPMD insert the halo exchanges and the cross-tile
prefix sums of the integral image; its `state_sharding` annotates the
surfaces for that partitioner. The port has no partitioner, so it has no
counterpart of `state_sharding`: each rank keeps its tile explicitly and
every halo is explicit, in both axes (the one micro-step of
pipeline/engine.py on parallel/halo.py's shard `Tile`):

- the plane fit reads an R-deep halo of the time surfaces, rows from the
  x ring, then columns of the row-extended array from the y ring (which
  carries the corners), and runs the local-flow kernel in tile mode;
- the aperture stage reads a (max_window + 1)-deep band of the global
  integral (`halo.assemble_integral_tile`: each rank integrates only its
  own tile, two offset folds make the partials global) and runs the pool
  kernel in tile mode, on a band pre-clamped in y.

Sensor dims that do not divide the grid are padded up (`padded_to(tx,
ty)`); pad cells are never written and read as outside the sensor. Every
micro-batch's lanes stay replicated, as in JAX: every rank uploads the
whole batch, scatters the winners of its tile and gathers the lanes it
owns, and the lanes are summed over the grid (-0.0 off the owner, so the
sum is the owner's bits). Outputs equal the single engine's, apart from
float64 scale ties of the partial-sum integral (pipeline/ties.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, FlowOutput
from farms_tpu_torch.parallel import mesh as meshlib
from farms_tpu_torch.parallel.halo import Tile, gather_summed
from farms_tpu_torch.pipeline.engine import (FlowEngine, _empty_output,
                                             refuse_sparse, scan_chunk)
from farms_tpu_torch.state.surfaces import SurfaceState, strip_state

_FIELDS = ("t_surf", "epoch", "flow_len", "flow_vx", "flow_vy")


def tile_slices(cfg: FlowConfig, grid: meshlib.TileMesh) -> tuple:
    """(rows, cols) slices of this rank's tile of an array-geometry
    surface: tile (i, j) holds rows [i W / tx, (i + 1) W / tx) and columns
    [j H / ty, (j + 1) H / ty) of the [W, H] array."""
    rows = cfg.array_width // grid.tx
    cols = cfg.array_height // grid.ty
    i, j = grid.x.index, grid.y.index
    return (slice(i * rows, (i + 1) * rows), slice(j * cols, (j + 1) * cols))


class SpatialFlowEngine(FlowEngine):
    """FlowEngine with surfaces tiled over a (tx, ty) grid of ranks.

    Pass `mesh_shape=(tx, ty)` for 2-D tiles; the default is 1-D x tiles
    over every rank of this process's group (`num_devices` of them, which
    must be the world, where given), or a `mesh` from
    mesh.make_spatial_mesh_2d. Construct it in every rank with the same
    config, and call `process` with the same stream on every rank.
    """

    def __init__(self, cfg: FlowConfig, num_devices: int | None = None,
                 mesh: meshlib.TileMesh | None = None,
                 mesh_shape: tuple[int, int] | None = None, device="cuda"):
        if not cfg.use_dense:
            raise ValueError(
                "spatial tiling requires the dense compute path "
                "(use_dense=True): its stencils shard; per-event gathers "
                "do not")
        if mesh is None:
            mesh = (meshlib.make_spatial_mesh_2d(*mesh_shape) if mesh_shape
                    else meshlib.make_spatial_mesh(num_devices))
        self.mesh = mesh
        # the base constructor (the kernel build) sees the semantic
        # geometry; the tiles hold the padded one
        super().__init__(cfg, device)
        self.cfg = cfg.padded_to(mesh.tx, mesh.ty)
        self.shard = Tile(self.cfg, mesh)
        self.reset()

    def _tile(self, state: SurfaceState) -> SurfaceState:
        sl = tile_slices(self.cfg, self.mesh)
        return SurfaceState(*(getattr(state, f)[sl].contiguous()
                              for f in _FIELDS), state.step)

    def reset(self):
        super().reset()
        self.state = self._tile(self.state)

    def set_state(self, state: SurfaceState) -> None:
        """Adopt a whole-sensor [W, H] state (a restored checkpoint):
        padded to the array geometry, and this rank keeps its tile."""
        super().set_state(state)
        self.state = self._tile(self.state)

    def whole_state(self) -> SurfaceState | None:
        """The tiles of every rank gathered on rank 0 at the semantic
        [W, H] geometry (pad cells are never written); None elsewhere."""
        st = self.state
        block = torch.stack([st.t_surf, st.epoch, *(
            getattr(st, f).view(torch.int32) for f in _FIELDS[2:])])
        grid = self.mesh.grid
        if grid.size > 1:
            first = grid.index == 0
            parts = ([torch.empty_like(block) for _ in range(grid.size)]
                     if first else None)
            dist.gather(block, parts, dst=grid.ranks[0], group=grid.group)
            if not first:
                return None
            # rank r holds tile (r % tx, r // tx)
            tx, ty = self.mesh.tx, self.mesh.ty
            block = torch.cat([torch.cat([parts[j * tx + i]
                                          for j in range(ty)], 2)
                               for i in range(tx)], 1)
        whole = SurfaceState(block[0], block[1],
                             *(block[k].view(torch.float32)
                               for k in (2, 3, 4)), st.step)
        return strip_state(whole, self.cfg)

    # ---- processing --------------------------------------------------------
    def device_calls(self, ev: EventBatch, steps_per_call: int | None = None,
                     **kw):
        # only this tile's cells of the center surfaces are uploaded
        rows, cols = tile_slices(self.cfg, self.mesh)
        kw.update(center_rows=rows, center_cols=cols)
        return super().device_calls(ev, steps_per_call, **kw)

    def _run_call(self, chunk: dict):
        """One call's micro-steps on this rank's tile: its wire lanes
        (int32 [spc, C, k], uint8 [spc, k]) on the device, the grid's
        reduce-scatter slice (all lanes where the grid does not divide
        the chunk)."""
        self.state, out = scan_chunk(self.state, chunk, self.cfg, None,
                                     self.shard)
        return out

    def _gather(self, main: torch.Tensor, aux: torch.Tensor):
        """One call's whole wire block on rank 0 (on the device), None
        elsewhere (the lanes are summed over the grid)."""
        return gather_summed(main, aux, self.mesh.grid, self.cfg.chunk_size)

    def process(self, ev: EventBatch,
                steps_per_call: int | None = None) -> FlowOutput | None:
        """Process an event stream (or a continuation of one) on every
        rank. Every rank must be given the same stream; rank 0 returns the
        FlowOutput, the other ranks None."""
        refuse_sparse(self.cfg)
        first = self.mesh.grid.index == 0
        if len(ev) == 0:
            return _empty_output() if first else None
        blocks = [self._gather(*self._run_call(chunk))
                  for chunk in self.device_calls(ev, steps_per_call)]
        return self._unpack_outputs(blocks, ev, len(ev)) if first else None


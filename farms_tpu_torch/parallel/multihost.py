"""Flow engine over a (tx, ev) grid of ranks on one or more hosts.

Counterpart of `farms_tpu.parallel.multihost`. Every rank runs the same
program on the same chronological stream (the replicated feed: the
surface timeline is one strictly ordered state, so the stream cannot be
cut into time segments across hosts). `init_distributed` joins the ranks
of a launcher (`torchrun` and the like); `make_global_mesh` lays them out
as tx bands of sensor rows by ev event shards (parallel/mesh.py), with
one host's ranks in one band group by default, so the halo exchanges stay
on its cards.

- The surfaces are sharded in tx row bands and replicated over ev: rank
  (i, j) keeps band i of every surface, padded to tx (`cfg.padded_to`).
- Every rank uploads the whole 4 B/lane batch and scatters every winner
  (JAX all-gathers the ev-sharded lanes on the device for the scatter;
  the result is the same).
- Rank (i, j) produces the outputs of event shard j's lanes: with tx > 1
  the halo engine's shard step (parallel/halo.py `_step`) on its band
  group, summed over the band by the -0.0 rule; with tx = 1 the
  event-parallel engine's step (parallel/dp.py).
- `process` returns the complete FlowOutput on every rank (one all-gather
  of each call's wire lanes); `write_flow_distributed` writes the output
  file with no output all-gather: each rank decodes its own lanes.

The correction data of a call travel with that call's batch
(`FlowEngine.device_calls`); nothing is queued across calls.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import (OUTPUT_SUFFIX, EventBatch,
                                       FlowOutput, write_flow_txt)
from farms_tpu_torch.ops.kernels import WIRE_COLUMNS
from farms_tpu_torch.parallel import mesh as meshlib
from farms_tpu_torch.parallel.dp import ShardedFlowEngine
from farms_tpu_torch.parallel.halo import (_step, band_of, gather_bands,
                                           gather_lanes)
from farms_tpu_torch.parallel.mesh import (init_distributed,  # noqa: F401
                                           make_global_mesh)
from farms_tpu_torch.pipeline.engine import _decode_batch
from farms_tpu_torch.state.surfaces import SurfaceState


class MultiHostFlowEngine(ShardedFlowEngine):
    """FlowEngine over a global (tx, ev) grid of ranks (`mesh`, default
    make_global_mesh()). Every rank constructs it with the same config and
    calls `process` with the same stream."""

    def __init__(self, cfg: FlowConfig, mesh: meshlib.Mesh | None = None,
                 device="cuda"):
        if not cfg.use_dense:
            raise ValueError(
                "multi-host sharding requires the dense compute path "
                "(use_dense=True): its stencils shard over 'tx'")
        mesh = mesh if mesh is not None else make_global_mesh()
        super().__init__(cfg, device=device, mesh=mesh)
        # non-divisible widths pad up (pad rows are never written)
        self.cfg = cfg.padded_to(mesh.tx)
        self.reset()

    @property
    def _banded(self) -> bool:
        return self.mesh.tx > 1

    def reset(self):
        super().reset()
        if self._banded:
            self.state = band_of(self.state, self.mesh.band, self.cfg)

    def set_state(self, state: SurfaceState) -> None:
        """Adopt a whole-sensor [W, H] state: padded, and this rank's band
        of it where the rows are sharded."""
        super().set_state(state)
        if self._banded:
            self.state = band_of(self.state, self.mesh.band, self.cfg)

    def whole_state(self) -> SurfaceState | None:
        """The state at the semantic geometry on rank 0 (every band group
        gathers its bands to its first rank); None on the other ranks."""
        if not self._banded:
            return super().whole_state()
        state = gather_bands(self.state, self.mesh.band, self.cfg)
        return state if meshlib.rank_and_size()[0] == 0 else None

    # ---- processing --------------------------------------------------------
    def device_calls(self, ev: EventBatch, steps_per_call: int | None = None,
                     **kw):
        if self._banded:
            rows = self.cfg.array_width // self.mesh.tx
            i = self.mesh.i_tx
            # only this band's rows of the center surfaces are uploaded
            kw.update(center_rows=slice(i * rows, (i + 1) * rows))
        return super().device_calls(ev, steps_per_call, **kw)

    def _run_call(self, chunk: dict):
        if not self._banded:
            return super()._run_call(chunk)
        mains, auxs = [], []
        for s in range(chunk["ev"].shape[0]):
            batch = {k: v[s] for k, v in chunk.items()}
            x, y, t, win = _decode_batch(batch, self.cfg)
            corr = "r2c" in batch
            self.state, (main, aux) = _step(
                self.state, x, y, t, win, self.cfg, self.mesh.band,
                cflag=batch["r2f"] != 0 if corr else None,
                t_c2=batch.get("r2c"), lanes=self.lanes)
            mains.append(main)
            auxs.append(aux)
        return torch.stack(mains), torch.stack(auxs)

    def _held(self):
        """(axis, lanes): the ranks whose held lanes lie end to end in
        lane order, and the lane window this rank holds after a step. The
        band's reduce-scatter leaves rank (i, j) slice i of shard j's
        window, which is global slice r = j * tx + i: the whole world in
        rank order. Where tx does not divide the window, every band rank
        holds all of it, and the event axis lies end to end."""
        lo, hi = self.lanes
        tx, i = self.mesh.tx, self.mesh.i_tx
        if self._banded and (hi - lo) % tx == 0:
            k = (hi - lo) // tx
            return meshlib.Axis.world(), (lo + i * k, lo + (i + 1) * k)
        return self.mesh.event, (lo, hi)

    def _collect(self, main, aux):
        """One call's whole wire block on every rank."""
        return gather_lanes(main, aux, self._held()[0], to_all=True)

    def _returns_output(self) -> bool:
        return True

    # ---- rank-distributed output writing --------------------------------
    def write_flow_distributed(self, ev: EventBatch, base_path: str) -> str:
        """The batch-mode output file without the output all-gather (JAX:
        farms_tpu/parallel/multihost.py:240).

        Every rank processes the stream, decodes only the lanes it holds
        after each step (`_held`) to the 7 wire columns (as process()
        decodes: on the card on a CUDA engine) and stages them
        to `<base_path>.part<rank>.npz` on the shared file system; after
        a barrier, rank 0 assembles the parts in lane order, writes the
        reference's 11-column text (vFlow.cpp:433-442) and removes the
        parts. Only the barriers cross ranks. Every rank returns the
        text's path.
        """
        cfg = self.cfg
        n = len(ev)
        m = cfg.chunk_size
        lo, hi = self._held()[1]
        rows_l, cols_l = [], []
        step0 = 0
        for chunk in (self.device_calls(ev) if n else ()):
            main, aux = self._run_call(chunk)
            spc = main.shape[0]
            g = ((step0 + np.arange(spc))[:, None] * m
                 + np.arange(lo, hi)[None, :]).reshape(-1)
            step0 += spc
            keep = g < n
            # g rises along the wire: the kept lanes are its first
            cols, dev_cols = self._column_blocks(int(keep.sum()))
            self._decode_call(main, aux, dev_cols, cols, 0)
            rows_l.append(g[keep])
            cols_l.append(cols)
        rank, world = meshlib.rank_and_size()
        payload = {"rows": (np.concatenate(rows_l) if rows_l
                            else np.zeros(0, np.int64))}
        for key in WIRE_COLUMNS:
            # decode_wire_columns' dtypes where this rank holds no lane
            payload[key] = (np.concatenate([c[key] for c in cols_l])
                            if cols_l else np.zeros(0, np.int32 if key ==
                                                    "scale" else np.float32))
        np.savez(f"{base_path}.part{rank}.npz", **payload)
        meshlib.barrier()
        path = base_path + OUTPUT_SUFFIX
        if rank == 0:
            full = {k: np.zeros(n, payload[k].dtype) for k in WIRE_COLUMNS}
            covered = np.zeros(n, bool)
            for p in range(world):
                with np.load(f"{base_path}.part{p}.npz") as part:
                    r = part["rows"]
                    for k in full:
                        full[k][r] = part[k]
                    covered[r] = True
            if not covered.all():
                raise RuntimeError(f"the staged parts leave "
                                   f"{int((~covered).sum())} lanes uncovered")
            t0 = self._t0 if self._t0 is not None else np.uint32(0)
            out = FlowOutput(x=ev.x.astype(np.int32), y=ev.y.astype(np.int32),
                             t=(ev.t.astype(np.uint32) - t0).astype(np.uint32),
                             pol=ev.pol.astype(np.int32), **full)
            path = write_flow_txt(out, base_path)
            for p in range(world):
                os.remove(f"{base_path}.part{p}.npz")
        meshlib.barrier()
        return path

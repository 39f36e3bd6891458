"""Event-data-parallel flow engine over torch.distributed ranks.

Counterpart of `farms_tpu.parallel.dp`: surfaces are replicated and each
micro-batch's lanes are split over the ranks of an `ev` axis. JAX's GSPMD
lowering computes every dense map on every device; so does this engine:
every rank uploads the whole batch and runs the single engine's
`micro_step` on it, so every rank makes the same scatters (the
host-resolved unique winners) and keeps the same surfaces. What it splits
is the per-lane work after the maps: rank r gathers, wire-packs and
downloads only its lane shard [r m / N, (r + 1) m / N) of each
micro-step, and rank 0 collects the shards (`gather`) and returns the
FlowOutput; the other ranks return None, as in the halo engine.
"""
from __future__ import annotations

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import EventBatch, FlowOutput
from farms_tpu_torch.parallel import mesh as meshlib
from farms_tpu_torch.parallel.halo import gather_lanes
from farms_tpu_torch.pipeline.engine import (FlowEngine, _empty_output,
                                             refuse_sparse, scan_chunk)
from farms_tpu_torch.state.surfaces import SurfaceState


class ShardedFlowEngine(FlowEngine):
    """FlowEngine whose micro-batches' lanes are split over the ranks of
    an event axis (`mesh`, default: every rank of this process's group,
    `num_devices` of them where given). Construct it in every rank, or in
    a process without a group for one rank."""

    def __init__(self, cfg: FlowConfig, num_devices: int | None = None,
                 device="cuda", mesh: meshlib.Mesh | None = None):
        self.mesh = (mesh if mesh is not None
                     else meshlib.make_event_mesh(num_devices))
        ev = self.mesh.ev
        if cfg.chunk_size % ev:
            raise ValueError(
                f"chunk_size {cfg.chunk_size} not divisible by mesh size "
                f"{ev}")
        super().__init__(cfg, device)

    @property
    def lanes(self) -> tuple[int, int]:
        """This rank's lane window of every micro-step: its event shard."""
        m, ev, j = self.cfg.chunk_size, self.mesh.ev, self.mesh.j_ev
        return j * m // ev, (j + 1) * m // ev

    def whole_state(self) -> SurfaceState | None:
        """The replicated state at the semantic geometry on rank 0, as a
        checkpoint stores it; None on the other ranks."""
        return (super().whole_state() if meshlib.rank_and_size()[0] == 0
                else None)

    # ---- processing --------------------------------------------------------
    def process(self, ev: EventBatch,
                steps_per_call: int | None = None) -> FlowOutput | None:
        """Process an event stream (or a continuation of one) on every rank.

        Every rank must be given the same stream. Returns the FlowOutput
        where `_collect` leaves the whole output (rank 0 here), else None.
        """
        refuse_sparse(self.cfg)
        returns = self._returns_output()
        if len(ev) == 0:
            return _empty_output() if returns else None
        blocks = [self._collect(*self._run_call(chunk))
                  for chunk in self.device_calls(ev, steps_per_call)]
        return self._unpack_outputs(blocks, ev, len(ev)) if returns else None

    def _run_call(self, chunk: dict):
        """One call's micro-steps; returns this rank's wire lanes."""
        self.state, out = scan_chunk(self.state, chunk, self.cfg, self.lanes)
        return out

    def _collect(self, main, aux):
        """One call's wire block of every shard on rank 0, None
        elsewhere."""
        return gather_lanes(main, aux, self.mesh.event)

    def _returns_output(self) -> bool:
        return self.mesh.j_ev == 0

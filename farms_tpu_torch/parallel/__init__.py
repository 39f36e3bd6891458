"""Multi-device engines on torch.distributed (counterpart of
`farms_tpu.parallel`).

- `dp.ShardedFlowEngine`: event-data parallelism, surfaces replicated,
  each micro-batch's lanes split over an `ev` axis of ranks.
- `halo.HaloFlowEngine`: row bands of every surface, ring band exchanges,
  the lanes summed over the ranks.
- `multihost.MultiHostFlowEngine`: both at once over a (tx, ev) grid of
  ranks on one or more hosts.
- `tiling.SpatialFlowEngine`: (tx, ty) tiles of every surface, explicit
  halos in both axes (JAX's spatial engine, which GSPMD partitions).

`mesh` starts or joins the ranks and lays them out.
"""
from farms_tpu_torch.parallel.dp import ShardedFlowEngine
from farms_tpu_torch.parallel.halo import HaloFlowEngine
from farms_tpu_torch.parallel.multihost import MultiHostFlowEngine
from farms_tpu_torch.parallel.tiling import SpatialFlowEngine

__all__ = ["ShardedFlowEngine", "HaloFlowEngine", "MultiHostFlowEngine",
           "SpatialFlowEngine"]

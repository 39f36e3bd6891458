"""Multi-device engines on torch.distributed (counterpart of
`farms_tpu.parallel`; spatial tiling by GSPMD has no torch counterpart and
is not ported, the halo engine shards rows explicitly instead).

- `dp.ShardedFlowEngine`: event-data parallelism, surfaces replicated,
  each micro-batch's lanes split over an `ev` axis of ranks.
- `halo.HaloFlowEngine`: row bands of every surface, ring band exchanges,
  the lanes summed over the ranks.
- `multihost.MultiHostFlowEngine`: both at once over a (tx, ev) grid of
  ranks on one or more hosts.

`mesh` starts or joins the ranks and lays them out.
"""
from farms_tpu_torch.parallel.dp import ShardedFlowEngine
from farms_tpu_torch.parallel.halo import HaloFlowEngine
from farms_tpu_torch.parallel.multihost import MultiHostFlowEngine

__all__ = ["ShardedFlowEngine", "HaloFlowEngine", "MultiHostFlowEngine"]

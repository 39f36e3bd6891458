"""FARMS on PyTorch and CUDA: aperture-robust multi-scale event-camera
optical flow, with hand-written CUDA kernels for an NVIDIA Hopper GPU.

The PyTorch counterpart of `farms_tpu` (the JAX reference, which this
package never imports). Method: Akolkar, Ieng & Benosman, IEEE TPAMI 2020,
doi:10.1109/TPAMI.2020.3010468.
"""
from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import (
    EventBatch,
    FlowOutput,
    load_events_txt,
    read_flow_txt,
    write_flow_txt,
)
from farms_tpu_torch.pipeline.engine import FlowEngine

__all__ = [
    "FlowConfig",
    "EventBatch",
    "FlowOutput",
    "FlowEngine",
    "load_events_txt",
    "read_flow_txt",
    "write_flow_txt",
]
__version__ = "0.1.0"

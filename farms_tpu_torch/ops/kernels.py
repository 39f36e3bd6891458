"""Wrappers of the hand-written CUDA kernels for the dense path's two stages.

Counterpart of `farms_tpu.ops.pallas.kernels`. The device of the input
decides the path: a CPU tensor runs the plain PyTorch version
(ops/dense_flow.py), a CUDA tensor launches the kernel
(csrc/local_flow.cu, csrc/aperture.cu) or raises. There is no fallback
between the two.

Each wrapper counts its kernel launches in `LAUNCHES` (only where it
launches; plain-path calls do not count), so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.ops import _build
from farms_tpu_torch.ops.dense_flow import (aperture_y_clip, build_integral,
                                            dense_aperture, local_flow_core)

LAUNCHES = {"local_flow": 0, "aperture": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")


def local_flow(chain: torch.Tensor, center: torch.Tensor, cfg: FlowConfig):
    """Local plane fit; contract of dense_flow.local_flow_core.

    chain int32 [S, W, H], center int32 [W, H] (stamp1). Returns accept
    i32, a f32, b f32, dtdp f32, cand i32, each [W, H].
    """
    if center.device.type == "cpu":
        return local_flow_core(chain, center, cfg)
    if center.device.type != "cuda":
        raise ValueError(f"no local-flow kernel for device {center.device}")
    if cfg.filter_size not in (3, 5):
        raise NotImplementedError(
            f"local-flow kernel has k = 3 and 5 instances, not "
            f"{cfg.filter_size} (ROADMAP Queue 2 item 2)")
    W, H = cfg.width, cfg.height
    dev = center.device
    _check(center, "center", torch.int32, (W, H), dev)
    if chain.dim() != 3 or chain.shape[0] < 1:
        raise ValueError(f"chain must be [S >= 1, W, H], got {tuple(chain.shape)}")
    _check(chain, "chain", torch.int32, (chain.shape[0], W, H), dev)
    lib = _build.load()
    accept = torch.empty((W, H), dtype=torch.int32, device=dev)
    a = torch.empty((W, H), dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    dtdp = torch.empty_like(a)
    cand = torch.empty_like(accept)
    rc = lib.farms_local_flow(
        chain.data_ptr(), chain.shape[0], center.data_ptr(), W, H,
        cfg.filter_size, cfg.min_evts_on_plane, cfg.det_threshold,
        -cfg.ts_to_sec, accept.data_ptr(), a.data_ptr(), b.data_ptr(),
        dtdp.data_ptr(), cand.data_ptr(), _stream(dev))
    _raise_on(rc, "local-flow")
    LAUNCHES["local_flow"] += 1
    return accept, a, b, dtdp, cand


def aperture(flow_len: torch.Tensor, flow_vx: torch.Tensor,
             flow_vy: torch.Tensor, cfg: FlowConfig):
    """Multi-scale aperture pooling; contract of dense_flow.dense_aperture.

    f32 [W, H] flow surfaces in; (true_vx f32, true_vy f32, scale i32) out.
    The integral image is built with the plain version's torch ops, then
    the kernel pools every scale.
    """
    if flow_len.device.type == "cpu":
        return dense_aperture(flow_len, flow_vx, flow_vy, cfg)
    if flow_len.device.type != "cuda":
        raise ValueError(f"no aperture kernel for device {flow_len.device}")
    W, H = cfg.width, cfg.height
    dev = flow_len.device
    for name, t in (("flow_len", flow_len), ("flow_vx", flow_vx),
                    ("flow_vy", flow_vy)):
        _check(t, name, torch.float32, (W, H), dev)
    integ = build_integral(flow_len, flow_vx, flow_vy)
    _check(integ, "integral", torch.float64, (4, W + 1, H + 1), dev)
    lib = _build.load()
    tvx = torch.empty((W, H), dtype=torch.float32, device=dev)
    tvy = torch.empty_like(tvx)
    scale = torch.empty((W, H), dtype=torch.int32, device=dev)
    rc = lib.farms_aperture(
        integ.data_ptr(), W, H, aperture_y_clip(cfg), cfg.num_scales,
        cfg.window_jump, flow_vx.data_ptr(), flow_vy.data_ptr(),
        tvx.data_ptr(), tvy.data_ptr(), scale.data_ptr(), _stream(dev))
    _raise_on(rc, "aperture")
    LAUNCHES["aperture"] += 1
    return tvx, tvy, scale

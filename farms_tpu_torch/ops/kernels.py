"""Wrappers of the hand-written CUDA kernels for the dense path's two stages.

Counterpart of `farms_tpu.ops.pallas.kernels`. The device of the input
decides the path: a CPU tensor runs the plain PyTorch version
(ops/dense_flow.py), a CUDA tensor launches the kernel
(csrc/local_flow.cu: its streamed k = 3 and 5 instances, or the general
kernel for any other odd k, each for any chain length; csrc/aperture.cu:
the float64 integral and the pool) or raises. There is no fallback
between the two.

Each wrapper counts its kernel launches in `LAUNCHES` (only where it
launches; plain-path calls do not count), so a run can show that its main
path went through the kernels; a kernel's halo-mode launches (the row
shards of parallel/halo.py) count under the same name.
"""
from __future__ import annotations

import ctypes

import torch

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.ops import _build
from farms_tpu_torch.ops.dense_flow import (aperture_y_clip, build_integral,
                                            dense_aperture, local_flow_core)

LAUNCHES = {"local_flow": 0, "local_flow_general": 0, "aperture": 0,
            "integral": 0}


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


def local_flow_shape(filter_size: int) -> dict:
    """How the local-flow kernel runs at this filter size, as
    csrc/local_flow.cu decides it (farms_local_flow_shape): `tile_rows`
    (a block is 32 x tile_rows threads), `slab_rows`, the general kernel's
    support rows per pass over the chain (0 for the streamed k = 3 and 5
    kernels), and `shared_bytes` of one block. None depends on the chain.
    Builds the kernel library on first use (needs nvcc, not a card)."""
    out = [ctypes.c_int() for _ in range(3)]
    rc = _build.load().farms_local_flow_shape(
        filter_size, *(ctypes.byref(o) for o in out))
    if rc != 0:
        raise ValueError(f"no local-flow kernel for filter size "
                         f"{filter_size}: cudaError_t {rc}")
    return dict(zip(("tile_rows", "slab_rows", "shared_bytes"),
                    (o.value for o in out)))


def aperture_shape(rows: int, Ha: int, jump: int) -> dict:
    """How the pool kernel runs on rows x Ha pixels at this window jump,
    as csrc/aperture.cu decides it on the current card
    (farms_aperture_shape): its tile, `tile_rows` x `tile_cols` pixels
    (two a thread; the rows chosen so that the grid fits the card's SMs),
    each corner kind's slab of `slab_rows` x `slab_cols` (count, length)
    slots, the strip each scale after the first copies (`strip_rows`
    whole rows, `strip_cols` columns of the others; the whole tile where
    no cell carries over), and `shared_bytes` of one block. Needs a CUDA
    device."""
    out = [ctypes.c_int() for _ in range(7)]
    rc = _build.load().farms_aperture_shape(
        rows, Ha, jump, *(ctypes.byref(o) for o in out))
    if rc != 0:
        raise ValueError(f"no pool kernel for {rows} x {Ha} at window jump "
                         f"{jump}: cudaError_t {rc}")
    return dict(zip(("tile_rows", "tile_cols", "slab_rows", "slab_cols",
                     "strip_rows", "strip_cols", "shared_bytes"),
                    (o.value for o in out)))


def _band_rows(t: torch.Tensor, name: str, cfg: FlowConfig, halo: int,
               row_offset: int) -> int:
    """Core rows of a [rows + 2*halo, Ha] band (or of the [array W, Ha]
    surface without halo), checked against the config's array geometry."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    if not halo:
        expect = (cfg.array_width, cfg.array_height)
    else:
        rows = t.shape[0] - 2 * halo
        if rows < 1 or row_offset < 0 or row_offset + rows > cfg.array_width:
            raise ValueError(f"{name}: band of {t.shape[0]} rows with halo "
                             f"{halo} at row {row_offset} does not fit the "
                             f"array width {cfg.array_width}")
        expect = (t.shape[0], cfg.array_height)
    if tuple(t.shape) != expect:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{expect}")
    return t.shape[0] - 2 * halo


def local_flow(chain: torch.Tensor, center: torch.Tensor, cfg: FlowConfig,
               fold_center: bool = True, halo: int = 0, row_offset: int = 0):
    """Local plane fit; contract of dense_flow.local_flow_core.

    chain int32 [S, W, H], center int32 [W, H] (stamp1), at the array
    geometry [array_width, array_height] of a padded config (its pad
    cells never written); fold_center=False is the correction mode. Halo mode (halo >= R, parallel/halo.py): chain
    [S, rows + 2*halo, Ha] and center [rows + 2*halo, Ha] bands of a row
    shard whose first global row is row_offset. Returns accept i32, a f32,
    b f32, dtdp f32, cand i32, each shaped as center's core rows.
    """
    if center.device.type == "cpu":
        return local_flow_core(chain, center, cfg, fold_center, halo,
                               row_offset)
    if center.device.type != "cuda":
        raise ValueError(f"no local-flow kernel for device {center.device}")
    R = cfg.support_radius
    if halo and halo < R:
        raise ValueError(f"halo {halo} < support_radius {R}")
    dev = center.device
    rows = _band_rows(center, "center", cfg, halo, row_offset)
    Xb, Ha = center.shape
    _check(center, "center", torch.int32, (Xb, Ha), dev)
    if chain.dim() != 3 or chain.shape[0] < 1:
        raise ValueError(f"chain must be [S >= 1, {Xb}, {Ha}], got "
                         f"{tuple(chain.shape)}")
    _check(chain, "chain", torch.int32, (chain.shape[0], Xb, Ha), dev)
    S = chain.shape[0]
    k = cfg.filter_size
    lib = _build.load()
    accept = torch.empty((rows, Ha), dtype=torch.int32, device=dev)
    a = torch.empty((rows, Ha), dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    dtdp = torch.empty_like(a)
    cand = torch.empty_like(accept)
    rc = lib.farms_local_flow(
        chain.data_ptr(), S, int(fold_center), center.data_ptr(), Xb, rows,
        halo, row_offset, cfg.width, cfg.height, Ha, k,
        cfg.min_evts_on_plane, cfg.det_threshold, -cfg.ts_to_sec,
        accept.data_ptr(), a.data_ptr(), b.data_ptr(), dtdp.data_ptr(),
        cand.data_ptr(), _stream(dev))
    name = "local_flow" if k in (3, 5) else "local_flow_general"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return accept, a, b, dtdp, cand


def integral(flow_len: torch.Tensor, flow_vx: torch.Tensor,
             flow_vy: torch.Tensor) -> torch.Tensor:
    """The float64 integral image of f32 [rows, cols] flow surfaces: the
    contract, summation order included, of dense_flow.build_integral,
    [4, rows + 1, cols + 1]. Counted under "integral", one per call (its
    two launches)."""
    if flow_len.device.type == "cpu":
        return build_integral(flow_len, flow_vx, flow_vy)
    if flow_len.device.type != "cuda":
        raise ValueError(f"no integral kernel for device {flow_len.device}")
    if flow_len.dim() != 2:
        raise ValueError(f"flow_len must be 2-D, got {tuple(flow_len.shape)}")
    dev = flow_len.device
    rows, cols = flow_len.shape
    for name, t in (("flow_len", flow_len), ("flow_vx", flow_vx),
                    ("flow_vy", flow_vy)):
        _check(t, name, torch.float32, (rows, cols), dev)
    integ = torch.empty((4, rows + 1, cols + 1), dtype=torch.float64,
                        device=dev)
    rc = _build.load().farms_integral(
        flow_len.data_ptr(), flow_vx.data_ptr(), flow_vy.data_ptr(), rows,
        cols, integ.data_ptr(), _stream(dev))
    _raise_on(rc, "integral")
    LAUNCHES["integral"] += 1
    return integ


def aperture(flow_len: torch.Tensor, flow_vx: torch.Tensor,
             flow_vy: torch.Tensor, cfg: FlowConfig, halo: int = 0,
             integ=None):
    """Multi-scale aperture pooling; contract of dense_flow.dense_aperture.

    f32 [W, H] flow surfaces (the array geometry of a padded config) in;
    (true_vx f32, true_vy f32, scale i32) out.
    The integral kernel builds the float64 integral image (`integral`),
    then the pool kernel scans every scale on the count and length fields
    from shared-memory slabs and reads vx and vy at the winning scale.
    Band mode (parallel/halo.py): `integ` is the float64 integral band
    [4, rows + 2*halo + 1, Ha + 1] of a row shard, halo >= max_window + 1,
    and the flow surfaces and outputs are the shard's core rows [rows, Ha].
    """
    if (integ is None) != (halo == 0):
        raise ValueError("an integral band comes with its halo, and a halo "
                         "with its band")
    if flow_len.device.type == "cpu":
        return dense_aperture(flow_len, flow_vx, flow_vy, cfg, halo=halo,
                              integ=integ)
    if flow_len.device.type != "cuda":
        raise ValueError(f"no aperture kernel for device {flow_len.device}")
    if halo and halo < cfg.max_window + 1:
        raise ValueError(f"halo {halo} < max_window + 1 "
                         f"{cfg.max_window + 1}")
    dev = flow_len.device
    shape = ((cfg.array_width, cfg.array_height) if integ is None
             else flow_len.shape)
    if integ is not None and (flow_len.dim() != 2
                              or shape[1] != cfg.array_height):
        raise ValueError(f"flow_len has shape {tuple(shape)}, expected "
                         f"[rows, {cfg.array_height}]")
    for name, t in (("flow_len", flow_len), ("flow_vx", flow_vx),
                    ("flow_vy", flow_vy)):
        _check(t, name, torch.float32, shape, dev)
    rows, Ha = shape
    if integ is None:
        integ = integral(flow_len, flow_vx, flow_vy)
    _check(integ, "integral", torch.float64, (4, rows + 2 * halo + 1, Ha + 1),
           dev)
    lib = _build.load()
    tvx = torch.empty((rows, Ha), dtype=torch.float32, device=dev)
    tvy = torch.empty_like(tvx)
    scale = torch.empty((rows, Ha), dtype=torch.int32, device=dev)
    rc = lib.farms_aperture(
        integ.data_ptr(), integ.shape[1], rows, halo, Ha,
        aperture_y_clip(cfg), cfg.num_scales, cfg.window_jump,
        flow_vx.data_ptr(), flow_vy.data_ptr(), tvx.data_ptr(),
        tvy.data_ptr(), scale.data_ptr(), _stream(dev))
    _raise_on(rc, "aperture")
    LAUNCHES["aperture"] += 1
    return tvx, tvy, scale

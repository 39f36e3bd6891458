"""Wrappers of the hand-written CUDA kernels: the dense path's two stages
and the wire decode.

Counterpart of `farms_tpu.ops.pallas.kernels`. The device of the input
decides the path: a CPU tensor runs the plain PyTorch version
(ops/dense_flow.py), a CUDA tensor launches the kernel
(csrc/local_flow.cu: its streamed k = 3 and 5 instances, or the general
kernel for any other odd k, each for any chain length; csrc/aperture.cu:
the float64 integral and the pool; csrc/wire.cu: the wire decoded into
the output columns) or raises. There is no fallback between the two.

Each wrapper counts its kernel launches in `LAUNCHES` (only where it
launches; plain-path calls do not count), so a run can show that its main
path went through the kernels; a kernel's halo-mode launches (the row
shards of parallel/halo.py) and tile-mode launches (the 2-D tiles of
parallel/tiling.py) count under the same name. While a torch profiler
records, local_flow's card path is also the span kernels.local_flow
(utils/tracing.py), its general launches the counter
kernels.local_flow_general_launches and its correction-mode launches
(fold_center=False) the counter kernels.local_flow_correction_launches;
`COUNTERS` keeps both counts without a profiler too. A call captured into
a CUDA graph (pipeline/engine.py's resident call) launches nothing at
capture: its engine takes the capture's counts back and adds them at
every replay.
`device_launches` counts the same names among the kernels a profiler saw
run on the card, a graph replay's included.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd import DeviceType

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.ops import _build
from farms_tpu_torch.ops.dense_flow import (aperture_y_clip, build_integral,
                                            decode_wire_columns,
                                            dense_aperture, local_flow_core)
from farms_tpu_torch.utils import tracing

# the rows of decode_wire's column block, in order
WIRE_COLUMNS = ("r_true", "theta_true", "vx", "vy", "r_local", "theta_local",
                "scale")

LAUNCHES = {"local_flow": 0, "local_flow_general": 0, "aperture": 0,
            "integral": 0, "decode_wire": 0}
# each LAUNCHES entry's CUDA kernel (csrc/), a part of its device name
DEVICE_KERNELS = {"local_flow": "local_flow_streamed",
                  "local_flow_general": "local_flow_general",
                  "aperture": "aperture_kernel", "integral": "integral_kernel",
                  "decode_wire": "decode_wire_"}
# the tracing counters of local_flow's card path, counted here whether or
# not a profiler records, so that a CUDA graph's capture can take back
# what it counted
COUNTERS = {"kernels.local_flow_general_launches": 0,
            "kernels.local_flow_correction_launches": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, COUNTERS):
        for k in counts:
            counts[k] = 0


def device_launches(events) -> dict:
    """LAUNCHES' counts as the card ran them: the device kernels among a
    torch profiler's events (`prof.events()`), by DEVICE_KERNELS."""
    counts = dict.fromkeys(LAUNCHES, 0)
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            for key, name in DEVICE_KERNELS.items():
                counts[key] += name in e.name
    return counts


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
    """How the pool kernel runs on rows x Ha pixels (Ha: a tile's core
    columns in tile mode) at this window jump,
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


def _band_extent(t: torch.Tensor, name: str, cfg: FlowConfig, halo: int,
                 row_offset: int, col_halo: int = 0,
                 col_offset: int = 0) -> tuple[int, int]:
    """Core (rows, cols) of a [rows + 2*halo, cols + 2*col_halo] band,
    each axis checked against the config's array geometry: an axis
    without a halo is the whole array extent, one with a halo a core that
    fits the array at its offset."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    core = []
    for n, h, off, extent, axis in (
            (t.shape[0], halo, row_offset, cfg.array_width, "rows"),
            (t.shape[1], col_halo, col_offset, cfg.array_height, "columns")):
        if not h:
            if n != extent:
                raise ValueError(f"{name} has {n} {axis}, expected {extent} "
                                 f"(the array geometry, no halo)")
        elif n - 2 * h < 1 or off < 0 or off + n - 2 * h > extent:
            raise ValueError(f"{name}: band of {n} {axis} with halo {h} at "
                             f"{off} does not fit the array's {extent}")
        core.append(n - 2 * h)
    return core[0], core[1]


def local_flow(chain: torch.Tensor, center: torch.Tensor, cfg: FlowConfig,
               fold_center: bool = True, halo: int = 0, row_offset: int = 0,
               col_halo: int = 0, col_offset: int = 0):
    """Local plane fit; contract of dense_flow.local_flow_core.

    chain int32 [S, W, H], center int32 [W, H] (stamp1), at the array
    geometry [array_width, array_height] of a padded config (its pad
    cells never written); fold_center=False is the correction mode. Halo
    mode (halo >= R, parallel/halo.py): chain [S, rows + 2*halo, Ha] and
    center [rows + 2*halo, Ha] bands of a row shard whose first global row
    is row_offset. Tile mode (col_halo >= R as well, parallel/tiling.py):
    the bands also carry col_halo columns on each side of the tile's cols
    core columns, whose first global column is col_offset. Returns accept
    i32, a f32, b f32, dtdp f32, cand i32, each shaped as center's core
    cells.
    """
    if center.device.type == "cpu":
        return local_flow_core(chain, center, cfg, fold_center, halo,
                               row_offset, col_halo, col_offset)
    if center.device.type != "cuda":
        raise ValueError(f"no local-flow kernel for device {center.device}")
    return _launch_local_flow(chain, center, cfg, fold_center, halo,
                              row_offset, col_halo, col_offset)


def _launch_local_flow(chain, center, cfg, fold_center, halo, row_offset,
                       col_halo, col_offset):
    """local_flow's card path (the checks, the outputs' allocations and
    the launch): the span kernels.local_flow; counted under "local_flow"
    (k = 3, 5) or "local_flow_general", a general launch also under the
    counter kernels.local_flow_general_launches and a correction-mode
    launch (fold_center False) under kernels.local_flow_correction_launches
    (in COUNTERS, and in utils/tracing while a profiler records)."""
    with tracing.span("kernels.local_flow"):
        R = cfg.support_radius
        for h in (halo, col_halo):
            if h and h < R:
                raise ValueError(f"halo {h} < support_radius {R}")
        dev = center.device
        rows, cols = _band_extent(center, "center", cfg, halo, row_offset,
                                  col_halo, col_offset)
        Xb, Yb = center.shape
        _check(center, "center", torch.int32, (Xb, Yb), dev)
        if chain.dim() != 3 or chain.shape[0] < 1:
            raise ValueError(f"chain must be [S >= 1, {Xb}, {Yb}], got "
                             f"{tuple(chain.shape)}")
        _check(chain, "chain", torch.int32, (chain.shape[0], Xb, Yb), dev)
        S = chain.shape[0]
        k = cfg.filter_size
        lib = _build.load()
        accept = torch.empty((rows, cols), dtype=torch.int32, device=dev)
        a = torch.empty((rows, cols), dtype=torch.float32, device=dev)
        b = torch.empty_like(a)
        dtdp = torch.empty_like(a)
        cand = torch.empty_like(accept)
        rc = lib.farms_local_flow(
            chain.data_ptr(), S, int(fold_center), center.data_ptr(), Xb, rows,
            halo, row_offset, Yb, cols, col_halo, col_offset, cfg.width,
            cfg.height, k, cfg.min_evts_on_plane, cfg.det_threshold,
            -cfg.ts_to_sec, accept.data_ptr(), a.data_ptr(), b.data_ptr(),
            dtdp.data_ptr(), cand.data_ptr(), _stream(dev))
        name = "local_flow" if k in (3, 5) else "local_flow_general"
        _raise_on(rc, name)
        LAUNCHES[name] += 1
        for counter, launched in (
                ("kernels.local_flow_general_launches",
                 name == "local_flow_general"),
                ("kernels.local_flow_correction_launches", not fold_center)):
            if launched:
                COUNTERS[counter] += 1
                tracing.count(counter)
    return accept, a, b, dtdp, cand


def integral(flow_len: torch.Tensor, flow_vx: torch.Tensor,
             flow_vy: torch.Tensor) -> torch.Tensor:
    """The float64 integral image of f32 [rows, cols] flow surfaces: the
    contract, summation order included, of dense_flow.build_integral,
    [4, rows + 1, cols + 1]. Counted under "integral", one per call (its
    one launch)."""
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
             integ=None, col_halo: int = 0):
    """Multi-scale aperture pooling; contract of dense_flow.dense_aperture.

    f32 [W, H] flow surfaces (the array geometry of a padded config) in;
    (true_vx f32, true_vy f32, scale i32) out.
    The integral kernel builds the float64 integral image (`integral`),
    then the pool kernel scans every scale on the count and length fields
    from shared-memory slabs and reads vx and vy at the winning scale.
    Band mode (parallel/halo.py): `integ` is the float64 integral band
    [4, rows + 2*halo + 1, Ha + 1] of a row shard, halo >= max_window + 1,
    and the flow surfaces and outputs are the shard's core rows [rows, Ha].
    Tile mode (parallel/tiling.py): col_halo >= max_window + 1 as well,
    `integ` the tile's band [4, rows + 2*halo + 1, cols + 2*col_halo + 1]
    pre-clamped in y (dense_flow.tile_band), the flow surfaces and outputs
    the tile's core cells [rows, cols].
    """
    if (integ is None) != (halo == 0) or (col_halo and integ is None):
        raise ValueError("an integral band comes with its halo, and a halo "
                         "with its band")
    if flow_len.device.type == "cpu":
        return dense_aperture(flow_len, flow_vx, flow_vy, cfg, halo=halo,
                              integ=integ, col_halo=col_halo)
    if flow_len.device.type != "cuda":
        raise ValueError(f"no aperture kernel for device {flow_len.device}")
    A = cfg.max_window + 1
    if (halo and halo < A) or (col_halo and col_halo < A):
        raise ValueError(f"halo {halo} or col_halo {col_halo} < "
                         f"max_window + 1 {A}")
    dev = flow_len.device
    if integ is None:
        shape = (cfg.array_width, cfg.array_height)
    else:
        if flow_len.dim() != 2 or (
                not col_halo and flow_len.shape[1] != cfg.array_height):
            raise ValueError(f"flow_len has shape {tuple(flow_len.shape)}, "
                             f"expected [rows, {cfg.array_height}]")
        shape = tuple(flow_len.shape)
    for name, t in (("flow_len", flow_len), ("flow_vx", flow_vx),
                    ("flow_vy", flow_vy)):
        _check(t, name, torch.float32, shape, dev)
    rows, cols = shape
    if integ is None:
        integ = integral(flow_len, flow_vx, flow_vy)
    integ_cols = cols + 2 * col_halo + 1
    _check(integ, "integral", torch.float64,
           (4, rows + 2 * halo + 1, integ_cols), dev)
    # a tile's band is pre-clamped in y: its clamp is the band's extent
    y_clip = integ_cols - 1 if col_halo else aperture_y_clip(cfg)
    lib = _build.load()
    tvx = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    tvy = torch.empty_like(tvx)
    scale = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    rc = lib.farms_aperture(
        integ.data_ptr(), integ.shape[1], rows, halo, cols, col_halo,
        y_clip, cfg.num_scales, cfg.window_jump, flow_vx.data_ptr(),
        flow_vy.data_ptr(), tvx.data_ptr(), tvy.data_ptr(), scale.data_ptr(),
        _stream(dev))
    _raise_on(rc, "aperture")
    LAUNCHES["aperture"] += 1
    return tvx, tvy, scale


def decode_wire(main: torch.Tensor, aux: torch.Tensor, out: torch.Tensor,
                offset: int, count: int, window_jump: int) -> torch.Tensor:
    """The seven output columns of a call's wire lanes 0 .. count - 1 into
    columns offset .. offset + count - 1 of `out`, float32 [7, n]: rows
    r_true, theta_true, vx, vy, r_local, theta_local, and scale as int32
    bits. `main` int32 [steps, C, k] (C = 2, the f16 wire's pairs, or 4,
    the f32 wire's words), `aux` uint8 [steps, k]; lane s * k + l is step
    s's lane l. A CPU tensor runs the plain version, decode_wire_columns
    (NumPy); a CUDA tensor launches the kernel, whose theta is atan2f's
    (within its ulp bound) and whose other columns are bit for bit
    NumPy's. Counted under "decode_wire", one per launch (none for count
    0). Returns `out`."""
    if main.dim() != 3 or main.shape[1] not in (2, 4):
        raise ValueError(f"main must be [steps, 2 or 4, lanes], got "
                         f"{tuple(main.shape)}")
    if out.dim() != 2 or out.shape[0] != 7:
        raise ValueError(f"out must be [7, n], got {tuple(out.shape)}")
    steps, C, k = main.shape
    dev = main.device
    _check(main, "main", torch.int32, (steps, C, k), dev)
    _check(aux, "aux", torch.uint8, (steps, k), dev)
    _check(out, "out", torch.float32, tuple(out.shape), dev)
    if not (0 <= count <= steps * k and 0 <= offset
            and offset + count <= out.shape[1]):
        raise ValueError(f"{count} lanes at column {offset} do not fit a "
                         f"wire of {steps * k} lanes or out's "
                         f"{out.shape[1]} columns")
    if dev.type == "cpu":
        cols = decode_wire_columns(
            main.numpy().transpose(1, 0, 2).reshape(C, -1)[:, :count],
            aux.numpy().reshape(-1)[:count],
            FlowConfig(wire="f32" if C == 4 else "f16",
                       window_jump=window_jump))
        host = out.numpy()[:, offset:offset + count]
        for r, name in enumerate(WIRE_COLUMNS):
            host[r] = cols[name].view(np.float32)
        return out
    if dev.type != "cuda":
        raise ValueError(f"no decode_wire kernel for device {dev}")
    if count:
        rc = _build.load().farms_decode_wire(
            main.data_ptr(), aux.data_ptr(), C, k, count, window_jump,
            out.data_ptr(), out.shape[1], offset, _stream(dev))
        _raise_on(rc, "decode_wire")
        LAUNCHES["decode_wire"] += 1
    return out

"""Configuration of the PyTorch flow engine.

Mirrors `farms_tpu.config.FlowConfig` field for field (every tunable of the
reference implementation, including its compiled-in constants: vFlow.cpp:73-74
windowJump/maxWindow, vFlow.cpp:961 KILL_OLD_FLOW_TIME, vFlow.h:27-28
MAXSTAMP/TSTOSEC, vFlow.cpp:1323 det threshold), with the same validation
and derived properties. There is no kernel switch: a tensor on a CUDA device
runs the hand-written kernels, a tensor on the CPU runs their plain PyTorch
versions (ops/kernels.py).
"""
from __future__ import annotations

import dataclasses


def normalize_filter_size(filter_size: int) -> int:
    """Reference filter-size normalization (vFlow.cpp:32-33).

    Sizes below 5 collapse to 3; even sizes are decremented to odd.
    """
    if filter_size < 5:
        filter_size = 3
    if filter_size % 2 == 0:
        filter_size -= 1
    return filter_size


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Static configuration of the flow engine (see farms_tpu.config)."""

    # --- sensor geometry (reference: main.cpp:21-22 defaults) ---
    width: int = 320
    height: int = 320

    # --- local plane fit (reference: main.cpp:23-24, vFlow.cpp:32-38) ---
    filter_size: int = 3          # odd neighborhood size k; patch is k x k
    min_evts_on_plane: int = 5    # inlier threshold to accept a plane

    # --- multi-scale aperture correction (reference: vFlow.cpp:73-74, 961) ---
    window_jump: int = 5          # scale stride
    max_window: int = 50          # largest half-window; scales = 0..max step jump
    kill_old_flow_time_us: int = 500  # freshness gate for pooling, microseconds

    # --- timestamp model (reference: vFlow.h:27-28) ---
    # unsigned 32-bit microseconds; differences taken modulo 2**32
    ts_to_sec: float = 1e-6

    # --- plane-fit acceptance (reference: vFlow.cpp:1323) ---
    det_threshold: float = 1.0

    # --- batching (chunk_size=1 reproduces the reference's strictly
    #     event-serial semantics) ---
    chunk_size: int = 2048        # events per micro-step
    steps_per_scan: int = 8       # micro-steps per host->device call

    # chronological sub-phases per micro-step: each group is scattered,
    # flow-computed and pooled in turn, so chunk_size / sub_phases is the
    # co-batch visibility granularity (ACCURACY.md)
    sub_phases: int = 1

    # aperture pooling phases per micro-step (0 = one per sub-phase);
    # see farms_tpu.config for the coarse/fine semantics
    aperture_sub_phases: int = 0

    # causal visibility snapshots per sub-phase (see farms_tpu.config)
    causal_snapshots: int = 1

    # rank-2 center-attribution correction budget (see farms_tpu.config)
    center_correction: int = 0
    correction_coarse_chain: bool = False

    # dense per-pixel formulation (True) or per-event gathers (False)
    use_dense: bool = True

    # device->host wire: "f32" (17 B/event), "f16" (9 B/event, component
    # pairs packed as f16 bit-halves) or "sparse" (validity-sparse f16)
    wire: str = "f32"

    # padded device-array geometry of sharded engines (set via padded_to)
    padded_width: int | None = None
    padded_height: int | None = None

    # the reference clamps the aperture window's y-range with `width`
    # instead of `height` (vFlow.cpp:998-1000, 1111-1113)
    replicate_y_clamp_quirk: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "filter_size", normalize_filter_size(self.filter_size)
        )
        if self.sub_phases < 1 or self.chunk_size % self.sub_phases:
            raise ValueError(
                f"sub_phases {self.sub_phases} must be >= 1 and divide "
                f"chunk_size {self.chunk_size}")
        if self.aperture_sub_phases and (
                (self.aperture_sub_phases % self.sub_phases
                 and self.sub_phases % self.aperture_sub_phases)
                or self.chunk_size % self.aperture_sub_phases):
            raise ValueError(
                f"aperture_sub_phases {self.aperture_sub_phases} must be a "
                f"multiple or divisor of sub_phases {self.sub_phases} and "
                f"divide chunk_size {self.chunk_size}")
        if self.causal_snapshots < 1 or (
                self.chunk_size % (self.sub_phases * self.causal_snapshots)):
            raise ValueError(
                f"causal_snapshots {self.causal_snapshots} must be >= 1 "
                f"with sub_phases*causal_snapshots dividing chunk_size")
        if self.causal_snapshots > 1 and not self.use_dense:
            raise ValueError(
                "causal_snapshots > 1 is a dense-path feature (the "
                "per-event formulation has no snapshot fold)")
        if self.center_correction:
            if not self.use_dense:
                raise ValueError(
                    "center_correction is a dense-path feature (the "
                    "per-event formulation already attributes centers "
                    "exactly)")
            if self.center_correction < 0:
                raise ValueError("center_correction must be >= 0")
            if self.aperture_sub_phases > self.sub_phases:
                raise ValueError(
                    "center_correction requires aperture_sub_phases "
                    "equal to or a divisor of sub_phases (the deferred "
                    "merged-table lane assembly indexes one aperture "
                    "table per lane)")
        if self.wire not in ("f32", "f16", "sparse"):
            raise ValueError(
                f"wire must be 'f32', 'f16' or 'sparse', got {self.wire}")
        if self.num_scales > (63 if self.wire == "sparse" else 127):
            raise ValueError(
                "wire aux byte encodes the scale id in "
                f"{6 if self.wire == 'sparse' else 7} bits; "
                f"{self.num_scales} scales do not fit")
        if self.padded_width is not None and self.padded_width < self.width:
            raise ValueError("padded_width < width")
        if self.padded_height is not None and self.padded_height < self.height:
            raise ValueError("padded_height < height")
        if ((self.padded_width is not None or self.padded_height is not None)
                and not self.use_dense):
            raise ValueError(
                "padded array geometry is only supported on the dense "
                "compute path (the per-event gather path indexes with "
                "semantic coordinates)")

    def padded_to(self, tx: int, ty: int = 1) -> "FlowConfig":
        """This config with array dims rounded up to multiples of (tx, ty)."""
        pw = -(-self.width // tx) * tx
        ph = -(-self.height // ty) * ty
        return dataclasses.replace(
            self,
            padded_width=pw if pw != self.width else None,
            padded_height=ph if ph != self.height else None,
        )

    @property
    def array_width(self) -> int:
        """Device-array width (>= semantic sensor width)."""
        return self.padded_width if self.padded_width is not None else self.width

    @property
    def array_height(self) -> int:
        return (self.padded_height if self.padded_height is not None
                else self.height)

    # --- derived quantities (reference: vFlow.cpp:34-36) ---
    @property
    def f_rad(self) -> int:
        return self.filter_size // 2

    @property
    def plane_size(self) -> int:
        return self.filter_size * self.filter_size

    @property
    def num_scales(self) -> int:
        return self.max_window // self.window_jump + 1

    @property
    def scales(self) -> tuple[int, ...]:
        return tuple(range(0, self.max_window + 1, self.window_jump))

    @property
    def support_radius(self) -> int:
        """Half-width of the gather support covering all 9 candidate patches."""
        return 2 * self.f_rad

    @property
    def halo_width(self) -> int:
        """Surface halo a spatial tile needs from its neighbors."""
        return max(self.max_window, self.support_radius)


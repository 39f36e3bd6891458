"""Event-stream I/O: text-file loading, 11-column output writing, synthetic data.

Counterpart of `farms_tpu.events.io` (which it cannot import: importing
any `farms_tpu` module pulls in the JAX engine). The reference inlines this
I/O in its flow engine (vFlow.cpp:156-191 reads `x y t p` rows;
vFlow.cpp:433-442 writes the 11-column `<name>_FARMSOut_batch.txt`). The
native library (utils/nativeio.py) parses the reference's layout and writes
the output where it is built; NumPy does both otherwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from farms_tpu_torch.utils import nativeio

OUTPUT_SUFFIX = "_FARMSOut_batch.txt"  # reference: vFlow.cpp:131


@dataclasses.dataclass
class EventBatch:
    """Struct-of-arrays event stream (host side).

    Timestamps are raw microseconds as read from file (not yet normalized
    to the first stamp; the engine does `t - t0` like vFlow.cpp:241).
    """

    x: np.ndarray    # int32 [N]
    y: np.ndarray    # int32 [N]
    t: np.ndarray    # uint32 [N], microseconds
    pol: np.ndarray  # int32 [N], already clamped to >= 0 (vFlow.cpp:246-247)

    def __len__(self) -> int:
        return int(self.x.shape[0])

    def __getitem__(self, sl) -> "EventBatch":
        return EventBatch(self.x[sl], self.y[sl], self.t[sl], self.pol[sl])


LAYOUTS = {
    # column order -> (x, y, t, p) indices
    "xytp": (0, 1, 2, 3),   # reference FARMS layout (vFlow.cpp:173-188)
    "txyp": (1, 2, 0, 3),   # Event Camera Dataset / DAVIS events.txt
}


def load_events_txt(path: str, max_events: int | None = None, *,
                    layout: str = "xytp",
                    time_unit: str = "us") -> EventBatch:
    """Read a whitespace-separated event text file.

    `layout` "xytp" is the reference's format (vFlow.cpp:173-188, integer
    microseconds); "txyp" is the Event Camera Dataset `events.txt` format,
    whose float-second stamps need time_unit="s". Timestamps become
    unsigned 32-bit microseconds and negative polarities clamp to 0, as the
    reference parses its own layout.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; known: {list(LAYOUTS)}")
    if time_unit not in ("us", "s"):
        raise ValueError(f"time_unit must be 'us' or 's', got {time_unit!r}")
    if not path.endswith(".txt"):
        path = path + ".txt"
    arr = None
    if layout == "xytp" and time_unit == "us":
        # native mmap parser (the reference's integer-microsecond layout)
        arr = nativeio.parse_events(path, max_events)
    if arr is None:
        arr = np.loadtxt(path, dtype=np.float64, ndmin=2,
                         max_rows=max_events)
        if arr.size == 0:
            arr = np.zeros((0, 4), dtype=np.float64)
        ix, iy, it, ip = LAYOUTS[layout]
        arr = arr[:, [ix, iy, it, ip]]
    x = arr[:, 0].astype(np.int32)
    y = arr[:, 1].astype(np.int32)
    t_raw = arr[:, 2]
    if time_unit == "s":
        t_raw = np.round(t_raw * 1e6)
    t = t_raw.astype(np.int64).astype(np.uint32)
    pol = arr[:, 3].astype(np.int32)
    pol = np.where(pol < 0, 0, pol)
    return EventBatch(x, y, t, pol)


def convert_events_txt(src: str, dst: str, *, layout: str = "txyp",
                       time_unit: str = "s",
                       max_events: int | None = None) -> str:
    """Convert a foreign-layout event file to the reference's `x y t p`
    integer-microsecond layout (which the native parser reads)."""
    ev = load_events_txt(src, max_events, layout=layout, time_unit=time_unit)
    write_events_txt(ev, dst)
    return dst


def write_events_txt(ev: EventBatch, path: str) -> str:
    """Write an event batch in the reference's `x y t p` input format."""
    if not path.endswith(".txt"):
        path = path + ".txt"
    cols = np.stack([ev.x.astype(np.int64), ev.y.astype(np.int64),
                     ev.t.astype(np.int64), ev.pol.astype(np.int64)], axis=1)
    np.savetxt(path, cols, fmt="%d")
    return path


def write_events_davis_txt(ev: EventBatch, path: str) -> str:
    """Write an event batch in the Event Camera Dataset `t x y p` layout
    (float-second stamps with 9 decimals, so microseconds round-trip)."""
    if not path.endswith(".txt"):
        path = path + ".txt"
    with open(path, "w") as fh:
        for i in range(len(ev)):
            fh.write(f"{ev.t[i] * 1e-6:.9f} {ev.x[i]} {ev.y[i]} "
                     f"{ev.pol[i]}\n")
    return path


@dataclasses.dataclass
class FlowOutput:
    """The 11 output columns of the batch pipeline (vFlow.cpp:438).

    Column order: x y t p RTrue ThetaTrue Vx Vy RLocal ThetaLocal SpatialWindow.
    Invalid events carry zeros in R/Theta columns but the *raw* (possibly
    non-finite) Vx/Vy, matching vFlow.cpp:390-395.
    """

    x: np.ndarray            # int32
    y: np.ndarray            # int32
    t: np.ndarray            # uint32 (normalized, t - t0)
    pol: np.ndarray          # int32
    r_true: np.ndarray       # float
    theta_true: np.ndarray   # float
    vx: np.ndarray           # float (local)
    vy: np.ndarray           # float (local)
    r_local: np.ndarray      # float
    theta_local: np.ndarray  # float
    scale: np.ndarray        # int32

    def __len__(self) -> int:
        return int(self.x.shape[0])

    def as_matrix(self) -> np.ndarray:
        """Return the 11 columns as a float64 [N, 11] matrix."""
        return np.stack(
            [getattr(self, f.name).astype(np.float64)
             for f in dataclasses.fields(self)], axis=1)

    @staticmethod
    def concatenate(parts: list["FlowOutput"]) -> "FlowOutput":
        return FlowOutput(**{
            f.name: np.concatenate([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(FlowOutput)})


def write_flow_txt(out: FlowOutput, base_path: str) -> str:
    """Write `<base_path>_FARMSOut_batch.txt` in the reference's format.

    One row per event, 11 space-separated columns (vFlow.cpp:436-440).
    """
    path = base_path + OUTPUT_SUFFIX
    mat = out.as_matrix()
    if nativeio.write_flow(path, mat):
        return path
    with open(path, "w") as fh:
        for row in mat:
            fh.write(
                f"{int(row[0])} {int(row[1])} {int(row[2])} {int(row[3])} "
                f"{_fmt(row[4])} {_fmt(row[5])} {_fmt(row[6])} {_fmt(row[7])} "
                f"{_fmt(row[8])} {_fmt(row[9])} {int(row[10])}\n"
            )
    return path


def read_flow_txt(path: str) -> FlowOutput:
    """Load an 11-column output file (ours or the reference's)."""
    mat = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if mat.size == 0:
        mat = np.zeros((0, 11))
    return FlowOutput(
        x=mat[:, 0].astype(np.int32),
        y=mat[:, 1].astype(np.int32),
        t=mat[:, 2].astype(np.int64).astype(np.uint32),
        pol=mat[:, 3].astype(np.int32),
        r_true=mat[:, 4],
        theta_true=mat[:, 5],
        vx=mat[:, 6],
        vy=mat[:, 7],
        r_local=mat[:, 8],
        theta_local=mat[:, 9],
        scale=mat[:, 10].astype(np.int32),
    )


def _fmt(v: float) -> str:
    """Format a float like the native writer (native/fast_io.cpp
    fmt_value): integers without a point, else printf's %.6g, whose
    non-finite values glibc prints as inf, -inf, nan and -nan (the sign
    bit of a NaN shows)."""
    if not np.isfinite(v):
        return ("-" if np.signbit(v) else "") + ("nan" if np.isnan(v)
                                                 else "inf")
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


# ---------------------------------------------------------------------------
# Synthetic event generators (test fixtures; closed-form ground-truth flow)
# ---------------------------------------------------------------------------

def synthetic_translating_bar(
    width: int = 320,
    height: int = 320,
    speed_px_per_sec: float = 1000.0,
    bar_len: int = 60,
    duration_us: int = 200_000,
    t0_us: int = 1000,
    seed: int = 0,
    jitter_us: float = 0.0,
) -> EventBatch:
    """A vertical bar translating in +x at a constant speed.

    Every pixel the bar's leading edge crosses fires one event; ground-truth
    flow is (speed, 0). Same stream as farms_tpu's generator for equal
    arguments.
    """
    rng = np.random.default_rng(seed)
    us_per_px = 1e6 / speed_px_per_sec
    xs, ys, ts = [], [], []
    y_lo = (height - bar_len) // 2
    n_cols = int(duration_us / us_per_px)
    x_start = 10
    for step in range(min(n_cols, width - 20 - x_start)):
        x = x_start + step
        t_col = t0_us + step * us_per_px
        for y in range(y_lo, y_lo + bar_len):
            tj = t_col + (rng.uniform(-jitter_us, jitter_us) if jitter_us else 0.0)
            xs.append(x)
            ys.append(y)
            ts.append(max(0.0, tj))
    order = np.argsort(np.asarray(ts), kind="stable")
    x = np.asarray(xs, dtype=np.int32)[order]
    y = np.asarray(ys, dtype=np.int32)[order]
    t = np.asarray(ts, dtype=np.float64)[order].astype(np.int64).astype(np.uint32)
    pol = np.ones_like(x, dtype=np.int32)
    return EventBatch(x, y, t, pol)


def synthetic_rotating_shapes(
    width: int = 240,
    height: int = 180,
    omega_rad_s: float = 2.0 * np.pi,
    duration_us: int = 500_000,
    n_spokes: int = 4,
    t0_us: int = 1000,
    noise_frac: float = 0.15,
    seed: int = 0,
) -> EventBatch:
    """A DAVIS240-style rotating scene (the Event Camera Dataset's
    `shapes_rotation` regime): edge events along spokes rotating about the
    image center (tangential flow, |v| = omega * r) plus background noise.
    A pixel fires when a spoke's rasterization newly covers it. Same stream
    as farms_tpu's generator for equal arguments.
    """
    rng = np.random.default_rng(seed)
    cx, cy = width / 2.0, height / 2.0
    L = 0.45 * min(width, height)
    d = np.arange(6.0, L, 1.0)
    dtheta = 1.0 / L          # outermost sample moves ~1 px per step
    us_per_step = dtheta / omega_rad_s * 1e6
    n_steps = max(1, int(duration_us / us_per_step))
    xs, ys, ts = [], [], []
    prev = {}
    for k in range(n_steps):
        t_k = t0_us + k * us_per_step
        for s in range(n_spokes):
            th = s * 2.0 * np.pi / n_spokes + k * dtheta
            px = np.round(cx + d * np.cos(th)).astype(np.int64)
            py = np.round(cy + d * np.sin(th)).astype(np.int64)
            cur = px * height + py
            last = prev.get(s)
            new = np.ones(len(d), bool) if last is None else cur != last
            prev[s] = cur
            keep = new & (px >= 0) & (px < width) & (py >= 0) & (py < height)
            nn = int(keep.sum())
            xs.append(px[keep])
            ys.append(py[keep])
            ts.append(t_k + rng.uniform(0, us_per_step * 0.5, nn))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t = np.concatenate(ts)
    n_noise = int(len(x) * noise_frac)
    if n_noise:
        x = np.concatenate([x, rng.integers(0, width, n_noise)])
        y = np.concatenate([y, rng.integers(0, height, n_noise)])
        t = np.concatenate([t, rng.uniform(t0_us, t.max(), n_noise)])
    order = np.argsort(t, kind="stable")
    return EventBatch(
        x=x[order].astype(np.int32),
        y=y[order].astype(np.int32),
        t=t[order].astype(np.int64).astype(np.uint32),
        pol=rng.integers(0, 2, len(x)).astype(np.int32),
    )


def synthetic_random_events(
    n: int,
    width: int = 320,
    height: int = 320,
    rate_hz: float = 1e6,
    seed: int = 0,
    hot_fraction: float = 0.25,
) -> EventBatch:
    """Random events: a moving hot spot plus background noise.

    Not physically meaningful flow; used for stress tests and throughput
    runs. Same stream as farms_tpu's generator for equal arguments.
    """
    rng = np.random.default_rng(seed)
    dt = rng.exponential(1e6 / rate_hz, size=n)
    t = np.cumsum(dt).astype(np.int64).astype(np.uint32)
    x = rng.integers(0, width, size=n, dtype=np.int32)
    y = rng.integers(0, height, size=n, dtype=np.int32)
    # concentrate a fraction of events around a drifting hot spot so that
    # plane fits actually succeed sometimes
    n_hot = int(n * hot_fraction)
    hot_idx = rng.choice(n, size=n_hot, replace=False)
    cx = (width / 2 + 40 * np.sin(t[hot_idx].astype(np.float64) / 3e5)).astype(np.int32)
    cy = (height / 2 + 40 * np.cos(t[hot_idx].astype(np.float64) / 3e5)).astype(np.int32)
    x[hot_idx] = np.clip(cx + rng.integers(-3, 4, size=n_hot), 0, width - 1)
    y[hot_idx] = np.clip(cy + rng.integers(-3, 4, size=n_hot), 0, height - 1)
    pol = rng.integers(0, 2, size=n, dtype=np.int32)
    return EventBatch(x, y, t, pol)

"""Event-stream I/O: text-file loading, 11-column output writing, synthetic data.

NumPy-only counterpart of `farms_tpu.events.io` (which it cannot import:
importing any `farms_tpu` module pulls in the JAX engine). The reference
inlines this I/O in its flow engine (vFlow.cpp:156-191 reads `x y t p` rows;
vFlow.cpp:433-442 writes the 11-column `<name>_FARMSOut_batch.txt`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
    arr = np.loadtxt(path, dtype=np.float64, ndmin=2, max_rows=max_events)
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


def write_events_txt(ev: EventBatch, path: str) -> str:
    """Write an event batch in the reference's `x y t p` input format."""
    if not path.endswith(".txt"):
        path = path + ".txt"
    cols = np.stack([ev.x.astype(np.int64), ev.y.astype(np.int64),
                     ev.t.astype(np.int64), ev.pol.astype(np.int64)], axis=1)
    np.savetxt(path, cols, fmt="%d")
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


def write_flow_txt(out: FlowOutput, base_path: str) -> str:
    """Write `<base_path>_FARMSOut_batch.txt` in the reference's format.

    One row per event, 11 space-separated columns (vFlow.cpp:436-440).
    """
    path = base_path + OUTPUT_SUFFIX
    mat = out.as_matrix()
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
    """Format a float like C++ iostream default (6 significant digits)."""
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

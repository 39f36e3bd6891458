"""Qualitative visualization of flow output (counterpart of farms_tpu.viz):
a Python port of the reference's MATLAB script
(showOpticalFlowOutputWithHistogram.m).

Per 10 ms window (…m:78, 121) it renders four panels:
  1. the raw event image,
  2. local flow colored by direction (cols 9-10 of the output, …m:157),
  3. aperture-corrected flow colored by direction (cols 5-6, …m:158),
  4. polar histograms of the local vs corrected direction distributions
     (…m:255-259, 348-355) - the paper's qualitative evidence that aperture
     correction sharpens the direction distribution.

Rows with RTrue == 0 are filtered like the MATLAB script (…m:40). Direction
color bins are pi/12 like the HSV mapping (…m:203-237). Figures are saved
as PNG per window (…m:379-389).

matplotlib is imported lazily and the module degrades to a clear error if
it is unavailable in the runtime image. Run as

    python -m farms_tpu_torch.viz --filename <base> [--out-dir D]
"""
from __future__ import annotations

import os

import numpy as np

from farms_tpu_torch.events.io import EventBatch, FlowOutput

WINDOW_US = 10_000  # 10 ms windows (…m:78)


def render_flow_windows(
    events: EventBatch,
    flow: FlowOutput,
    out_dir: str,
    width: int = 320,
    height: int = 320,
    max_windows: int | None = None,
    quiver_stride: int = 4,
) -> list[str]:
    """Render per-window figures; returns the list of written PNG paths."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "matplotlib is required for visualization; install it or use "
            "the raw output files"
        ) from e

    os.makedirs(out_dir, exist_ok=True)

    valid = flow.r_true != 0           # …m:40
    t = flow.t.astype(np.int64)
    t_end = int(t.max()) if len(flow) else 0
    n_windows = max(1, t_end // WINDOW_US + 1)
    if max_windows is not None:
        n_windows = min(n_windows, max_windows)

    ev_t = (events.t.astype(np.uint32) - np.uint32(events.t[0])).astype(np.int64)

    paths = []
    for w in range(n_windows):
        lo, hi = w * WINDOW_US, (w + 1) * WINDOW_US
        in_w = (t >= lo) & (t < hi) & valid
        ev_in = (ev_t >= lo) & (ev_t < hi)
        if not in_w.any():
            continue

        fig = plt.figure(figsize=(14, 10))

        # panel 1: event image
        ax = fig.add_subplot(2, 2, 1)
        img = np.zeros((height, width))
        np.add.at(img, (np.clip(events.y[ev_in], 0, height - 1),
                        np.clip(events.x[ev_in], 0, width - 1)), 1)
        ax.imshow(img, cmap="gray_r", origin="lower")
        ax.set_title(f"events [{lo / 1000:.0f}-{hi / 1000:.0f} ms]")

        # panels 2-3: local and corrected flow, colored by direction
        for pi_, (name, theta, r) in enumerate(
            [("local flow", flow.theta_local, flow.r_local),
             ("aperture-corrected flow", flow.theta_true, flow.r_true)]
        ):
            ax = fig.add_subplot(2, 2, 2 + pi_)
            xs = flow.x[in_w][::quiver_stride]
            ys = flow.y[in_w][::quiver_stride]
            th = theta[in_w][::quiver_stride]
            rr = r[in_w][::quiver_stride]
            # direction -> hue in pi/12 bins (…m:203-237)
            bins = np.floor(((th + np.pi) / (np.pi / 12))).astype(int) % 24
            colors = plt.cm.hsv(bins / 24.0)
            rn = rr / (np.abs(rr).max() + 1e-12)
            ax.quiver(xs, ys, rn * np.cos(th), rn * np.sin(th),
                      color=colors, scale=20, width=0.003)
            ax.set_xlim(0, width)
            ax.set_ylim(0, height)
            ax.set_title(name)

        # panel 4: polar histograms local vs corrected (…m:255-259, 348-355)
        ax = fig.add_subplot(2, 2, 4, projection="polar")
        edges = np.linspace(-np.pi, np.pi, 25)
        for theta, label in [(flow.theta_local[in_w], "local"),
                             (flow.theta_true[in_w], "corrected")]:
            hist, _ = np.histogram(theta, bins=edges)
            centers = (edges[:-1] + edges[1:]) / 2
            ax.plot(np.concatenate([centers, centers[:1]]),
                    np.concatenate([hist, hist[:1]]), label=label)
        ax.legend(loc="upper right")
        ax.set_title("direction distribution")

        path = os.path.join(out_dir, f"flow_window_{w:04d}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        paths.append(path)
    return paths


def main(argv=None):  # pragma: no cover
    import argparse

    from farms_tpu_torch.events.io import load_events_txt, read_flow_txt

    p = argparse.ArgumentParser(
        description="Render flow visualization panels per 10 ms window")
    p.add_argument("--filename", required=True,
                   help="events file base name (without .txt)")
    p.add_argument("--out-dir", default="flow_viz")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--max-windows", type=int, default=None)
    args = p.parse_args(argv)

    events = load_events_txt(args.filename)
    flow = read_flow_txt(args.filename + "_FARMSOut_batch.txt")
    paths = render_flow_windows(events, flow, args.out_dir,
                                args.width, args.height, args.max_windows)
    print(f"wrote {len(paths)} figures to {args.out_dir}")


if __name__ == "__main__":  # pragma: no cover
    main()

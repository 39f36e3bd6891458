"""The traced run's device timeline, reduced in memory.

`Profile` records a bounded slice of the window with torch.profiler (CPU
and CUDA activity; the benchmark's call spans are profiler ranges named
`flowbench.<call>`); it is made in set-up, where it starts the profiler
once so that the slice does not pay for loading CUPTI. `summarize` turns the slice into the numbers the
per-layer readers take:

- the traced window: from the start of the first traced call to the end
  of the last (queue waits between calls included), and the device's
  busy time in it: the union of every device-side interval (kernels,
  copies, sets), so overlapping streams count once;
- the traced calls' wall time and the busy time inside them;
- device time and launches by kernel name;
- the device operations that took most time, and the longest idle gaps,
  each named by the innermost host range around its middle: a torch op,
  the benchmark's span of the call (`flowbench.process()` or
  `flowbench.fn()`, where the host runs code of the program that is not a
  torch op), or "between calls".

Nothing is written to disk.
"""
from __future__ import annotations

import numpy as np

CALL_RANGE = "flowbench."


class Profile:
    """torch.profiler over the traced calls: `start` before the first,
    `stop` after the last (or after the window closes, so that a slice at
    the window's end leaves every untraced call undisturbed). The buffers
    are parsed after the window, in `summarize`."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity
        # the first profiler of a process loads CUPTI, which takes seconds:
        # do that here, in set-up, and not at the first traced call (in an
        # open-loop window the calls due meanwhile would queue behind it)
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda" if torch.cuda.is_available()
                        else "cpu")
        self.prof = None
        self.done = False

    def start(self) -> None:
        if self.prof is None:
            import torch
            from torch.profiler import ProfilerActivity
            self.prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                acc_events=True)
            self.prof.__enter__()

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            self.prof.__exit__(None, None, None)
            self.done = True


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering the [n, 2] intervals `iv`."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.asarray(out, np.float64)


def _overlap(union: np.ndarray, lo: float, hi: float) -> float:
    """Length of the disjoint intervals `union` inside [lo, hi]."""
    if union.size == 0 or hi <= lo:
        return 0.0
    a = np.clip(union[:, 0], lo, hi)
    b = np.clip(union[:, 1], lo, hi)
    return float(np.sum(b - a))


def summarize(profile: Profile, top: int = 10) -> dict | None:
    """The slice's numbers (seconds), or None where the profiler recorded
    no device activity or no traced call."""
    profile.stop()
    if not profile.done:
        return None
    from torch.autograd import DeviceType
    dev, host, calls, call_ranges = [], [], [], []
    for e in profile.prof.events():
        lo, hi = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((e.name, lo, hi))
        elif e.name.startswith(CALL_RANGE):
            calls.append((lo, hi))
            call_ranges.append((e.name, lo, hi))
        else:
            host.append((e.name, lo, hi))
    if not dev or not calls:
        return None
    calls.sort()
    w_lo, w_hi = calls[0][0], max(h for _, h in calls)
    dev_iv = np.asarray([(lo, hi) for _, lo, hi in dev], np.float64)
    union = _union(dev_iv)
    busy = _overlap(union, w_lo, w_hi)
    busy_in_calls = sum(_overlap(union, lo, hi) for lo, hi in calls)
    kernels = {}
    for name, lo, hi in dev:
        if hi > w_lo and lo < w_hi:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (min(hi, w_hi) - max(lo, w_lo)) * 1e-6
    # idle gaps inside the window, each named by the innermost host range
    # (shortest span) around its middle
    edges = np.concatenate([[w_lo], np.clip(union.ravel(), w_lo, w_hi),
                            [w_hi]]).reshape(-1, 2)
    gaps = [(a, b) for a, b in edges if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    ranges = host + [(name, lo, hi) for name, lo, hi in call_ranges]
    named = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inner = [(hi - lo, name) for name, lo, hi in ranges
                 if lo <= mid <= hi]
        named.append([min(inner)[1] if inner else "between calls",
                      (b - a) * 1e-6])
    ops = sorted(([n[:160], v[1]] for n, v in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    return {"window_s": (w_hi - w_lo) * 1e-6, "busy_s": busy * 1e-6,
            # the result line's device readings (a multi-rank driver
            # replaces them by the mean over its cards)
            "device_window_s": (w_hi - w_lo) * 1e-6,
            "device_busy_s": busy * 1e-6,
            "calls": len(calls),
            "call_s": sum(hi - lo for lo, hi in calls) * 1e-6,
            "busy_in_calls_s": busy_in_calls * 1e-6,
            "kernels": kernels,
            "breakdown": {"device_ops": ops, "idle_gaps": named}}

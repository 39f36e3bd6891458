"""The benchmark's event generators and schedule, from a seed.

A traffic mix names its generator by its dotted name (a function under
`flowbench/traffic/`) with its keyword arguments; the harness calls it
as `fn(width=, height=, rate=, n_events=, seed=, device=, **keywords)`
and gets a `Stream`. A mix's `bursts` re-time the stream's stamps
(`bursts`). Two generators are here:

`rotating_edges`: a frozen, vectorised copy of the port's moving-edge generator
(`synthetic_rotating_shapes`, the Event Camera Dataset's `shapes_rotation`
regime): `edges` straight spokes from radius 6 to 0.45 x min(W, H) rotate
about the sensor centre; in each step of the rotation every spoke sample
whose rasterised pixel changed fires once, stamped at the step's time plus
a uniform jitter of half a step; `noise_frac` of the edge count is added
as uniform noise over the sensor and the stream's span. The rotation's
geometry does not depend on its speed, so the step length is set from the
edge events of the stream so that the mean stamp rate is `rate` events a
second: the rim speed follows from the rate and the edge count.

`uniform_random`: a frozen, vectorised copy of the port's throughput
stream (`synthetic_random_events`, bench.py's): exponential gaps at
`rate` truncated to whole microseconds, so a fast stream holds many equal
stamps; uniform pixels, with `hot_fraction` of the events within 3 px of
a spot drifting 40 px about the centre.

A stream is made once a run and replayed as a pool (`Pool`): replay r of
the pool adds r pool spans to every stamp, so stamps keep increasing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# elements of one vectorised block of rotation steps x edges x samples
_BLOCK_ELEMS = 1 << 24


@dataclasses.dataclass
class Stream:
    x: np.ndarray       # int32
    y: np.ndarray       # int32
    t: np.ndarray       # uint32 microseconds
    p: np.ndarray       # int32 polarity
    rim_px_s: float     # the spokes' speed at their outer end

    def __len__(self) -> int:
        return int(self.x.shape[0])


def rotating_edges(width: int, height: int, rate: float, n_events: int,
                   edges: int, noise_frac: float = 0.15, seed: int = 0,
                   t0_us: int = 1000, device="cpu") -> Stream:
    """`n_events` events of `edges` rotating spokes and noise, at a mean
    stamp rate of `rate` events a second, sorted by stamp. Made on
    `device` (a seed gives the same stream on every run on one kind of
    device) and returned as host arrays."""
    if n_events < 1 or rate <= 0 or edges < 1:
        raise ValueError("n_events, rate and edges must be positive")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=dev)
    cx, cy = width / 2.0, height / 2.0
    L = 0.45 * min(width, height)
    d = torch.arange(6.0, L, 1.0, **f64)
    dtheta = 1.0 / L                 # the rim moves about 1 px a step
    base = torch.arange(edges, **f64) * (2.0 * np.pi / edges)
    need = int(np.ceil(n_events / (1.0 + noise_frac))) + 1
    block = max(2, _BLOCK_ELEMS // (edges * d.numel()))
    steps, xs, ys = [], [], []
    prev = None
    got, k0 = 0, 0
    while got < need:
        k = torch.arange(k0, k0 + block, **f64)
        th = base[None, :, None] + k[:, None, None] * dtheta   # [B, e, 1]
        px = torch.round(cx + d * torch.cos(th)).to(torch.int64)
        py = torch.round(cy + d * torch.sin(th)).to(torch.int64)
        cur = px * height + py                                  # [B, e, d]
        before = torch.cat([cur[:1] if prev is None else prev[None],
                            cur[:-1]])
        new = cur != before
        if prev is None:
            new[0] = True
        prev = cur[-1]
        new &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
        kk = torch.nonzero(new)[:, 0]
        steps.append(kk + k0)
        xs.append(px[new])
        ys.append(py[new])
        got += int(kk.numel())
        k0 += block
    step = torch.cat(steps)[:need]
    x = torch.cat(xs)[:need]
    y = torch.cat(ys)[:need]
    n_noise = int(x.numel() * noise_frac)
    n_steps = int(step[-1]) + 1
    # the step length that gives the mean rate over the whole stream
    us_per_step = (x.numel() + n_noise) / n_steps / rate * 1e6
    jitter = torch.rand(x.numel(), generator=gen, **f64) * 0.5
    t = t0_us + (step.to(torch.float64) + jitter) * us_per_step
    if n_noise:
        x = torch.cat([x, torch.randint(0, width, (n_noise,), generator=gen,
                                        device=dev)])
        y = torch.cat([y, torch.randint(0, height, (n_noise,),
                                        generator=gen, device=dev)])
        t = torch.cat([t, t0_us + torch.rand(n_noise, generator=gen, **f64)
                       * (n_steps * us_per_step)])
    ti = t.to(torch.int64)
    ti, order = torch.sort(ti, stable=True)
    order = order[:n_events]
    pol = torch.randint(0, 2, (order.numel(),), generator=gen, device=dev)
    return Stream(x[order].to(torch.int32).cpu().numpy(),
                  y[order].to(torch.int32).cpu().numpy(),
                  ti[:n_events].to(torch.int32).cpu().numpy().view(np.uint32),
                  pol.to(torch.int32).cpu().numpy(),
                  rim_px_s=L * dtheta / us_per_step * 1e6)


def uniform_random(width: int, height: int, rate: float, n_events: int,
                   hot_fraction: float = 0.25, seed: int = 0,
                   t0_us: int = 1000, device="cpu") -> Stream:
    """`n_events` uniform events and a drifting hot spot at a mean rate of
    `rate` events a second, made on `device`, returned as host arrays."""
    if n_events < 1 or rate <= 0:
        raise ValueError("n_events and rate must be positive")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    gaps = torch.empty(n_events, dtype=torch.float64, device=dev)
    gaps.exponential_(rate * 1e-6, generator=gen)
    t = (t0_us + torch.cumsum(gaps, 0)).to(torch.int64)
    x = torch.randint(0, width, (n_events,), generator=gen, device=dev)
    y = torch.randint(0, height, (n_events,), generator=gen, device=dev)
    hot = torch.randperm(n_events, generator=gen, device=dev)[
        :int(n_events * hot_fraction)]
    th = t[hot].to(torch.float64) / 3e5
    jx = torch.randint(-3, 4, (hot.numel(),), generator=gen, device=dev)
    jy = torch.randint(-3, 4, (hot.numel(),), generator=gen, device=dev)
    x[hot] = ((width / 2 + 40 * torch.sin(th)).to(torch.int64)
              + jx).clamp(0, width - 1)
    y[hot] = ((height / 2 + 40 * torch.cos(th)).to(torch.int64)
              + jy).clamp(0, height - 1)
    pol = torch.randint(0, 2, (n_events,), generator=gen, device=dev)
    return Stream(x.to(torch.int32).cpu().numpy(),
                  y.to(torch.int32).cpu().numpy(),
                  t.to(torch.int32).cpu().numpy().view(np.uint32),
                  pol.to(torch.int32).cpu().numpy(),
                  rim_px_s=40 / 0.3)          # the spot's speed


def bursts(stream: Stream, rate: float, factor: float, every_s: float,
           length_s: float) -> Stream:
    """The stream re-timed so that every `every_s` seconds open with
    `length_s` seconds at `factor` times the rate between them, the mean
    rate staying `rate`. The events and their order are kept: the event
    that came n-th in a period still does."""
    P, b = every_s * 1e6, length_s * 1e6
    if factor < 1 or not 0 < b < P:
        raise ValueError("need factor >= 1 and 0 < length_s < every_s")
    per_us = rate * 1e-6
    base = per_us * P / (P + (factor - 1) * b)   # events a us between
    t = stream.t.astype(np.float64)
    u = t - t[0]
    k = np.floor(u / P)
    v = per_us * (u - k * P)                      # events into its period
    head = factor * base * b
    tau = np.where(v < head, v / (factor * base), b + (v - head) / base)
    new = np.floor(t[0] + k * P + tau).astype(np.int64)
    return dataclasses.replace(stream, t=new.astype(np.uint32))


class Pool:
    """A stream replayed with continued stamps: event i of the endless
    stream is pool event i mod N, its stamp raised by (i div N) spans,
    a span being the pool's stamp range plus one mean gap."""

    def __init__(self, stream: Stream, rate: float):
        self.s = stream
        n = len(stream)
        gap = max(1, int(round(1e6 / rate)))
        self.span = int(stream.t[-1]) - int(stream.t[0]) + gap

    def __len__(self) -> int:
        return len(self.s)

    def take(self, start: int, count: int):
        """(x, y, t, p) of events [start, start + count) of the endless
        stream; stamps wrap mod 2^32 as the sensor's do."""
        n = len(self.s)
        parts = []
        while count > 0:
            rep, i = divmod(start, n)
            k = min(count, n - i)
            shift = np.uint32((rep * self.span) & 0xFFFFFFFF)
            parts.append((self.s.x[i:i + k], self.s.y[i:i + k],
                          self.s.t[i:i + k] + shift, self.s.p[i:i + k]))
            start += k
            count -= k
        if len(parts) == 1:
            return parts[0]
        return tuple(np.concatenate(c) for c in zip(*parts))

    def stamp(self, index: int) -> int:
        """The unwrapped stamp (microseconds) of event `index`."""
        rep, i = divmod(index, len(self.s))
        return int(self.s.t[i]) + rep * self.span

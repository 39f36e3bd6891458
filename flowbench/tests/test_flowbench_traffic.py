"""The generator and the open-loop schedule."""
from __future__ import annotations

import time
import types

import numpy as np
import pytest

from flowbench import harness
from flowbench.drivers import live
from flowbench.traffic.gen import Pool, bursts, rotating_edges, uniform_random

from conftest import tiny_cell


@pytest.mark.parametrize("w,h,rate,edges", [(64, 48, 2e5, 6),
                                            (240, 180, 3.6e6, 16),
                                            (1280, 720, 1e7, 16)])
def test_flowbench_generator_rate_and_determinism(w, h, rate, edges):
    n = 200_000
    a = rotating_edges(w, h, rate, n, edges, seed=2**31 + 11)
    b = rotating_edges(w, h, rate, n, edges, seed=2**31 + 11)
    c = rotating_edges(w, h, rate, n, edges, seed=5)
    for k in ("x", "y", "t", "p"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.x, c.x)
    assert len(a) == n and np.all(np.diff(a.t.astype(np.int64)) >= 0)
    assert a.x.min() >= 0 and a.x.max() < w and a.y.max() < h
    got = (n - 1) / ((int(a.t[-1]) - int(a.t[0])) * 1e-6)
    assert abs(got / rate - 1) < 0.02


def test_flowbench_uniform_generator_rate_and_determinism():
    n = 200_000
    a = uniform_random(320, 320, 5e6, n, seed=2**31 + 12)
    b = uniform_random(320, 320, 5e6, n, seed=2**31 + 12)
    assert all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("x", "y", "t", "p"))
    assert not np.array_equal(a.x, uniform_random(320, 320, 5e6, n,
                                                  seed=6).x)
    d = np.diff(a.t.astype(np.int64))
    assert np.all(d >= 0) and np.mean(d == 0) > 0.5   # equal stamps
    got = (n - 1) / ((int(a.t[-1]) - int(a.t[0])) * 1e-6)
    assert abs(got / 5e6 - 1) < 0.02
    assert a.x.min() >= 0 and a.x.max() < 320 and a.y.max() < 320


def test_flowbench_bursts_keep_mean_rate_and_order():
    s = rotating_edges(240, 180, 4e6, 400_000, 16, seed=2)
    b = bursts(s, 4e6, factor=3, every_s=0.02, length_s=0.002)
    t = b.t.astype(np.int64)
    assert np.all(np.diff(t) >= 0) and np.array_equal(b.x, s.x)
    assert abs((len(t) - 1) / ((t[-1] - t[0]) * 1e-6) / 4e6 - 1) < 0.01
    # a tenth of each period holds 3 / 12 of its events
    share = np.mean((t - t[0]) % 20_000 < 2_000)
    assert abs(share - 3 * 2 / (20 + 2 * 2)) < 0.01


def test_flowbench_pool_continues_stamps():
    s = rotating_edges(64, 48, 2e5, 5000, 6, seed=1)
    p = Pool(s, 2e5)
    x, y, t, _ = p.take(4990, 20)
    assert np.all(np.diff(t.astype(np.int64)) >= 0)
    assert np.array_equal(x[10:], s.x[:10])
    assert p.stamp(5000) == int(s.t[0]) + p.span


class _Sleepy:
    """process() takes 5 ms, the third call 300 ms."""

    def __init__(self):
        self.n = 0

    def process(self, ev):
        self.n += 1
        time.sleep(0.3 if self.n == 3 + 4 else 0.005)
        z = np.zeros(len(ev), np.float32)
        return types.SimpleNamespace(r_true=z, theta_true=z, vx=z, vy=z,
                                     r_local=z, theta_local=z,
                                     scale=z.astype(np.int32))

    def whole_state(self):
        return None


def test_flowbench_open_loop_charges_a_stall_to_later_calls(monkeypatch):
    cell = tiny_cell("davis240c.live", rate=2048 / 0.05, warmup_calls=4)
    monkeypatch.setattr(harness, "make_engine", lambda c, d: _Sleepy())
    r = live.run(cell, 3, 1.0, False, "cpu")
    lat = [(c["end"] - c["due"]) for c in r["calls"]]
    # calls are due every 50 ms; the third takes 300 ms, so the next
    # calls start late and their latency holds the wait
    assert lat[2] > 0.29
    assert lat[3] > 0.2 and lat[4] > 0.15
    assert r["calls"][3]["start"] - r["calls"][3]["due"] > 0.2
    assert lat[-1] < 0.05          # the backlog drains
    p50 = harness.percentile([x * 1e3 for x in lat], 50)
    assert abs(r["e2e"]["latency_p50_ms"] - p50) < 1e-9

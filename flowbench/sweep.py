"""Offered-rate sweep of an open-loop cell, to find the knee once.

    python3 -m flowbench.sweep --workload davis240c.live \\
        --rates 2e6 3e6 4e6 --seconds 6 --seed 1

runs the cell's driver at each rate in turn (a fresh engine and pool
each, no correctness check) and prints a JSON line per rate: the
latency median and 95th percentile, the calls, and how the queue wait
grew from the window's first quarter to its last. The knee is the
highest rate whose queue wait does not grow; the cell's traffic file
then takes 0.8 x that rate as a number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    import importlib
    from flowbench import harness
    cell = harness.load_cell(args.workload)
    driver = importlib.import_module(
        f"flowbench.drivers.{cell.traffic['driver']}")
    for rate in args.rates:
        c = dataclasses.replace(cell, traffic=dict(cell.traffic, rate=rate))
        r = driver.run(c, args.seed, args.seconds, False, "cuda")
        calls = r["calls"]
        wait = np.array([c_["start"] - c_["due"] for c_ in calls]) * 1e3
        q = max(1, len(wait) // 4)
        print(json.dumps({
            "rate": rate, "calls": len(calls), **r["e2e"],
            "wait_ms_first_quarter": float(np.median(wait[:q])),
            "wait_ms_last_quarter": float(np.median(wait[-q:])),
            "call_ms_median": float(np.median(
                [(c_["end"] - c_["start"]) * 1e3 for c_ in calls]))}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

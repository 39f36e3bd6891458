"""Run one cell of the port's benchmark once and print its result line.

    python3 -m flowbench.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout of the repository, on a machine with as many
CUDA cards as the cell asks for. The cell, its configuration, its traffic
mix and its metrics are found by name from BENCHMARK.json (see
flowbench/README.md). Set-up (`setup_s`) runs from the start of this
process to the opening of the measured window: building the port's
kernel and native-I/O libraries where the checkout has none yet, making
the events from the seed, building the engine and warming up the cell's
own shapes. The window then runs for `--seconds`. After it, the checked
calls are run again by the plain reference and compared (`correct`); the
numbers compared and their limits are the last lines on standard error
and the last key (`checks`) of the result line, which is the last line
on standard output. With `--trace 1` the line carries the per-layer
metrics, read from a bounded slice of the window traced by
torch.profiler, instead of the end-to-end ones.

Exits non-zero without printing a result where CUDA or the cell's cards
are missing, and where JAX, its packages or the JAX package of this
repository were loaded by the time the window closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# torch's intra-op and OpenMP threads for the port's host side, as the
# port's mesh ranks run: runs with eight threads on the card's shared
# cores spread wider
HOST_THREADS = 1
# top-level module names that must not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "farms_tpu")


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, trace: bool,
            device_type: str = "cuda") -> tuple:
    """Run the cell once; returns (result line dict, check lines)."""
    import torch
    from flowbench import harness
    from flowbench.reference.compare import NUMBERS, judge

    driver = importlib.import_module(
        f"flowbench.drivers.{cell.traffic['driver']}")
    r = driver.run(cell, seed, seconds, trace, device_type)
    # this process's modules, and those the ranks of a multi-rank driver
    # found in theirs
    found = forbidden_modules() + r.get("forbidden", [])
    if found:
        raise RuntimeError(f"modules loaded in the benchmark's processes: "
                           f"{', '.join(found)}")
    gc.unfreeze()           # what set-up froze (harness.settle)
    gc.collect()
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    began = time.perf_counter()
    nums = judge(r["samples"], cell.flow, r["t0"],
                 torch.device("cuda", 0) if cuda else "cpu")
    judged = (f"reference: {len(r['samples'])} calls checked in "
              f"{time.perf_counter() - began:.1f} s")
    # an infinite gap (NaN against a number) prints as the largest float
    checks = {k: {"value": min(nums[k], sys.float_info.max),
                  "limit": cell.limits[k]} for k in NUMBERS}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": r["device_name"], "count": r["count"],
              "memory_peak_bytes": r["peak_bytes"]}
    line = {"correct": correct, "attempted": r["attempted"],
            "failed": r["failed"], "metrics": metrics, "device": device}
    if trace:
        reading = {"calls": r["calls"], "trace": r["trace"],
                   "flow": cell.flow, "traffic": cell.traffic,
                   "config": cell.config}
        for m in cell.per_layer:
            mod = harness.load_module(
                harness.HERE / "metrics" / f"{m['name']}.py",
                "flowbench_metric_" + m["name"].replace(".", "_"))
            value = mod.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if r["trace"] is not None:
            device["busy_s"] = r["trace"]["device_busy_s"]
            device["window_s"] = r["trace"]["device_window_s"]
            line["breakdown"] = r["trace"]["breakdown"]
    else:
        values = dict(r["e2e"], setup_s=r["setup_end"] - T_START)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line["checks"] = checks
    marks = [("process start", T_START)] + r["setup_marks"]
    stages = ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s"
                       for a, b in zip(marks, marks[1:]))
    lines = [f"set-up: {stages}", *([r["note"]] if "note" in r else []),
             judged] + [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
                        for k, c in checks.items()]
    return line, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # set before NumPy and torch load: OpenMP takes its count then
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    from flowbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available():
        print("error: CUDA is not available; the benchmark runs only on "
              "the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        line, checks = execute(cell, args.seed, args.seconds,
                               bool(args.trace))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print("\n".join(checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

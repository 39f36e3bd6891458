"""The control of a cell's comparison: the reference one precision down.

    python3 -m flowbench.control --workload gen4hd.replay --seeds 1 2 3

For each seed, the cell's traffic is made as a run makes it, and the
plain reference in bfloat16 with a float32 integral (dense.LOWER) is put
in the program's place on the cell's own calls at their own sizes: the
stream's first call from the initial state and its second from the
full-precision reference's state after the first (as a window call
starts from the state before it), or the resident cell's whole stream.
The comparison that decides `correct` then reads the four numbers, one
JSON line per seed with the cell's limits beside them. Needs a card.
"""
from __future__ import annotations

import argparse
import json


def samples_of(cell, seed: int, device) -> tuple:
    """(samples, t0) of the control: the first call(s) of the cell's
    stream at their own sizes."""
    from flowbench import harness
    from flowbench.reference.dense import Reference, Semantics
    tr = cell.traffic
    if tr["driver"] == "resident":
        n = int(tr["stream_events"])
        pool = harness.make_pool(cell, seed, device, n_events=n)
        x, y, t, _ = pool.take(0, n)
        return [{"x": x, "y": y, "t": t, "prev": None}], int(t[0])
    size = int(tr.get("batch_events") or tr["call_events"])
    pool = harness.make_pool(cell, seed, device)
    first = pool.take(0, size)
    t0 = int(first[2][0])
    ref = Reference(Semantics.from_dict(cell.flow), device)
    ref.run(first[0], first[1], first[2], t0)
    second = pool.take(size, size)
    return [{"x": first[0], "y": first[1], "t": first[2], "prev": None},
            {"x": second[0], "y": second[1], "t": second[2],
             "prev": ref.state()}], t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    from flowbench import harness
    from flowbench.reference.compare import judge, lower_program
    from flowbench.reference.dense import LOWER
    if not torch.cuda.is_available():
        raise SystemExit("the control runs on the card")
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        samples, t0 = samples_of(cell, seed, dev)
        nums = judge(samples, cell.flow, t0, dev,
                     program=lower_program(cell.flow, t0, dev, LOWER))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": nums, "limits": cell.limits}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

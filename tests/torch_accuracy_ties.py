"""Where the port's accuracy rows differ from ACCURACY.json's, and why.

A tool of the tests, run by hand on the CPU (it imports JAX and both
packages; pytest does not collect it):

    JAX_PLATFORMS=cpu python tests/torch_accuracy_ties.py \
        [--torch ACCURACY_TORCH.json] [--rows bar:0 bar:11 random:0 ...]
    python tests/torch_accuracy_ties.py --table [--counts COUNTS.jsonl]

For each chosen row of the port's file (stream:index), it runs the row's
config through `farms_tpu`'s FlowEngine and the port's (plain versions)
on the CPU, on the accuracy sweep's stream, and prints one JSON line:
the port's CPU metrics that differ from the file's (measured on the
card), the
lanes whose validity flipped between the engines, and, of the lanes both
engines and the oracle hold valid, those whose scale ids differ between
the engines and how many of them are float64 ties of the per-scale mean
lengths (pipeline/ties.py on the port's aperture inputs), the largest
relative gap between the two scales' float64 means, how many of them
JAX's own aperture pooling (`farms_tpu.ops.dense_flow.dense_aperture`,
an f32 integral) picks JAX's scale on when it is given the surfaces the
port's pass read, and which engine matched the oracle's scale. `--table` prints instead the
markdown table of the port's rows beside ACCURACY.json's (validity
agreement, AEE, angular p95, scale match), with the counts of a
`--counts` file of such lines.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from farms_tpu.config import FlowConfig as JConfig  # noqa: E402
from farms_tpu.ops.dense_flow import dense_aperture  # noqa: E402
from farms_tpu.pipeline.engine import FlowEngine as JEngine  # noqa: E402
from farms_tpu_torch.bench import accuracy  # noqa: E402
from farms_tpu_torch.config import FlowConfig  # noqa: E402
from farms_tpu_torch.pipeline import engine as teng  # noqa: E402
from farms_tpu_torch.pipeline.ties import (aperture_passes,  # noqa: E402
                                            scale_means_f64, scale_ties)


def row_counts(kind: str, row: dict, ev, orc) -> dict:
    kw = dict(width=320, height=320, chunk_size=row["chunk_size"],
              steps_per_scan=8, sub_phases=row["sub_phases"],
              aperture_sub_phases=row["aperture_sub_phases"],
              causal_snapshots=row["causal_snapshots"],
              center_correction=row["correction"],
              correction_coarse_chain=row["coarse_chain"], wire="f16")
    passes = []
    aperture = teng.kernels.aperture

    surfaces = []

    def recording(flow_len, flow_vx, flow_vy, *a, **k):
        passes.append(flow_len.clone())
        surfaces.append((flow_len.clone(), flow_vx.clone(), flow_vy.clone()))
        return aperture(flow_len, flow_vx, flow_vy, *a, **k)

    teng.kernels.aperture = recording
    try:
        got = teng.FlowEngine(FlowConfig(**kw), device="cpu").process(ev)
    finally:
        teng.kernels.aperture = aperture
    want = JEngine(JConfig(**kw)).process(ev)
    ov = orc["r_local"] > 0
    vt, vj = got.r_local > 0, want.r_local > 0
    both = ov & vt & vj
    differ = both & (got.scale != want.scale)
    tied = differ & scale_ties(want, got, passes, FlowConfig(**kw))
    # the largest relative gap between the float64 mean lengths of the
    # two engines' scales, over the lanes where they differ
    m, n = kw["chunk_size"], aperture_passes(FlowConfig(**kw))
    lane = np.nonzero(differ)[0]
    pass_of = (lane // m) * n + (lane % m) // (m // n)
    gap = 0.0
    reproduced = 0
    for c in np.unique(pass_of):
        li = lane[pass_of == c]
        ml = scale_means_f64(passes[c], got.x[li], got.y[li],
                             FlowConfig(**kw))
        cols = np.arange(li.size)
        jump = FlowConfig(**kw).window_jump
        ma = ml[want.scale[li] // jump, cols]
        mb = ml[got.scale[li] // jump, cols]
        gap = max(gap, float((np.abs(mb - ma) / np.maximum(
            np.abs(mb), 1e-30)).max()))
        # JAX's own aperture pooling (f32 integral) on the surfaces the
        # port's pass read: the lanes where it picks JAX's engine's scale
        jscale = np.asarray(dense_aperture(
            *(jnp.asarray(t.numpy()) for t in surfaces[c]),
            JConfig(**kw))[2])
        reproduced += int((jscale[got.x[li], got.y[li]]
                           == want.scale[li]).sum())
    port_hit = differ & (got.scale == orc["scale"])
    jax_hit = differ & (want.scale == orc["scale"])
    cpu = accuracy.metrics(got, orc)
    return {
        "stream": kind,
        "row": {k: row[k] for k in ("chunk_size", "sub_phases",
                                    "aperture_sub_phases",
                                    "causal_snapshots", "correction",
                                    "coarse_chain")},
        "cpu_unlike_card": {k: [cpu[k], row[k]] for k in cpu
                            if cpu[k] != row[k]},
        "validity_flips": int((vt != vj).sum()),
        "compared": int(both.sum()),
        "scale_differs": int(differ.sum()),
        "scale_differs_tied": int(tied.sum()),
        "scale_differs_max_rel_gap": gap,
        "scale_differs_jax_aperture_reproduces": reproduced,
        "port_matches_oracle": int(port_hit.sum()),
        "jax_matches_oracle": int(jax_hit.sum()),
        "port_matches_oracle_tied": int((port_hit & tied).sum()),
        "jax_matches_oracle_tied": int((jax_hit & tied).sum()),
    }


def _key(r: dict) -> tuple:
    return (r["chunk_size"], r["sub_phases"], r["aperture_sub_phases"],
            r["causal_snapshots"], r.get("correction", 0),
            r.get("coarse_chain", False))


def table(torch_path: str, counts_path: str | None) -> None:
    """Markdown rows: the port's rows beside ACCURACY.json's."""
    with open(torch_path) as fh:
        port = json.load(fh)
    with open(os.path.join(REPO, "ACCURACY.json")) as fh:
        ref = json.load(fh)
    counts = {}
    if counts_path:
        with open(counts_path) as fh:
            for line in fh:
                if line.startswith("{"):     # skip the oracle's prints
                    c = json.loads(line)
                    counts[(c["stream"], _key(c["row"]))] = c
    print("| Stream | chunk / P / A / S / C, coarse | valid agreement, "
          "port (JAX) | AEE px/ms | ang p95 deg | scale match | lanes "
          "whose scale ids differ from JAX's on the CPU: of them ties, "
          "largest gap, reproduced by JAX's pooling on the port's "
          "surfaces; port / JAX = oracle; validity flips |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for kind, s in port["streams"].items():
        for a, b in zip(s["rows"], ref["streams"][kind]["rows"]):
            if _key(a) != _key(b):
                raise ValueError(f"row order: {_key(a)} against {_key(b)}")
            k = _key(a)
            c = counts.get((kind, k))
            said = ("not counted" if c is None else
                    f"{c['scale_differs']}: {c['scale_differs_tied']}, "
                    f"gap <= {c['scale_differs_max_rel_gap']:.0e}, "
                    f"{c['scale_differs_jax_aperture_reproduces']} by JAX's "
                    f"pooling; "
                    f"{c['port_matches_oracle']} / "
                    f"{c['jax_matches_oracle']}; flips "
                    f"{c['validity_flips']}")
            print(f"| {kind} | {k[0]} / {k[1]} / {k[2]} / {k[3]} / {k[4]}"
                  f"{', coarse' if k[5] else ''} | {a['valid_agreement']:.6f}"
                  f" ({b['valid_agreement']:.6f}) | "
                  f"{a['aee_true_px_per_ms']} ({b['aee_true_px_per_ms']}) | "
                  f"{a['ang_err_p95_deg']} ({b['ang_err_p95_deg']}) | "
                  f"{a['scale_match']:.4f} ({b['scale_match']:.4f}) | "
                  f"{said} |")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch", default=os.path.join(REPO,
                                                    "ACCURACY_TORCH.json"))
    ap.add_argument("--rows", nargs="+", default=["bar:0", "bar:11",
                                                  "random:0", "random:9"])
    ap.add_argument("--table", action="store_true",
                    help="print the comparison table and exit")
    ap.add_argument("--counts", help="this tool's JSON lines, for --table")
    args = ap.parse_args()
    if args.table:
        table(args.torch, args.counts)
        return 0
    torch.set_num_threads(os.cpu_count() or 1)
    with open(args.torch) as fh:
        res = json.load(fh)
    streams = {}
    for spec in args.rows:
        kind, i = spec.split(":")
        if kind not in streams:
            ev = accuracy.make_stream(kind, res["n_events"])
            streams[kind] = (ev, accuracy.oracle_cached(
                ev, FlowConfig(width=320, height=320), kind))
        ev, orc = streams[kind]
        row = res["streams"][kind]["rows"][int(i)]
        print(json.dumps(row_counts(kind, row, ev, orc)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

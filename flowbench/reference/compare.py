"""The comparison that decides a run's `correct`.

Each checked call is run again by the plain reference (dense.py) from the
state before it: the initial state for a run's first call, else the
whole-sensor state the program held there (the reference cannot replay
a whole window in less than the window's time). Four numbers are taken,
each the worst over the checked calls:

- `valid_flips`: the share of lanes whose validity (r_local > 0)
  differs;
- `scale_diffs`: the share of lanes, valid on both sides, whose scale
  differs;
- `flow_err`: the largest gap of vx and vy (every lane) and of r_true
  and theta_true (lanes valid on both sides at the same scale), over
  |reference| + 1 (px/s or rad); NaN against NaN is no gap, NaN against
  a number an infinite one;
- `state_diffs`: the share of pixels whose stamp or flow (length, vx,
  vy) after the call differs bit for bit from the reference's.

Because the state before a window call is the program's, its first call
(from the initial state) and the state after each call are checked too:
a program that drifts shows in the state that the reference computes
from the same start.
"""
from __future__ import annotations

import numpy as np

from flowbench.reference.dense import FULL, Reference, Semantics

NUMBERS = ("valid_flips", "scale_diffs", "flow_err", "state_diffs")


def _gap(p: np.ndarray, r: np.ndarray, angle: bool = False) -> float:
    p = p.astype(np.float64)
    r = r.astype(np.float64)
    if p.size == 0:
        return 0.0
    pn, rn = np.isnan(p), np.isnan(r)
    if np.any(pn != rn):
        return float("inf")
    d = np.abs(np.where(pn, 0.0, p - r))
    if angle:
        d = np.minimum(d, 2 * np.pi - d)
    return float(np.max(d / (np.abs(np.where(rn, 0.0, r)) + 1.0)))


def compare_columns(prog: dict, ref: dict) -> dict:
    n = ref["vx"].size
    if prog["vx"].size != n:
        return {"valid_flips": 1.0, "scale_diffs": 1.0,
                "flow_err": float("inf")}
    vp, vr = prog["r_local"] > 0, ref["r_local"] > 0
    both = vp & vr
    same = both & (prog["scale"] == ref["scale"])
    err = max(_gap(prog["vx"], ref["vx"]), _gap(prog["vy"], ref["vy"]),
              _gap(prog["r_true"][same], ref["r_true"][same]),
              _gap(prog["theta_true"][same], ref["theta_true"][same], True))
    return {"valid_flips": float(np.mean(vp != vr)),
            "scale_diffs": float(np.sum(both & ~same) / n),
            "flow_err": err}


def compare_states(prog: dict, ref: dict) -> float:
    diff = prog["t_surf"] != ref["t_surf"]
    for k in ("flow_len", "flow_vx", "flow_vy"):
        diff |= (prog[k].astype(np.float32).view(np.uint32)
                 != ref[k].astype(np.float32).view(np.uint32))
    return float(np.mean(diff))


def judge(samples: list, flow: dict, t0: int, device, prec=FULL,
          program=None) -> dict:
    """The four numbers over the checked calls. `program`, where given,
    replaces each sample's program columns and state after: a callable
    (sample) -> (columns, state) (the control puts the lower-precision
    reference there)."""
    sem = Semantics.from_dict(flow)
    out = dict.fromkeys(NUMBERS, 0.0)
    for s in samples:
        ref = Reference(sem, device, prec)
        if s["prev"] is not None:
            ref.set_state(**s["prev"])
        cols = ref.run(s["x"], s["y"], s["t"], t0)
        post = ref.state()
        del ref
        got_cols, got_post = (program(s) if program is not None
                              else (s["cols"], s["post"]))
        nums = compare_columns(got_cols, cols)
        nums["state_diffs"] = compare_states(got_post, post)
        for k, v in nums.items():
            out[k] = max(out[k], v)
    return out


def lower_program(flow: dict, t0: int, device, prec):
    """The control: the reference in lower precision, in the program's
    place, from the same state before each call."""
    sem = Semantics.from_dict(flow)

    def run(s):
        ref = Reference(sem, device, prec)
        if s["prev"] is not None:
            ref.set_state(**s["prev"])
        cols = ref.run(s["x"], s["y"], s["t"], t0)
        return cols, ref.state()

    return run

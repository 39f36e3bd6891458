"""Checkpoint / resume for streaming runs.

Reads and writes the version-3 `.npz` format of
`farms_tpu.pipeline.checkpoint`, so a state saved by either package resumes
in the other: the surface arrays at the semantic sensor geometry, the
micro-step counter and the stream's latched t0.

Checkpoints are engine-portable: the halo engine (parallel/halo.py) saves
its bands gathered to the whole sensor (`whole_state`; rank 0 writes) and
restores by giving each rank its band of the whole state (`set_state`), so
a single-engine checkpoint resumes on any number of ranks and the other
way round.
"""
from __future__ import annotations

import numpy as np

from farms_tpu_torch.parallel import mesh
from farms_tpu_torch.pipeline.engine import FlowEngine
from farms_tpu_torch.state.surfaces import state_from_numpy

FORMAT_VERSION = 3


def save_engine(engine: FlowEngine, path: str) -> str:
    """Write the engine's full state to an .npz file.

    Every rank of a halo engine calls it; it returns once the file is
    written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    state = engine.whole_state()
    if state is not None:
        np.savez_compressed(
            path,
            version=np.int32(FORMAT_VERSION),
            t_surf=state.t_surf.cpu().numpy(),
            epoch=state.epoch.cpu().numpy(),
            flow_len=state.flow_len.cpu().numpy(),
            flow_vx=state.flow_vx.cpu().numpy(),
            flow_vy=state.flow_vy.cpu().numpy(),
            step=np.int32(state.step),
            t0=np.uint32(engine._t0 if engine._t0 is not None else 0),
            has_t0=np.bool_(engine._t0 is not None),
        )
    mesh.barrier()
    return path


def load_engine(engine: FlowEngine, path: str) -> FlowEngine:
    """Restore a previously saved state into an engine (same sensor)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    cfg = engine.cfg
    with np.load(path) as data:
        version = int(data["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        shape = data["t_surf"].shape
        expect = (cfg.width, cfg.height)
        if shape != expect:
            raise ValueError(
                f"checkpoint geometry {shape} != config geometry {expect}")
        # Neutralize write-epoch history: epoch is only compared for
        # equality with a *future* write epoch (step * P + p). A restore
        # into an engine with a smaller sub_phases P shrinks the per-step
        # stride, so saved epochs could collide with future ones and mark
        # untouched pixels written. Mapping every historical epoch to a
        # sentinel (< -1, never a valid epoch) is exact: at a step boundary
        # no pixel was written by the current group.
        ep = data["epoch"]
        ep = np.where(ep >= 0, np.int32(-2), ep).astype(np.int32)
        state = state_from_numpy(
            data["t_surf"], ep, data["flow_len"], data["flow_vx"],
            data["flow_vy"], data["step"], engine.device)
        engine.set_state(state)
        engine._t0 = np.uint32(data["t0"]) if bool(data["has_t0"]) else None
    return engine

"""`correct` comes out false for the control and for each fault a cell
can have: a step that leaves its state unchanged, half of a batch left
out, the halo exchange between cards left out, an answer altered where
it is produced. The harness's look for a card is skipped; the rest of
the run is driven on the CPU at a tiny size."""
from __future__ import annotations

import pytest
import torch.nn.functional as F

from flowbench import control
from flowbench import run as bench_run
from flowbench.drivers import replay
from flowbench.reference.compare import judge, lower_program
from flowbench.reference.dense import LOWER

from conftest import tiny_cell

CELLS = ("gen4hd.replay", "davis240c.live", "gen4hd.resident")


def _run(cell):
    line, _ = bench_run.execute(cell, 2**31 + 21, 0.6, False, "cpu")
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_flowbench_sound_run_is_correct(cell):
    assert _run(tiny_cell(cell))["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_flowbench_control_is_not_correct(cell):
    """The reference in bfloat16 (its integral in float32), in the
    program's place on the cell's first calls, fails the cell's
    limits."""
    c = tiny_cell(cell)
    samples, t0 = control.samples_of(c, 2**31 + 5, "cpu")
    nums = judge(samples, c.flow, t0, "cpu",
                 program=lower_program(c.flow, t0, "cpu", LOWER))
    assert any(nums[k] > v for k, v in c.limits.items()), nums


@pytest.mark.parametrize("cell", CELLS)
def test_flowbench_state_left_unchanged_is_not_correct(cell, monkeypatch):
    from farms_tpu_torch.pipeline import engine as E

    def stuck(self, chunk):
        _, out = E.scan_chunk(self.state, chunk, self.cfg)
        return out

    monkeypatch.setattr(E.FlowEngine, "_run_call", stuck)
    assert not _run(tiny_cell(cell))["correct"]


@pytest.mark.parametrize("cell", ("gen4hd.replay", "davis240c.live"))
def test_flowbench_half_batch_left_out_is_not_correct(cell, monkeypatch):
    from farms_tpu_torch.events.io import FlowOutput
    from farms_tpu_torch.pipeline import engine as E
    orig = E.FlowEngine.process

    def half(self, ev, steps_per_call=None):
        out = orig(self, ev[:len(ev) // 2])
        return FlowOutput.concatenate([out, out])

    monkeypatch.setattr(E.FlowEngine, "process", half)
    assert not _run(tiny_cell(cell))["correct"]


def test_flowbench_half_stream_left_out_is_not_correct(monkeypatch):
    """The resident replay runs only the first half of its steps."""
    from farms_tpu_torch.pipeline import engine as E
    orig = E.scan_chunk

    def half(state, chunk, cfg, lanes=None):
        n = chunk["ev"].shape[0]
        st, (main, aux) = orig(state, {k: v[:n // 2] for k, v in
                                       chunk.items()}, cfg, lanes)
        return st, (main.repeat(2, 1, 1), aux.repeat(2, 1))

    monkeypatch.setattr(E, "scan_chunk", half)
    assert not _run(tiny_cell("gen4hd.resident"))["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_flowbench_altered_answer_is_not_correct(cell, monkeypatch):
    """One valid lane's vx negated in the wire block a call produces."""
    from farms_tpu_torch.pipeline import engine as E
    orig = E.FlowEngine._run_call

    def altered(self, chunk):
        main, aux = orig(self, chunk)
        valid = (aux.reshape(-1) & 0x80).nonzero()
        if len(valid):
            main = main.clone()
            i = int(valid[len(valid) // 2, 0])
            step, lane = divmod(i, main.shape[2])
            main[step, 0, lane] ^= 0x8000               # the f16 sign
        return main, aux

    monkeypatch.setattr(E.FlowEngine, "_run_call", altered)
    assert not _run(tiny_cell(cell))["correct"]


def _no_exchange_rank(cell, seed, seconds, trace, device_type):
    """A rank of the replay driver whose halo exchange returns zero rows
    in place of its neighbours' (as past the sensor's edge)."""
    from farms_tpu_torch.parallel import halo

    def alone(arr, h, band, below=None, dim=-2):
        pad = [0, 0] * (-dim - 1) + [h, h]
        return F.pad(arr, pad)

    halo.exchange_halo = alone
    return replay._rank(cell, seed, seconds, trace, device_type)


def test_flowbench_exchange_left_out_is_not_correct(monkeypatch):
    from farms_tpu_torch.parallel import mesh
    cell = tiny_cell("gen4hd-halo4.replay")
    cell.config["devices"] = 2
    assert _run(cell)["correct"]

    def faulty(c, seed, seconds, trace, device_type):
        return mesh.run(_no_exchange_rank, 2, device_type, c, seed,
                        seconds, trace, device_type)

    monkeypatch.setattr(replay, "run", faulty)
    assert not _run(cell)["correct"]

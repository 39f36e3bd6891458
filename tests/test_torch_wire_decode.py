"""The wire decoded into the output columns: ops/kernels.decode_wire, on
the card on a CUDA engine (the decode_wire kernel of csrc/wire.cu), with
its plain version decode_wire_columns (ops/dense_flow.py) on a CPU
engine.

On the CPU:
- a CPU engine decodes each call through decode_wire_columns, its outputs
  bitwise the host decode of the whole stream's wire concatenated, as the
  port decoded before the card path;
- the bookkeeping of that per-call decode (each call's lanes at its
  offset, the tails of padded calls, the sparse wire's re-expanded
  blocks, the blocks of process_resident and the one-rank halo engine,
  the multihost writer's held lanes), bitwise the whole-wire decode;
- the lane counters, and the benchmark's readers of them.

On the card (marked `cuda`; they skip without one; no JAX): the kernel
against decode_wire_columns on adversarial wires, one launch a call in
process(), and its time against its bytes bound.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from farms_tpu_torch.config import FlowConfig
from farms_tpu_torch.events.io import FlowOutput, synthetic_rotating_shapes
from farms_tpu_torch.ops import kernels as tk
from farms_tpu_torch.pipeline import engine as engmod
from farms_tpu_torch.pipeline.engine import FlowEngine, decode_wire_columns
from farms_tpu_torch.utils import tracing
from flowbench import harness

torch.set_num_threads(1)

COLUMNS = ("x", "y", "t", "pol", "r_true", "theta_true", "vx", "vy",
           "r_local", "theta_local", "scale")

_BENCH = dict(width=64, height=64, chunk_size=256, sub_phases=2,
              wire="f16")
_FIDELITY = dict(width=64, height=64, chunk_size=256, sub_phases=2,
                 aperture_sub_phases=2, causal_snapshots=4,
                 center_correction=64, correction_coarse_chain=True,
                 wire="f16")
_PRESETS = {"benchmark": _BENCH, "fidelity": _FIDELITY}

# atan2f's largest error in the CUDA Math API's table of single-precision
# functions, in ulps of the exact result
ATAN2F_ULP = 3


@pytest.fixture(scope="module")
def stream():
    """700 events of a rotating scene: at 256 lanes a call, three calls,
    the last one padded."""
    ev = synthetic_rotating_shapes(width=64, height=64,
                                   duration_us=100_000)[:700]
    assert 512 < len(ev) < 768
    return ev


@pytest.fixture(autouse=True)
def clean_totals():
    tracing.reset()
    yield
    tracing.reset()


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for col in COLUMNS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col


def _host_decode(blocks, ev, n, cfg, t0):
    """The host decode of dense wire blocks as FlowEngine._unpack_outputs
    did it before the card path: the blocks concatenated, then
    decode_wire_columns."""
    C = engmod.wire_n_main_rows(cfg)
    main = np.concatenate([mo.transpose(1, 0, 2).reshape(C, -1)
                           for mo, _ in blocks], axis=1)[:, :n]
    aux = np.concatenate([ao.reshape(-1) for _, ao in blocks])[:n]
    return FlowOutput(x=ev.x.astype(np.int32), y=ev.y.astype(np.int32),
                      t=(ev.t.astype(np.uint32) - t0).astype(np.uint32),
                      pol=ev.pol.astype(np.int32),
                      **decode_wire_columns(main, aux, cfg))


def _traced(fn):
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        return fn()


# ---- on the CPU ------------------------------------------------------------

def _recording(monkeypatch, cls, name):
    """Wrap cls.name, a call's run that returns its wire (main, aux), to
    keep a host copy of every wire it returns; returns that list."""
    wires = []
    real = getattr(cls, name)

    def run(self, *args):
        main, aux = real(self, *args)
        wires.append((main.numpy().copy(), aux.numpy().copy()))
        return main, aux

    monkeypatch.setattr(cls, name, run)
    return wires


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_cpu_engine_decodes_through_decode_wire_columns(monkeypatch, stream,
                                                        preset):
    cfg = FlowConfig(**_PRESETS[preset])
    eng = FlowEngine(cfg, device="cpu")
    decoded = []
    real = tk.decode_wire_columns

    def counting(main, aux, c):
        decoded.append(aux.size)
        return real(main, aux, c)

    monkeypatch.setattr(tk, "decode_wire_columns", counting)
    wires = _recording(monkeypatch, FlowEngine, "_run_call")
    tk.reset_launches()
    out = eng.process(stream, steps_per_call=1)
    # one decode a call, the last call's real lanes only
    assert decoded == [256, 256, len(stream) - 512] and len(wires) == 3
    assert tk.LAUNCHES["decode_wire"] == 0
    _assert_bitwise(out, _host_decode(wires, stream, len(stream), cfg,
                                      eng._t0))


def _resident(cfg, ev):
    eng = FlowEngine(cfg, device="cpu")
    fn, n = eng.process_resident(ev)
    main, aux = fn()
    wire = [(main.numpy().copy(), aux.numpy().copy())]
    return eng._unpack_outputs([(main, aux)], ev, n), wire, eng


@pytest.mark.parametrize("case", ["f16", "f16 two steps a call", "f32",
                                  "sparse", "fidelity", "resident",
                                  "halo one rank"])
def test_card_path_bookkeeping_on_cpu_tensors(monkeypatch, stream, case):
    """The per-call decode (decode_wire into a [7, n] block at each call's
    offset, the call's lanes copied out), as every engine runs it, gives
    the host decode of the whole wire bit for bit, tails of padded calls,
    the sparse wire's re-expanded blocks and the resident and halo blocks
    included; every lane counted once, none on a card."""
    from farms_tpu_torch.parallel.halo import HaloFlowEngine

    cfg = FlowConfig(**(_FIDELITY if case == "fidelity" else _BENCH))
    if case in ("f32", "sparse"):
        cfg = FlowConfig(**{**_BENCH, "wire": case})
    tk.reset_launches()
    if case == "resident":
        got, wires, eng = _traced(lambda: _resident(cfg, stream))
    else:
        halo = case == "halo one rank"
        wires = _recording(monkeypatch, HaloFlowEngine if halo else
                           FlowEngine, "_run_halo_call" if halo else
                           "_run_call")
        eng = (HaloFlowEngine if halo else FlowEngine)(cfg, device="cpu")
        spc = 2 if case == "f16 two steps a call" else 1
        got = _traced(lambda: eng.process(stream, spc))
    # the sparse wire decodes as the f16 wire it compacts
    wire_cfg = FlowConfig(**{**_BENCH, "wire": "f16"}) if (
        case == "sparse") else cfg
    _assert_bitwise(got, _host_decode(wires, stream, len(stream), wire_cfg,
                                      eng._t0))
    counters = tracing.totals()["counters"]
    assert counters["engine.decoded_lanes"] == len(stream)
    assert counters.get("engine.device_decoded_lanes", 0) == 0
    assert tk.LAUNCHES["decode_wire"] == 0      # plain versions count none


def test_multihost_writer_card_path_on_cpu_tensors(stream, tmp_path):
    """MultiHostFlowEngine.write_flow_distributed on one rank decodes its
    held lanes as process() does: the single engine's file byte for
    byte, every lane counted once."""
    from farms_tpu_torch.events.io import write_flow_txt
    from farms_tpu_torch.parallel import MultiHostFlowEngine

    cfg = FlowConfig(**_BENCH)
    want = write_flow_txt(FlowEngine(cfg, device="cpu").process(stream),
                          str(tmp_path / "single"))
    got = _traced(lambda: MultiHostFlowEngine(
        cfg, device="cpu").write_flow_distributed(stream,
                                                  str(tmp_path / "held")))
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    counters = tracing.totals()["counters"]
    assert counters["engine.decoded_lanes"] == len(stream)
    assert counters.get("engine.device_decoded_lanes", 0) == 0


def test_decode_counters_count_the_lanes(stream):
    """Every decoded lane counts in engine.decoded_lanes, once, across
    process() calls and call sizes; on the CPU none in
    engine.device_decoded_lanes."""
    cfg = FlowConfig(**_BENCH)
    eng = FlowEngine(cfg, device="cpu")
    _traced(lambda: eng.process(stream, 1))
    counters = tracing.totals()["counters"]
    assert counters["engine.decoded_lanes"] == len(stream)
    assert counters.get("engine.device_decoded_lanes", 0) == 0
    _traced(lambda: eng.process(stream[:300], 2))
    counters = tracing.totals()["counters"]
    assert counters["engine.decoded_lanes"] == len(stream) + 300
    assert counters.get("engine.device_decoded_lanes", 0) == 0


def _random_wire(rng, steps, k, C):
    """A wire of random bits with every aux byte: int32 [steps, C, k],
    uint8 [steps, k]."""
    main = rng.integers(0, 2**32, (steps, C, k), dtype=np.uint64)
    aux = rng.integers(0, 256, (steps, k), dtype=np.uint8)
    return main.astype(np.uint32).view(np.int32), aux


@pytest.mark.parametrize("C", [2, 4])
def test_decode_wire_plain_version_on_cpu_tensors(C):
    """ops/kernels.decode_wire on CPU tensors: lanes 0 .. count - 1 of the
    wire, in step order, at columns offset .. of the block; the other
    columns untouched; no launch counted."""
    rng = np.random.default_rng(C)
    main, aux = _random_wire(rng, 3, 10, C)
    cfg = FlowConfig(wire="f32" if C == 4 else "f16", window_jump=7)
    want = decode_wire_columns(main.transpose(1, 0, 2).reshape(C, -1)[:, :25],
                               aux.reshape(-1)[:25], cfg)
    out = torch.full((7, 40), -1.0)
    tk.reset_launches()
    tk.decode_wire(torch.from_numpy(main), torch.from_numpy(aux), out, 6, 25,
                   7)
    got = out.numpy()
    assert tk.LAUNCHES["decode_wire"] == 0
    assert (got[:, :6] == -1).all() and (got[:, 31:] == -1).all()
    for r, name in enumerate(tk.WIRE_COLUMNS):
        assert got[r, 6:31].tobytes() == want[name].tobytes(), name


def test_decode_wire_rejects_bad_input():
    main = torch.zeros((2, 2, 8), dtype=torch.int32)
    aux = torch.zeros((2, 8), dtype=torch.uint8)
    out = torch.zeros((7, 16))
    for bad in (lambda: tk.decode_wire(main[:, :1].contiguous(), aux, out, 0,
                                       4, 5),
                lambda: tk.decode_wire(main.float(), aux, out, 0, 4, 5),
                lambda: tk.decode_wire(main, aux[:, :4], out, 0, 4, 5),
                lambda: tk.decode_wire(main, aux, out[:6], 0, 4, 5),
                lambda: tk.decode_wire(main, aux, out, 0, 17, 5),
                lambda: tk.decode_wire(main, aux, out, 10, 8, 5),
                lambda: tk.decode_wire(main, aux, out, -1, 4, 5)):
        with pytest.raises(ValueError):
            bad()


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "flowbench_metric_" + name.replace(".", "_"))


def _reading(traced):
    calls = [{"events": 131072, "traced": i < traced, "due": None,
              "start": 0.0, "end": 0.0} for i in range(traced + 2)]
    return {"calls": calls, "trace": None, "flow": {}, "traffic": {},
            "config": {}}


@pytest.mark.parametrize("name,counters,want", [
    ("device_decode_pct", {"engine.decoded_lanes": 1048576,
                           "engine.device_decoded_lanes": 1048576}, 100.0),
    ("device_decode_pct.live", {"engine.decoded_lanes": 4000,
                                "engine.device_decoded_lanes": 1000}, 25.0),
    ("device_decode_pct", {"engine.decoded_lanes": 4000}, 0.0),
    # a program that counts calls but no decoded lane (the parent)
    ("device_decode_pct.live", {"engine.calls": 8}, None),
])
def test_device_decode_readers_read_the_totals(monkeypatch, name, counters,
                                               want):
    monkeypatch.setattr(tracing, "_spans", {"engine.decode": [1, 0.5]})
    monkeypatch.setattr(tracing, "_counters", dict(counters))
    got = _reader(name).read(_reading(4))
    assert got == pytest.approx(want) if want is not None else got is None
    assert _reader(name).read(_reading(0)) is None   # no traced call


@pytest.mark.parametrize("name", ["device_decode_pct",
                                  "device_decode_pct.live"])
def test_device_decode_readers_give_none_without_totals(name):
    assert _reader(name).read(_reading(4)) is None


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _components(main, C):
    """The f32 flow components vx, vy, tvx, tvy of a wire's main rows
    [C, k], widened as decode_wire_columns widens them."""
    if C == 4:
        return [main[r].view(np.float32) for r in range(4)]
    u = main.view(np.uint32)
    return [(u[r // 2] >> (16 * (r % 2)) & 0xFFFF).astype(np.uint16)
            .view(np.float16).astype(np.float32) for r in range(4)]


def _assert_theta(got, want, y, x, where):
    """got within ATAN2F_ULP ulps of atan2(y, x) taken in float64, with
    want's NaNs and signed zeros, on `where`; bitwise want elsewhere."""
    assert got[~where].tobytes() == want[~where].tobytes()
    got, want = got[where], want[where]
    with np.errstate(invalid="ignore"):       # signalling NaNs widen
        ref = np.arctan2(y[where].astype(np.float64),
                         x[where].astype(np.float64))
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    got, want, ref = got[~nan], want[~nan], ref[~nan]
    assert (np.signbit(got) == np.signbit(want)).all()
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    err = np.abs(got.astype(np.float64) - ref) / ulp
    assert err.max(initial=0) <= ATAN2F_ULP, err.max()


def _block_columns(block):
    """decode_wire_columns' dict of a decode_wire block's rows."""
    return {name: block[r].view(np.int32) if name == "scale" else block[r]
            for r, name in enumerate(tk.WIRE_COLUMNS)}


def _assert_magnitude(got, want, x, y, where):
    """Bit for bit want on `where`, but where both components are NaN: there
    the quieted NaN of one of them (IEEE 754 leaves the choice open, and
    NumPy's builds differ in it); 0 elsewhere."""
    both = np.isnan(x) & np.isnan(y) & where
    assert got[~both].tobytes() == want[~both].tobytes()
    bits = got[both].view(np.uint32)
    quiet = [a[both].view(np.uint32) | np.uint32(0x00400000) for a in (x, y)]
    assert ((bits == quiet[0]) | (bits == quiet[1])).all()


def _assert_decoded(got: dict, want: dict, main, aux, C):
    """vx, vy and scale bit for bit; r_true and r_local too, but for the
    choice of NaN where both components are NaN; theta_true and, on valid
    lanes, theta_local within atan2f's bound (theta_local 0 on the
    others)."""
    for col in ("vx", "vy", "scale", "r_true", "r_local"):
        assert got[col].dtype == want[col].dtype, col
    for col in ("vx", "vy", "scale"):
        assert got[col].tobytes() == want[col].tobytes(), col
    vx, vy, tvx, tvy = _components(main, C)
    everywhere = np.ones(len(vx), bool)
    valid = (aux & 0x80) != 0
    _assert_magnitude(got["r_true"], want["r_true"], tvx, tvy, everywhere)
    _assert_magnitude(got["r_local"], want["r_local"], vx, vy, valid)
    _assert_theta(got["theta_true"], want["theta_true"], tvy, tvx,
                  everywhere)
    _assert_theta(got["theta_local"], want["theta_local"], vy, vx, valid)


def _adversarial(rng, steps, k, C):
    """A wire whose components take every f16 half (NaN, +-Inf, +-0 and
    subnormals among them) or f32 specials among random bits, with every
    aux byte."""
    n = steps * k
    if C == 2:
        h = rng.permutation(np.tile(np.arange(65536, dtype=np.uint32),
                                    -(-4 * n // 65536)))[:4 * n]
        h = h.reshape(4, n)
        words = np.stack([h[0] | h[1] << 16, h[2] | h[3] << 16])
    else:
        words = rng.integers(0, 2**32, (4, n),
                             dtype=np.uint64).astype(np.uint32)
        special = np.array([0, 0x80000000, 0x7F800000, 0xFF800000,
                            0x7FC00000, 0xFFC00001, 0x7F800001, 1,
                            0x80000001, 0x3F800000, 0x00800000],
                           np.uint32)
        pick = rng.random(words.shape) < 0.4
        words[pick] = special[rng.integers(0, special.size, pick.sum())]
    main = np.ascontiguousarray(
        words.view(np.int32).reshape(C, steps, k).transpose(1, 0, 2))
    aux = np.tile(np.arange(256, dtype=np.uint8), -(-n // 256))[:n]
    return main, rng.permutation(aux).reshape(steps, k)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 4])
def test_cuda_decode_wire_matches_decode_wire_columns(cuda, C):
    """Adversarial wires, f16 and f32: whole wires and call tails (count <
    steps x k), lengths off the vector width, offsets and strides that take
    the four-lane path and the lane path."""
    rng = np.random.default_rng(10 + C)
    cfg = FlowConfig(wire="f32" if C == 4 else "f16", window_jump=5)
    for steps, k in ((1, 262144), (3, 4096), (2, 1001), (5, 7), (1, 1)):
        main, aux = _adversarial(rng, steps, k, C)
        dm, da = (torch.from_numpy(a).to(cuda) for a in (main, aux))
        flat = main.transpose(1, 0, 2).reshape(C, -1)
        n = steps * k
        for count in sorted({n, max(1, n - 1), max(1, n - 5), n // 2 + 1}):
            for offset, pad in ((0, 0), (4, 8), (3, 2)):
                out = torch.full((7, offset + count + pad), float("nan"),
                                 device=cuda)
                tk.reset_launches()
                tk.decode_wire(dm, da, out, offset, count, 5)
                assert tk.LAUNCHES["decode_wire"] == 1
                host = out.cpu().numpy()
                assert np.isnan(host[:, :offset]).all()
                assert np.isnan(host[:, offset + count:]).all()
                block = host[:, offset:offset + count].copy()
                got = _block_columns(block)
                want = decode_wire_columns(flat[:, :count],
                                           aux.reshape(-1)[:count], cfg)
                _assert_decoded(got, want, flat[:, :count],
                                aux.reshape(-1)[:count], C)


@pytest.mark.cuda
def test_cuda_process_decodes_once_a_call_on_the_card(cuda, stream):
    """process() on the card: one decode_wire launch a call, every lane
    counted as decoded on the card, and its columns the host decode's of
    the same wire (process_resident's, from the same state)."""
    cfg = FlowConfig(**_BENCH)
    calls = -(-len(stream) // cfg.chunk_size)
    tk.reset_launches()
    out = _traced(lambda: FlowEngine(cfg, device=cuda).process(stream, 1))
    assert tk.LAUNCHES["decode_wire"] == calls
    counters = tracing.totals()["counters"]
    assert counters["engine.decoded_lanes"] == len(stream)
    assert counters["engine.device_decoded_lanes"] == len(stream)
    fn, n = FlowEngine(cfg, device=cuda).process_resident(stream)
    main, aux = (t.cpu().numpy() for t in fn())
    flat = main.transpose(1, 0, 2).reshape(2, -1)[:, :n]
    want = decode_wire_columns(flat, aux.reshape(-1)[:n], cfg)
    assert (want["r_local"] > 0).sum() > 100
    _assert_decoded({c: getattr(out, c) for c in want}, want, flat,
                    aux.reshape(-1)[:n], 2)


@pytest.mark.cuda
def test_cuda_decode_wire_time_against_its_bytes_bound(cuda):
    """1,048,576 lanes of the f16 wire: the kernel's device time (the
    profiler's median over the 20-30 launches it records of 30, the L2
    cache flushed by a read before each) against 37 bytes a lane at 3.35
    TB/s; at least half the bound's rate. A timing assert: an H100 SXM
    reads 66-68 % here (PERF.md's kernel table)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    n = 1 << 20
    rng = np.random.default_rng(3)
    main, aux = _adversarial(rng, 8, n // 8, 2)
    dm, da = (torch.from_numpy(a).to(cuda) for a in (main, aux))
    out = torch.empty((7, n), device=cuda)
    # read, not written: the flush leaves no dirty line for the kernel to
    # write back
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=cuda)
    for _ in range(5):
        tk.decode_wire(dm, da, out, 0, n, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(30):
            flush.max()
            tk.decode_wire(dm, da, out, 0, n, 5)
        torch.cuda.synchronize()
    us = [e.self_device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and "decode_wire" in e.name]
    # the profiler may drop an event of a burst: most are enough
    assert 20 <= len(us) <= 30
    us = float(np.median(us))
    bound_us = 37 * n / 3.35e12 * 1e6
    print(f"decode_wire {n} lanes: {us:.2f} us a launch, bound "
          f"{bound_us:.2f} us, share {100 * bound_us / us:.1f} % on "
          f"{torch.cuda.get_device_name(cuda)}")
    assert bound_us / us >= 0.5

"""The one-launch integral kernel's schedule (csrc/aperture.cu), played on
the CPU.

The kernel cannot run here, so its schedule is mirrored by a model that
reads the kernel's constants from the source: the strip and band widths,
the fold steps of a ring slot, the ring's depth, the producer and storer
warps and the block's warps. Each block takes a ticket as it starts
(tickets below the strip count make column blocks, the rest row blocks);
only as many blocks run at once as fit the SMs, and each block's warps
(two producers, each filling half of every slot; the fold warp; two
storers, each emptying half) move one half slot at a time in a seeded
random interleaving, each at its own seeded speed, through mbarrier
phases as the kernel uses them (a wait on parity p passes once the phase
of parity p has completed; full and empty take both producers' or both
storers' arrivals). A column block's storers add one to the stream
slot's strips-done counter after their last stores; a row block's
producers start once the counter reaches the call's strip count. Each
row block counts itself finished as it ends, and the last row block of
a call sets the slot's three counters back to 0.

Asserted: no half slot is refilled before its fold has read it and its
storer has taken it; no row block copies a column sum its strip has not
stored and counted in this call (two calls run in turn on one stream
slot, then the second again with the same arguments, as a CUDA graph
replays a captured launch); every call leaves the counters at 0; the
grid finishes on 4, 132 and 1000 SMs; and the values folded in the
kernel's order equal `build_integral` bit for bit on fields whose
float64 sums round.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import farms_tpu_torch
from farms_tpu_torch.ops import dense_flow as tdf

torch.set_num_threads(1)

_SRC = (Path(farms_tpu_torch.__file__).parent / "csrc" /
        "aperture.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


STRIP, BAND, STEPS = _const("STRIP"), _const("BAND"), _const("STEPS")
SLOTS, RAW, ROLE_WARPS = _const("SLOTS"), _const("RAW"), _const("ROLE_WARPS")
PRODUCERS, STORERS = _const("PRODUCERS"), _const("STORERS")
FIELDS, LANES = _const("FIELDS"), _const("LANES")
HALF = STEPS // 2
PITCH = STEPS + 2
SMS = (132, 4, 1000)    # an H100's SMs; few (blocks wait for a place); many
SMEM_PER_SM = 233472    # an H100 SM's shared memory for blocks, bytes
# shared bytes of a block: the ring, the column inputs, 3 x SLOTS
# mbarriers and the role
BLOCK_SMEM = (SLOTS * LANES * PITCH * 8 + PRODUCERS * RAW * 3 * HALF * STRIP
              * 4 + 3 * SLOTS * 8 + 8)


class Barrier:
    """An mbarrier whose phase completes after `count` warp arrivals."""

    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def passed(self, parity):
        return (self.phase & 1) != parity

    def arrive(self):
        self.pending -= 1
        if not self.pending:
            self.phase += 1
            self.pending = self.count


def parity(k):
    """round_parity: the parity of the round of slot uses use k is in."""
    return (k // SLOTS) & 1


class Call:
    """One farms_integral call on a stream slot: its grid and buffers
    (`launch` clears them for a launch with the same arguments)."""

    def __init__(self, fields, stream):
        self.rows, self.cols = fields[0].shape
        self.fields = fields
        self.stream = stream
        self.n_strips = (self.cols + STRIP) // STRIP
        self.n_bands = -(-self.rows // BAND)
        self.n_blocks = self.n_strips + self.n_bands
        self.launch()

    def launch(self):
        L = self.cols + 1
        self.integ = np.full((FIELDS, self.rows + 1, L), np.nan)
        self.stored = np.zeros((self.rows + 1, L), bool)   # column sums


def _slot():
    """A stream slot's counters: tickets, strips done, row blocks done."""
    return {"tickets": 0, "done": 0, "exits": 0}


def _finished(call, ticket):
    """A block's end: a row block counts itself, and the last row block
    of the call resets the slot's counters."""
    if ticket < call.n_strips:
        return
    call.stream["exits"] += 1
    if call.stream["exits"] == call.n_bands:
        call.stream.update(_slot())


def _shared():
    """A block's ring: each slot [fold lane, fold step], the state of
    each of its halves, and the barriers with the kernel's counts."""
    return {"ring": [np.full((LANES, STEPS), np.nan) for _ in range(SLOTS)],
            "state": [["empty", "empty"] for _ in range(SLOTS)],
            "full": [Barrier(PRODUCERS) for _ in range(SLOTS)],
            "done": [Barrier(1) for _ in range(SLOTS)],
            "empty": [Barrier(STORERS) for _ in range(SLOTS)]}


def _fold(sh, n):
    """The fold warp over n slots, half a slot a step, each lane's chain
    carried across slots, each sum stored in place of its value."""
    acc = np.zeros(LANES)
    for k in range(n):
        s = k % SLOTS
        yield lambda: sh["full"][s].passed(parity(k))
        for w in range(2):
            assert sh["state"][s][w] == "full", ("fold", k, w)
            t = sh["ring"][s]
            for u in range(w * HALF, (w + 1) * HALF):
                acc = acc + t[:, u]
                t[:, u] = acc
            sh["state"][s][w] = "folded"
            if w == 0:
                yield lambda: True
        sh["done"][s].arrive()


def _column_block(call, strip, sh):
    """The warps of column block `strip` as generators; each yields a
    wait condition (a callable) before every step."""
    rows, cols = call.rows, call.cols
    n_chunks = -(-rows // STEPS)
    j = strip * STRIP + np.arange(STRIP)          # integral columns
    col_ok = (j >= 1) & (j <= cols)
    fl, fvx, fvy = call.fields
    stored_halves = [0]

    def producer(w):
        for k in range(n_chunks):
            s = k % SLOTS
            yield lambda: sh["empty"][s].passed(parity(k) ^ 1)
            assert sh["state"][s][w] == "empty", ("refilled", strip, k, w)
            i = k * STEPS + w * HALF + np.arange(HALF)      # input rows
            ok = (i < rows)[:, None] & col_ok[None, :]
            ii, jj = np.clip(i, 0, rows - 1), np.clip(j - 1, 0, cols - 1)
            take = (lambda a: np.where(ok, a[ii][:, jj], np.float32(0)))
            length = take(fl)
            gate = (length > 0).astype(np.float32)
            vals = [gate, length * gate, take(fvx) * gate, take(fvy) * gate]
            sh["ring"][s][:, w * HALF:(w + 1) * HALF] = np.concatenate(
                [v.astype(np.float64) for v in vals], 1).T   # [lane, step]
            sh["state"][s][w] = "full"
            sh["full"][s].arrive()

    def storer(w):
        ok = j <= cols
        if w == 0:
            call.integ[:, 0, j[ok]] = 0.0              # the zero row
            call.stored[0, j[ok]] = True
        for k in range(n_chunks):
            s = k % SLOTS
            yield lambda: sh["done"][s].passed(parity(k))
            assert sh["state"][s][w] == "folded", ("store", strip, k, w)
            half = sh["ring"][s][:, w * HALF:(w + 1) * HALF].copy()
            sh["state"][s][w] = "empty"
            sh["empty"][s].arrive()                    # the half in registers
            i0 = k * STEPS + w * HALF
            n = max(0, min(HALF, rows - i0))
            rr = 1 + i0 + np.arange(n)
            t = half.reshape(FIELDS, STRIP, HALF)
            for f in range(FIELDS):
                call.integ[f][np.ix_(rr, j[ok])] = t[f][ok][:, :n].T
            call.stored[np.ix_(rr, j[ok])] = True
        stored_halves[0] += 1
        yield lambda: stored_halves[0] == STORERS      # the storers' barrier
        if w == 0:
            call.stream["done"] += 1                   # the release

    return ([producer(w) for w in range(PRODUCERS)] + [_fold(sh, n_chunks)]
            + [storer(w) for w in range(STORERS)])


def _row_block(call, band, sh):
    rows, cols = call.rows, call.cols
    i0 = 1 + band * BAND
    n_tiles = -(-cols // STEPS)
    q = i0 + np.arange(LANES) % BAND                # each fold lane's row
    f_of = np.arange(LANES) // BAND
    row_ok = q <= rows

    def producer(w):
        yield lambda: call.stream["done"] >= call.n_strips
        lanes = np.arange(w * HALF, (w + 1) * HALF)
        for t in range(n_tiles):
            s = t % SLOTS
            yield lambda: sh["empty"][s].passed(parity(t) ^ 1)
            assert sh["state"][s][w] == "empty", ("refilled", band, t, w)
            j = 1 + t * STEPS + np.arange(STEPS)
            jv = j <= cols
            ok = row_ok[lanes][:, None] & jv[None, :]    # [lane, step]
            jj, qq = np.clip(j, 0, cols), np.clip(q[lanes], 0, rows)
            # every column sum copied is stored, and counted this call
            assert call.stream["done"] >= call.n_strips
            assert call.stored[np.ix_(qq[row_ok[lanes]], jj[jv])].all()
            vals = call.integ[f_of[lanes][:, None], qq[:, None], jj[None, :]]
            sh["ring"][s][lanes] = np.where(ok, vals, 0.0)
            sh["state"][s][w] = "full"
            sh["full"][s].arrive()

    def storer(w):
        lanes = np.arange(w * HALF, (w + 1) * HALF)
        for t in range(n_tiles):
            s = t % SLOTS
            yield lambda: sh["done"][s].passed(parity(t))
            assert sh["state"][s][w] == "folded", ("store", band, t, w)
            half = sh["ring"][s][lanes].copy()
            sh["state"][s][w] = "empty"
            sh["empty"][s].arrive()
            j = 1 + t * STEPS + np.arange(STEPS)
            jv = j <= cols
            for x, lane in enumerate(lanes):
                if row_ok[lane]:
                    call.integ[f_of[lane], q[lane], j[jv]] = half[x, jv]

    return ([producer(w) for w in range(PRODUCERS)] + [_fold(sh, n_tiles)]
            + [storer(w) for w in range(STORERS)])


def play(call, n_sm, rng):
    """Runs the grid: blocks start (taking tickets) while they fit the
    SMs; every round, each live warp whose wait has passed moves up to
    its speed in steps, in a shuffled order. Fails on a deadlock."""
    per_sm = min(SMEM_PER_SM // (BLOCK_SMEM + 1024), 2048 // (ROLE_WARPS * 32))
    capacity = n_sm * max(1, per_sm)
    live = []                   # [generator, pending wait, speed, block]
    running = {}
    started = 0
    while started < call.n_blocks or live:
        while started < call.n_blocks and len(running) < capacity:
            ticket = call.stream["tickets"]
            call.stream["tickets"] += 1
            assert ticket < call.n_blocks          # the kernel's trap
            started += 1
            sh = _shared()
            if ticket < call.n_strips:
                warps = _column_block(call, ticket, sh)
            else:
                warps = _row_block(call, ticket - call.n_strips, sh)
            assert len(warps) == PRODUCERS + 1 + STORERS <= ROLE_WARPS
            running[ticket] = len(warps)
            for w in warps:
                live.append([w, None, int(rng.integers(1, 4)), ticket])
        moved = False
        finished = []
        for n in rng.permutation(len(live)):
            entry = live[n]
            for _ in range(entry[2]):
                if entry[1] is None:
                    try:
                        entry[1] = next(entry[0])
                    except StopIteration:
                        finished.append(n)
                        running[entry[3]] -= 1
                        if not running[entry[3]]:
                            del running[entry[3]]
                            _finished(call, entry[3])
                        moved = True
                        break
                if not entry[1]():
                    break
                entry[1] = None
                moved = True
        for n in sorted(finished, reverse=True):
            live.pop(n)
        assert moved or started < call.n_blocks, "deadlock"


def _wide(W, H, seed):
    """Magnitudes over 2^-30 .. 2^12 at 30 % of the pixels (float64 sums
    round, so the order shows), -0.0 elsewhere in vx, negative lengths
    the gate drops."""
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    mag = 2.0 ** rng.uniform(-30, 12, (3, W, H))
    sign = np.where(rng.random((3, W, H)) < 0.5, -1.0, 1.0)
    fl, fvx, fvy = (mag * sign * mask).astype(np.float32)
    fl = np.where(rng.random((W, H)) < 0.9, np.abs(fl), fl)
    fvx[~mask] = -0.0
    return fl, fvx, fvy


def _bits(fields):
    return tdf.build_integral(
        *(torch.from_numpy(a) for a in fields)).numpy().view(np.uint64)


# the sensor, the quirk geometry, one row, one column, an 80-row band of
# 320, harness config 5's sensor
SHAPES = ((320, 320), (260, 346), (1, 17), (33, 1), (80, 320), (1280, 720))


@pytest.mark.parametrize("n_sm", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_integral_schedule_folds_build_integral_bitwise(shape, n_sm):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1] * 31 + n_sm)
    stream = _slot()
    first_fields = _wide(40, 37, 1)
    first = Call(first_fields, stream)    # an earlier call on the stream
    play(first, n_sm, rng)
    assert stream == _slot()
    assert np.array_equal(first.integ.view(np.uint64), _bits(first_fields))
    fields = _wide(*shape, 2)
    call = Call(fields, stream)
    for _ in range(2):                    # the launch, then its replay
        play(call, n_sm, rng)
        assert stream == _slot()
        assert np.array_equal(call.integ.view(np.uint64), _bits(fields))
        call.launch()


def test_integral_roles_and_slots_match_the_source():
    """The model's lanes and warps are the kernel's: one fold warp of 4
    fields x STRIP columns or x BAND rows; two producers and two storers,
    a half slot each, a row block's half whole fields; the grid of column
    then row blocks; the slot's pitch; the counters' reset."""
    assert FIELDS * STRIP == LANES == FIELDS * BAND == 32
    assert PRODUCERS == STORERS == 2 and HALF % BAND == 0
    assert PRODUCERS + 1 + STORERS <= ROLE_WARPS
    assert re.search(r"constexpr int PITCH = STEPS \+ 2;", _SRC)
    assert "integral_kernel<<<n_blocks, ROLE_WARPS * 32" in _SRC
    assert "(cols + STRIP) / STRIP" in _SRC
    assert "n_strips + (rows + BAND - 1) / BAND" in _SRC
    for bar, count in (("full", "2 \\* 32"), ("done", "32"),
                       ("empty", "2 \\* 32")):
        assert re.search(rf"mbar_init\(&sh\.{bar}\[s\], {count}\)", _SRC)
    # the last row block to finish resets the slot's counters (_finished)
    assert ("atomicAdd(&g_exits[slot], 1ULL) == gridDim.x - n_strips - 1"
            in _SRC)
    for name in ("g_tickets", "g_strips_done", "g_exits"):
        assert f"{name}[slot] = 0;" in _SRC

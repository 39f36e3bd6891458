"""The float64 integral image of the aperture stage, on the CPU.

- The plain `build_integral` equals a NumPy float64 reference that sums
  sequentially down each column, then along each row, from a zero first
  row and column (`np.add.accumulate`), bit for bit: the order the
  integral kernel (csrc/aperture.cu) follows and the card's plain version
  keeps (tests/test_torch_cuda.py holds both on the card). Inputs span
  many binades, so the float64 sums round and the order shows.
- `kernels.integral` on a CPU tensor is the plain version and counts no
  launch; the halo engine's one-rank band carries the reference's values.
- Against `farms_tpu`'s f32 integral (`farms_tpu.ops.aperture
  .build_integral`): the count field equal (integers below 2^24), the
  other fields within the f32 cumsum's rounding, 2^-20 of the running sum
  of magnitudes.
"""
import numpy as np
import pytest
import torch

from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from farms_tpu.ops.aperture import build_integral as j_build_integral  # noqa: E402,E501


def _fields(W, H, seed, wide):
    """Flow surfaces at 30 % of the pixels (0 elsewhere, some -0.0 and a
    few negative lengths the gate drops); `wide`: magnitudes over 2^-30 ..
    2^12, so that float64 sums of them round."""
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    if wide:
        mag = 2.0 ** rng.uniform(-30, 12, (3, W, H))
    else:
        mag = rng.uniform(100, 3000, (3, W, H))
    sign = np.where(rng.random((3, W, H)) < 0.5, -1.0, 1.0)
    fl, fvx, fvy = (mag * sign * mask).astype(np.float32)
    fl = np.where(rng.random((W, H)) < 0.9, np.abs(fl), fl)
    fvx[~mask] = -0.0
    return fl, fvx, fvy


def _reference(fl, fvx, fvy):
    """Sequential float64 sums from a zero first row and column."""
    gate = (fl > 0).astype(np.float32)
    f = np.stack([gate, fl * gate, fvx * gate, fvy * gate]).astype(np.float64)
    f = np.pad(f, ((0, 0), (1, 0), (1, 0)))
    return np.add.accumulate(np.add.accumulate(f, axis=1), axis=2)


@pytest.mark.parametrize("W, H, seed, wide", [
    (48, 40, 1, True), (37, 29, 2, True), (64, 64, 3, False),
    (1, 17, 4, True), (33, 1, 5, True)])
def test_plain_integral_is_the_sequential_float64_sum(W, H, seed, wide):
    fields = _fields(W, H, seed, wide)
    got = tdf.build_integral(*(torch.from_numpy(a) for a in fields)).numpy()
    want = _reference(*fields)
    assert got.shape == (4, W + 1, H + 1) and got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_order_matters_on_these_inputs():
    """The check above can see the order: on the wide inputs, summing
    along y first changes some float64 results."""
    fields = _fields(48, 40, 1, True)
    gate = (fields[0] > 0).astype(np.float32)
    f = np.stack([gate, fields[0] * gate, fields[1] * gate,
                  fields[2] * gate]).astype(np.float64)
    f = np.pad(f, ((0, 0), (1, 0), (1, 0)))
    y_first = np.add.accumulate(np.add.accumulate(f, axis=2), axis=1)
    assert (y_first != _reference(*fields)).any()


def test_cpu_integral_wrapper_is_plain_and_counts_no_launch():
    fields = [torch.from_numpy(a) for a in _fields(24, 20, 6, True)]
    tk.reset_launches()
    got = tk.integral(*fields)
    assert sum(tk.LAUNCHES.values()) == 0
    assert torch.equal(got.view(torch.int64),
                       tdf.build_integral(*fields).view(torch.int64))


def test_one_rank_band_carries_the_sequential_integral():
    """assemble_integral_band at one rank: A zero rows, the reference
    integral (its zero row 0 and rows 1..W), then A copies of its total
    row, bit for bit."""
    from farms_tpu_torch.parallel.halo import assemble_integral_band
    from farms_tpu_torch.parallel.mesh import Axis

    A = 11
    fields = _fields(40, 32, 7, True)
    ref = _reference(*fields)
    got = assemble_integral_band(*(torch.from_numpy(a) for a in fields),
                                 Axis((0,), 0), A).numpy()
    want = np.concatenate([np.zeros_like(ref[:, :A]), ref,
                           np.repeat(ref[:, -1:], A, axis=1)], 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("wide", [False, True])
def test_integral_matches_jax_f32_integral(wide):
    fields = _fields(48, 40, 8, wide)
    got = tk.integral(*(torch.from_numpy(a) for a in fields)).numpy()
    ref = np.asarray(j_build_integral(*(jnp.asarray(a) for a in fields)),
                     dtype=np.float64)
    np.testing.assert_array_equal(got[0], ref[0])
    gate = (fields[0] > 0).astype(np.float32)
    mags = np.abs(np.stack([fields[0] * gate, fields[1] * gate,
                            fields[2] * gate]).astype(np.float64))
    bound = _reference(*(m.astype(np.float32) for m in mags))[1:]
    assert (np.abs(got[1:] - ref[1:]) <= bound * 2.0 ** -20).all()

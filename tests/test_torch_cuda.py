"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch finds no CUDA device. Run them on the
GPU machine with `python -m pytest tests/test_torch_cuda.py -q`. They need
no JAX. Expected agreement is bitwise: the kernels compute in the plain
versions' operation order and are built with -fmad=false.
"""
import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)


def _random_surfaces(W, H, seed):
    rng = np.random.default_rng(seed)
    touched = rng.random((W, H)) < 0.8
    t_pre = np.where(touched, rng.integers(1, 5_000_000, (W, H)) + 1, 0)
    t_post = t_pre.copy()
    t_post[W // 5:4 * W // 5, H // 8:5 * H // 8] += 800
    return t_pre.astype(np.int32), t_post.astype(np.int32)


def _wrap_surfaces(W, H, seed):
    """Stamps on both sides of 2^31 and near 2^32, half untouched."""
    rng = np.random.default_rng(seed)
    touched = rng.random((W, H)) < 0.5
    t = np.where(touched,
                 rng.choice([101, 5001, 2**31 + 7, 2**32 - 3], size=(W, H)),
                 0).astype(np.uint32)
    post = t.copy()
    post[::3, ::2] += np.uint32(700)
    return t.view(np.int32), post.view(np.int32)


def _flow_fields(W, H, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    fl = (rng.random((W, H)) * mask).astype(np.float32)
    fvx = (rng.standard_normal((W, H)) * (fl > 0)).astype(np.float32)
    fvy = (rng.standard_normal((W, H)) * (fl > 0)).astype(np.float32)
    return fl, fvx, fvy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5])
def test_cuda_local_flow_kernel_matches_plain(cuda, k):
    cfg = TConfig(width=320, height=320, filter_size=k)
    pre, post = _random_surfaces(320, 320, seed=9)
    mid = np.where(np.arange(320)[:, None] % 2 == 0, post, pre)
    cases = [(t_pre[None], t_post) for t_pre, t_post in
             (_random_surfaces(320, 320, seed=7),
              _wrap_surfaces(320, 320, seed=8))]
    cases.append((np.stack([pre, mid]), post))    # a 2-surface chain
    for t_pre, t_post in cases:
        chain = torch.from_numpy(np.ascontiguousarray(t_pre)).to(cuda)
        center = torch.from_numpy(t_post).to(cuda)
        tk.reset_launches()
        got = tk.local_flow(chain, center, cfg)
        assert tk.LAUNCHES["local_flow"] == 1
        want = tdf.local_flow_core(chain, center, cfg)
        for name, g, w in zip(["accept", "a", "b", "dtdp", "cand"], got,
                              want):
            assert torch.equal(g, w), name


def _chain(W, H, seed, n):
    """A stamp1 chain of n surfaces (each rewriting a random half of the
    cells later, stamps past 2^31) and a rank-2 center surface a little
    before the last surface's value at a third of the cells."""
    t_pre, _ = _wrap_surfaces(W, H, seed)
    rng = np.random.default_rng(seed)
    surfs = [t_pre.view(np.uint32)]
    for _ in range(n - 1):
        hot = rng.random((W, H)) < 0.5
        step = rng.integers(200, 900, (W, H)).astype(np.uint32)
        surfs.append(np.where(hot, surfs[-1] + step, surfs[-1]))
    pick = (rng.random((W, H)) < 0.34) & (surfs[-1] != 0)
    back = rng.integers(1, 400, (W, H)).astype(np.uint32)
    center = np.where(pick, surfs[-1] - back, 0).astype(np.uint32)
    return (np.stack(surfs).view(np.int32),
            np.ascontiguousarray(center.view(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("k, n_chain, fold_center, geom", [
    (3, 8, True, (320, 320)), (5, 8, True, (320, 320)),
    (3, 3, False, (320, 320)), (5, 17, False, (320, 320)),
    (3, 96, True, (320, 320)), (5, 96, False, (320, 320)),
    (3, 8, True, (260, 346)), (5, 17, False, (260, 346)),
    (7, 1, True, (320, 320)), (7, 9, False, (320, 320)),
    (9, 9, True, (320, 320)), (9, 1, False, (320, 320)),
    (7, 9, True, (260, 346)), (9, 96, False, (320, 320)),
    (11, 9, True, (320, 320)), (11, 3, False, (320, 320)),
    (21, 9, False, (320, 320)), (21, 3, True, (260, 346)),
    (31, 3, True, (128, 128)), (31, 1, False, (128, 128)),
    (59, 1, False, (120, 118)), (89, 1, True, (180, 178)),
    (181, 1, True, (40, 36))])
def test_cuda_local_flow_modes_match_plain(cuda, k, n_chain, fold_center,
                                           geom):
    """The streamed k = 3/5 kernels on the fidelity preset's 8-surface
    snapshot chain and on 96 surfaces, also on the 260 x 346 geometry of
    the y-clamp quirk (W != H), correction mode (fold_center=False) of
    both local-flow kernels, and the general kernel (k >= 7) in both
    modes, also at 260 x 346 and on 96 surfaces, bitwise against plain.
    Past k = 9 its radius comes at run time, the support in slabs of rows:
    5 at k = 11, 14 at k = 21 and 61 at k = 31 (the inliers refold a slab,
    or skip one that no winner of a block reaches), with two blocks to an
    SM at k = 59, one at k = 89, and a one-row tile at k = 181 (whose
    sensor holds no window: candidate 0's fit is compared)."""
    W, H = geom
    cfg = TConfig(width=W, height=H, filter_size=k)
    chain, center = _chain(W, H, seed=10 + k, n=n_chain)
    if fold_center:
        # the surface after the chain: every third row written later
        last = chain[-1].view(np.uint32)
        rows = (np.arange(W) % 3 == 0)[:, None] & (last != 0)
        center = np.where(rows, last + np.uint32(700), last).view(np.int32)
    chain = torch.from_numpy(chain).to(cuda)
    center = torch.from_numpy(center).to(cuda)
    tk.reset_launches()
    got = tk.local_flow(chain, center, cfg, fold_center=fold_center)
    name = "local_flow" if k in (3, 5) else "local_flow_general"
    assert tk.LAUNCHES[name] == 1 and sum(tk.LAUNCHES.values()) == 1
    want = tdf.local_flow_core(chain, center, cfg, fold_center=fold_center)
    for label, g, w in zip(["accept", "a", "b", "dtdp", "cand"], got, want):
        assert torch.equal(g, w), label


@pytest.mark.cuda
@pytest.mark.parametrize("k, n_chain", [(5, 60), (3, 100), (7, 129),
                                        (9, 96), (11, 129), (21, 40)])
def test_cuda_long_chain_matches_plain(cuda, k, n_chain):
    """Chains past what a whole-chain tile of shared memory held (59
    surfaces at k = 5, 79 at k = 3, 100 at k = 7, 70 at k = 9, 52 at
    k = 11, 18 at k = 21) stream through the local-flow kernels, bitwise
    equal to plain in both fold modes; at k = 11 and 21 once per slab."""
    cfg = TConfig(width=64, height=64, filter_size=k)
    chain, center = _chain(64, 64, seed=30 + k, n=n_chain)
    chain = torch.from_numpy(chain).to(cuda)
    name = "local_flow" if k in (3, 5) else "local_flow_general"
    for fold, c in ((False, center), (True, chain[-1].cpu().numpy())):
        c = torch.from_numpy(np.ascontiguousarray(c)).to(cuda)
        tk.reset_launches()
        got = tk.local_flow(chain, c, cfg, fold_center=fold)
        assert tk.LAUNCHES[name] == 1
        want = tdf.local_flow_core(chain, c, cfg, fold_center=fold)
        for label, g, w in zip(["accept", "a", "b", "dtdp", "cand"], got,
                               want):
            assert torch.equal(g, w), (fold, label)


# shared memory one block may use on sm_90 (227 KB), and the most where two
# or three blocks share an SM (228 KB an SM, 1 KB reserved for each block)
SMEM_BYTES = 232448
SMEM_HALF = 233472 // 2 - 1024
SMEM_THIRD = 233472 // 3 - 1024


def _general_bytes(k, rows, slab):
    """The general kernel's shared memory, restated: a ring of 8 surfaces
    of (rows + slab - 1) x (32 + 2R) and a 4-byte slot per thread and
    offset of slab x (2R + 1); no term holds the chain's length."""
    R = 2 * (k // 2)
    return 4 * (8 * (rows + slab - 1) * (32 + 2 * R)
                + slab * (2 * R + 1) * rows * 32)


@pytest.mark.cuda
@pytest.mark.parametrize("k, rows, slabs, limit", [
    (3, 8, 0, 0), (5, 4, 0, 0), (7, 4, 1, SMEM_HALF), (9, 2, 1, SMEM_HALF),
    (11, 4, 5, SMEM_THIRD), (15, 4, 8, SMEM_THIRD), (17, 4, 11, SMEM_THIRD),
    (19, 4, 13, SMEM_THIRD), (21, 4, 14, SMEM_THIRD),
    (31, 4, 61, SMEM_THIRD), (57, 4, 113, SMEM_THIRD),
    (59, 4, 117, SMEM_HALF), (87, 4, 173, SMEM_HALF),
    (89, 4, 89, SMEM_BYTES), (179, 4, 357, SMEM_BYTES),
    (181, 1, 121, SMEM_BYTES)])
def test_tile_rows_fit_shared_memory(cuda, k, rows, slabs, limit):
    """The shape the kernel library reports for each filter size: every
    instance takes any chain at fixed tile rows, since the streamed
    k = 3 and 5 kernels and the general kernel keep a fixed ring of
    surfaces. The general kernel folds its support in slabs of rows: the
    most whose ring and slots fit `limit`, the first of three blocks to an
    SM (a run-time radius), two (k = 7 and 9, the whole support in one
    slab; a run-time radius past k = 57) and all 227 KB (past k = 87)
    that one support row fits; past k = 179 a one-row tile."""
    shape = tk.local_flow_shape(k)
    R = 2 * (k // 2)
    assert shape["tile_rows"] == rows
    if k in (3, 5):   # four ring slots of the tile and its halo
        assert shape["slab_rows"] == 0
        assert shape["shared_bytes"] == 16 * (rows + 2 * R) * (32 + 2 * R)
        return
    side = 2 * R + 1
    slab = shape["slab_rows"]
    assert -(-side // slab) == slabs
    if k in (7, 9):
        assert slab == side
    assert shape["shared_bytes"] == _general_bytes(k, rows, slab) <= limit
    if slab < side:
        assert _general_bytes(k, rows, slab + 1) > limit
    tighter = [t for t in (SMEM_THIRD, SMEM_HALF, SMEM_BYTES) if t < limit]
    if k > 9 and tighter:     # a run-time radius takes the tightest fit
        assert _general_bytes(k, 4, 1) > tighter[-1]
    if rows == 1:
        assert _general_bytes(k, 4, 1) > SMEM_BYTES


@pytest.mark.cuda
@pytest.mark.parametrize("k, n_chain", [(7, 101), (9, 200)])
def test_long_chain_sizes_like_any_other(cuda, k, n_chain):
    """Chains that no whole-chain tile held (past 100 surfaces at k = 7,
    70 at k = 9) size like any other: one slab, the instance's tile rows,
    and shared memory below what staging the chain alone would take."""
    shape = tk.local_flow_shape(k)
    R = 2 * (k // 2)
    assert shape["slab_rows"] == 2 * R + 1
    assert shape["shared_bytes"] <= SMEM_HALF
    assert ((n_chain + 1) * (shape["tile_rows"] + 2 * R) * (32 + 2 * R) * 4
            > SMEM_BYTES)
    with pytest.raises(ValueError, match="filter size 8"):
        tk.local_flow_shape(8)


def _engines_agree(cfg, device, n_chain):
    """The engine on the card gives the CPU engine's valid flags and scale
    ids on every event of a random stream, and its flows within 1e-5
    relative (the trig tail's float ops round differently on the two
    devices); its correction pass ran on an n_chain-surface chain."""
    from farms_tpu_torch.events.io import synthetic_random_events
    from farms_tpu_torch.pipeline.engine import FlowEngine

    ev = synthetic_random_events(4096, width=64, height=64, rate_hz=2e6,
                                 seed=5)
    want = FlowEngine(cfg, device="cpu").process(ev)
    seen = []
    local_flow = tk.local_flow

    def recording(chain, *a, **kw):
        seen.append(chain.shape[0])
        return local_flow(chain, *a, **kw)

    tk.reset_launches()
    tk.local_flow = recording
    try:
        got = FlowEngine(cfg, device=device).process(ev)
    finally:
        tk.local_flow = local_flow
    name = "local_flow" if cfg.filter_size in (3, 5) else "local_flow_general"
    assert tk.LAUNCHES[name] > 0 and tk.LAUNCHES["integral"] > 0
    assert max(seen) == n_chain
    np.testing.assert_array_equal(got.r_local > 0, want.r_local > 0)
    np.testing.assert_array_equal(got.scale, want.scale)
    assert (want.r_local > 0).sum() > 20
    for col in ("vx", "vy", "r_local", "r_true"):
        np.testing.assert_allclose(getattr(got, col), getattr(want, col),
                                   rtol=1e-5, atol=1e-6, err_msg=col)


@pytest.mark.cuda
def test_cuda_engine_with_a_65_surface_chain_equals_cpu(cuda):
    """The k = 5 engine whose correction chain has 65 surfaces (refused
    when the kernel staged the whole chain) runs on the card and gives the
    CPU engine's results."""
    cfg = TConfig(width=64, height=64, filter_size=5, chunk_size=1024,
                  sub_phases=4, causal_snapshots=16, center_correction=64)
    _engines_agree(cfg, cuda, 65)


@pytest.mark.cuda
def test_cuda_engine_with_a_129_surface_chain_equals_cpu(cuda):
    """The k = 7 engine whose correction chain has 129 surfaces (refused
    when the general kernel staged the whole chain) runs on the card and
    gives the CPU engine's results."""
    cfg = TConfig(width=64, height=64, filter_size=7, chunk_size=1024,
                  sub_phases=8, causal_snapshots=16, center_correction=64)
    _engines_agree(cfg, cuda, 129)


def _wide_fields(W, H, seed):
    """Flow magnitudes over 2^-30 .. 2^12: float64 sums of them round."""
    rng = np.random.default_rng(seed)
    mask = rng.random((W, H)) < 0.3
    mag = 2.0 ** rng.uniform(-30, 12, (3, W, H))
    sign = np.where(rng.random((3, W, H)) < 0.5, -1.0, 1.0)
    return tuple((mag * sign * mask).astype(np.float32))


# every shape the integral's callers pass: the sensor, the quirk geometry,
# harness config 5's sensor, an 80-row band of 320, spatial tiles of (2,
# 2), (4, 2) and (1, 4) at 260 x 348, one row and one column
INTEGRAL_SHAPES = [(320, 320), (260, 346), (1280, 720), (80, 320),
                   (160, 160), (80, 160), (260, 87), (1, 17), (33, 1)]


def _bits(t):
    return t.view(torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", INTEGRAL_SHAPES)
@pytest.mark.parametrize("wide", [False, True])
def test_cuda_integral_kernel_matches_plain(cuda, geom, wide):
    """The float64 integral kernel, bit for bit against the plain version
    on the card and on the CPU (one summation order on both devices)."""
    W, H = geom
    arrays = _wide_fields(W, H, 3) if wide else _flow_fields(W, H, 3)
    cpu = [torch.from_numpy(a) for a in arrays]
    ins = [a.to(cuda) for a in cpu]
    tk.reset_launches()
    got = tk.integral(*ins)
    assert tk.LAUNCHES["integral"] == 1 and sum(tk.LAUNCHES.values()) == 1
    want = tdf.build_integral(*ins)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got.cpu()), _bits(tdf.build_integral(*cpu)))


@pytest.mark.cuda
def test_cuda_integral_back_to_back_calls_match_plain(cuda):
    """200 calls on one stream, queued without a wait: each call's
    generation keeps its row blocks off the counters of the calls before
    it."""
    ins = [torch.from_numpy(a).to(cuda) for a in _wide_fields(320, 320, 5)]
    want = _bits(tdf.build_integral(*ins))
    outs = [tk.integral(*ins) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(o), want) for o in outs)


@pytest.mark.cuda
def test_cuda_integral_two_shapes_on_two_streams_match_plain(cuda):
    """Calls that alternate two shapes and two streams, in flight together:
    each stream has its own counters, each call its own generation."""
    a = [torch.from_numpy(x).to(cuda) for x in _wide_fields(320, 320, 6)]
    b = [torch.from_numpy(x).to(cuda) for x in _wide_fields(80, 160, 7)]
    want = {True: _bits(tdf.build_integral(*a)),
            False: _bits(tdf.build_integral(*b))}
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for _ in range(50):
        for s, x in ((0, a), (1, b), (1, a), (0, b)):
            with torch.cuda.stream(streams[s]):
                outs.append((tk.integral(*x), x is a))
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(o), want[isa]) for o, isa in outs)


@pytest.mark.cuda
def test_cuda_integral_is_one_kernel_a_call(cuda):
    """torch.profiler sees one device kernel for each integral call: one
    kernel name, and never more events than calls (a trace now and then
    drops events, so the fullest of up to 5 traces is taken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ins = [torch.from_numpy(a).to(cuda) for a in _flow_fields(320, 320, 8)]
    tk.integral(*ins)
    torch.cuda.synchronize()
    counts = []
    for _ in range(5):      # a trace now and then drops device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                tk.integral(*ins)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
        assert len(set(names)) <= 1, names
        counts.append(len(names))
        if len(names) >= 10:
            break
    assert 0 < max(counts) <= 10, counts


# (sensor W, H, y-clamp quirk, max_window, window_jump, padded arrays,
# band counts, inf and NaN in vx): the main paths' sensors, sensors that
# are not multiples of the pool's tiles (their rows chosen at launch: 26
# at 320 x 320, 8 on small sensors), the quirk with W > H and W < H, a
# jump at the largest carried (16), past it (17) and past the tile's rows
# (40: no cell carried from one scale to the next), one scale and 21,
# padded arrays, bands of 1, 2 and 4 shards and bands of one row
APERTURE_CASES = {
    "320x320": (320, 320, False, 50, 5, None, (), False),
    "260x346 quirk": (260, 346, True, 50, 5, None, (), False),
    "37x53": (37, 53, False, 50, 5, None, (), False),
    "quirk W>H": (60, 41, True, 50, 5, None, (), False),
    "quirk W<H": (41, 60, True, 50, 5, None, (), False),
    "jump 16": (320, 320, False, 64, 16, None, (), False),
    "jump 17": (320, 320, True, 68, 17, None, (2,), False),
    "jump 40": (100, 130, True, 80, 40, None, (), False),
    "max_window 0": (37, 53, False, 0, 5, None, (), False),
    "max_window 100": (260, 346, False, 100, 5, None, (2,), False),
    "padded": (60, 44, True, 50, 5, (64, 48), (), False),
    "bands 1, 2, 4": (320, 320, False, 50, 5, None, (1, 2, 4), False),
    "bands of one row": (8, 40, True, 20, 3, None, (8,), False),
    "inf and NaN in vx": (320, 320, False, 50, 5, None, (4,), True),
}


def _bits_equal(g, w):
    """Bit for bit, NaN payloads included (f32 viewed as i32)."""
    if g.dtype == torch.float32:
        return torch.equal(g.view(torch.int32), w.view(torch.int32))
    return torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(APERTURE_CASES))
def test_cuda_aperture_kernel_matches_plain(cuda, case):
    """The pool bit for bit against dense_aperture: the whole sensor, and
    each band (sliced from the whole float64 integral, 0 above the
    sensor, its total row below) against the plain band mode and the
    whole sensor's rows."""
    import dataclasses

    W, H, quirk, mw, jump, pad, bands, special = APERTURE_CASES[case]
    cfg = TConfig(width=W, height=H, replicate_y_clamp_quirk=quirk,
                  max_window=mw, window_jump=jump)
    if pad:
        cfg = dataclasses.replace(cfg, padded_width=pad[0],
                                  padded_height=pad[1])
    Wa, Ha = cfg.array_width, cfg.array_height
    fields = _flow_fields(Wa, Ha, seed=3)
    if special:
        rng = np.random.default_rng(4)
        fields[1][rng.random((Wa, Ha)) < 0.01] = np.inf
        fields[1][rng.random((Wa, Ha)) < 0.01] = np.nan
    ins = [torch.from_numpy(a).to(cuda) for a in fields]
    tk.reset_launches()
    got = tk.aperture(*ins, cfg)
    assert tk.LAUNCHES["aperture"] == 1 and tk.LAUNCHES["integral"] == 1
    want = tdf.dense_aperture(*ins, cfg)
    for name, g, w in zip(["tvx", "tvy", "scale"], got, want):
        assert _bits_equal(g, w), name
    A = cfg.max_window + 1
    integ = tdf.build_integral(*ins)
    full = torch.cat([integ.new_zeros((4, A, integ.shape[2])), integ,
                      integ[:, -1:].expand(-1, A, -1)], 1)
    for n in bands:
        rows = Wa // n
        for i in range(n):
            end = Wa if i == n - 1 else rows * (i + 1)
            band = full[:, rows * i:end + 2 * A + 1].contiguous()
            core = [a[rows * i:end] for a in ins]
            tk.reset_launches()
            g_band = tk.aperture(*core, cfg, halo=A, integ=band)
            assert tk.LAUNCHES["aperture"] == 1
            w_band = tdf.dense_aperture(*core, cfg, halo=A, integ=band)
            for name, g, w, o in zip(["tvx", "tvy", "scale"], g_band,
                                     w_band, got):
                assert _bits_equal(g, w), (n, i, name)
                assert _bits_equal(g, o[rows * i:end]), (n, i, name)


def _band(arr, n, i, h):
    """Rows of shard i of n with h rows from each side, zero past the
    sensor edge (the band exchange_halo gives)."""
    rows = arr.shape[-2] // n
    pad = [(0, 0)] * (arr.ndim - 2) + [(h, h), (0, 0)]
    return np.ascontiguousarray(
        np.pad(arr, pad)[..., i * rows:i * rows + rows + 2 * h, :])


@pytest.mark.cuda
@pytest.mark.parametrize("k, n_chain, fold_center", [
    (3, 1, True), (5, 8, True), (3, 3, False), (7, 1, True), (3, 96, True),
    (5, 96, False), (7, 3, False), (9, 96, True), (11, 3, False),
    (21, 1, True)])
def test_cuda_halo_local_flow_matches_plain(cuda, k, n_chain, fold_center):
    """Halo mode on 1, 2 and 4 bands (320, 160 and 80 rows: the shards of
    1, 2 and 4 ranks): bitwise equal to the plain halo mode and to the
    whole-sensor kernel's rows."""
    cfg = TConfig(width=320, height=320, filter_size=k)
    R = cfg.support_radius
    chain, center = _chain(320, 320, seed=20 + k, n=n_chain)
    if fold_center:
        center = np.where(np.arange(320)[:, None] % 3 == 0,
                          chain[-1].view(np.uint32) + np.uint32(700),
                          chain[-1].view(np.uint32)).view(np.int32)
    whole = tk.local_flow(torch.from_numpy(chain).to(cuda),
                          torch.from_numpy(center).to(cuda), cfg,
                          fold_center=fold_center)
    name = "local_flow" if k in (3, 5) else "local_flow_general"
    for n in (1, 2, 4):
        rows = 320 // n
        for i in range(n):
            ch = torch.from_numpy(_band(chain, n, i, R)).to(cuda)
            ce = torch.from_numpy(_band(center, n, i, R)).to(cuda)
            tk.reset_launches()
            got = tk.local_flow(ch, ce, cfg, fold_center=fold_center,
                                halo=R, row_offset=rows * i)
            assert tk.LAUNCHES[name] == 1 and sum(tk.LAUNCHES.values()) == 1
            want = tdf.local_flow_core(ch, ce, cfg, fold_center=fold_center,
                                       halo=R, row_offset=rows * i)
            for label, g, w, o in zip(["accept", "a", "b", "dtdp", "cand"],
                                      got, want, whole):
                assert torch.equal(g, w), (n, i, label)
                assert torch.equal(g, o[rows * i:rows * (i + 1)]), (
                    n, i, label)


@pytest.mark.cuda
def test_cuda_aperture_band_matches_plain(cuda):
    """Band mode on 1, 2 and 4 bands (320, 160 and 80 rows), each sliced
    from the whole float64 integral (0 above the sensor, its total row
    below): bitwise equal to the plain band mode and to the whole-sensor
    kernel's rows."""
    cfg = TConfig(width=320, height=320)
    A = cfg.max_window + 1
    ins = [torch.from_numpy(a).to(cuda) for a in _flow_fields(320, 320, 5)]
    whole = tk.aperture(*ins, cfg)
    integ = tdf.build_integral(*ins)
    full = torch.cat([torch.zeros_like(integ[:, :A]), integ,
                      integ[:, -1:].expand(-1, A, -1)], 1)
    for n in (1, 2, 4):
        rows = 320 // n
        for i in range(n):
            band = full[:, rows * i:rows * (i + 1) + 2 * A + 1].contiguous()
            core = [a[rows * i:rows * (i + 1)] for a in ins]
            tk.reset_launches()
            got = tk.aperture(*core, cfg, halo=A, integ=band)
            assert tk.LAUNCHES["aperture"] == 1
            want = tdf.dense_aperture(*core, cfg, halo=A, integ=band)
            for name, g, w, o in zip(["tvx", "tvy", "scale"], got, want,
                                     whole):
                assert torch.equal(g, w), (n, i, name)
                assert torch.equal(g, o[rows * i:rows * (i + 1)]), (
                    n, i, name)


def _tile(arr, tile, h):
    """A tile (row0, rows, col0, cols) of a [..., W, H] array with h cells
    more on each side in both axes, zero past the sensor edge (the halos
    the spatial engine exchanges)."""
    r0, rows, c0, cols = tile
    pad = [(0, 0)] * (arr.ndim - 2) + [(h, h), (h, h)]
    return np.ascontiguousarray(
        np.pad(arr, pad)[..., r0:r0 + rows + 2 * h, c0:c0 + cols + 2 * h])


def _tiles(W, H, shape):
    """(row0, rows, col0, cols) of each tile of a (tx, ty) grid."""
    tx, ty = shape
    rows, cols = W // tx, H // ty
    return [((r % tx) * rows, rows, (r // tx) * cols, cols)
            for r in range(tx * ty)]


# (W, H, grid shape) of the tile-mode cases: the 320 x 320 sensor in (2,
# 2) and (4, 2) tiles, and 260 x 346 in (1, 4), padded to 260 x 348 as
# the spatial engine pads it
TILE_GEOMS = ((320, 320, (2, 2)), (320, 320, (4, 2)), (260, 346, (1, 4)))


def _padded(arr, cfg):
    """A [..., W, H] array at cfg's array geometry (pad cells 0)."""
    pad = [(0, 0)] * (arr.ndim - 2) + [(0, cfg.array_width - cfg.width),
                                       (0, cfg.array_height - cfg.height)]
    return np.ascontiguousarray(np.pad(arr, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("k, n_chain, fold_center", [
    (3, 1, True), (5, 8, True), (3, 3, False), (5, 3, False), (7, 1, True),
    (7, 3, False), (11, 3, False)])
def test_cuda_tile_local_flow_matches_plain(cuda, k, n_chain, fold_center):
    """Tile mode (both halos, both offsets) on the tiles of TILE_GEOMS:
    bitwise equal to the plain tile mode and to the whole-sensor kernel's
    cells."""
    name = "local_flow" if k in (3, 5) else "local_flow_general"
    for W, H, shape in TILE_GEOMS:
        cfg = TConfig(width=W, height=H, filter_size=k).padded_to(*shape)
        R = cfg.support_radius
        chain, center = _chain(W, H, seed=40 + k, n=n_chain)
        if fold_center:
            center = np.where(np.arange(W)[:, None] % 3 == 0,
                              chain[-1].view(np.uint32) + np.uint32(700),
                              chain[-1].view(np.uint32)).view(np.int32)
        chain, center = _padded(chain, cfg), _padded(center, cfg)
        whole = tk.local_flow(torch.from_numpy(chain).to(cuda),
                              torch.from_numpy(center).to(cuda), cfg,
                              fold_center=fold_center)
        for tile in _tiles(cfg.array_width, cfg.array_height, shape):
            r0, rows, c0, cols = tile
            ch = torch.from_numpy(_tile(chain, tile, R)).to(cuda)
            ce = torch.from_numpy(_tile(center, tile, R)).to(cuda)
            kw = dict(fold_center=fold_center, halo=R, row_offset=r0,
                      col_halo=R, col_offset=c0)
            tk.reset_launches()
            got = tk.local_flow(ch, ce, cfg, **kw)
            assert tk.LAUNCHES[name] == 1
            want = tdf.local_flow_core(ch, ce, cfg, **kw)
            for label, g, w, o in zip(["accept", "a", "b", "dtdp", "cand"],
                                      got, want, whole):
                assert _bits_equal(g, w), (W, shape, tile, label)
                assert _bits_equal(
                    g, o[r0:r0 + rows, c0:c0 + cols].contiguous()), (
                    W, shape, tile, label)


@pytest.mark.cuda
@pytest.mark.parametrize("quirk", [False, True])
def test_cuda_tile_aperture_matches_plain(cuda, quirk):
    """The pool in tile mode on the tiles of TILE_GEOMS, each band cut
    from the whole float64 integral and pre-clamped in y (tile_band; with
    the quirk at 260 x 346 the clamp is column 260, inside the last tile's
    band): bitwise equal to the plain tile mode and to the whole-sensor
    pool's cells."""
    for W, H, shape in TILE_GEOMS:
        cfg = TConfig(width=W, height=H,
                      replicate_y_clamp_quirk=quirk).padded_to(*shape)
        A = cfg.max_window + 1
        yc = tdf.aperture_y_clip(cfg)
        ins = [torch.from_numpy(_padded(a, cfg)).to(cuda)
               for a in _flow_fields(W, H, 5 + W)]
        whole = tk.aperture(*ins, cfg)
        integ = tdf.build_integral(*ins)
        for tile in _tiles(cfg.array_width, cfg.array_height, shape):
            r0, rows, c0, cols = tile
            band = tdf.tile_band(integ, r0, rows, c0, cols, A, yc)
            core = [a[r0:r0 + rows, c0:c0 + cols].contiguous() for a in ins]
            kw = dict(halo=A, col_halo=A, integ=band)
            tk.reset_launches()
            got = tk.aperture(*core, cfg, **kw)
            assert tk.LAUNCHES["aperture"] == 1
            want = tdf.dense_aperture(*core, cfg, **kw)
            for name, g, w, o in zip(["tvx", "tvy", "scale"], got, want,
                                     whole):
                assert _bits_equal(g, w), (W, shape, tile, name)
                assert _bits_equal(
                    g, o[r0:r0 + rows, c0:c0 + cols].contiguous()), (
                    W, shape, tile, name)


@pytest.mark.cuda
@pytest.mark.parametrize("correction", [0, 32])
def test_cuda_one_rank_spatial_engine_equals_single_engine(cuda, correction):
    """The spatial engine on one card (no process group, both column
    halos zero-filled) runs the tile mode of every kernel and gives the
    single engine's outputs bitwise."""
    from farms_tpu_torch.events.io import synthetic_translating_bar
    from farms_tpu_torch.parallel.tiling import SpatialFlowEngine
    from farms_tpu_torch.pipeline.engine import FlowEngine

    cfg = TConfig(width=64, height=48, chunk_size=128, steps_per_scan=2,
                  max_window=10, window_jump=5, sub_phases=4,
                  aperture_sub_phases=2, causal_snapshots=2,
                  center_correction=correction, wire="f16")
    ev = synthetic_translating_bar(width=64, height=48, bar_len=16,
                                   duration_us=15000, jitter_us=10, seed=4)
    ev.y[:] = np.clip(ev.y, 0, 47)
    ref = FlowEngine(cfg, device=cuda).process(ev)
    tk.reset_launches()
    got = SpatialFlowEngine(cfg, device=cuda).process(ev)
    assert tk.LAUNCHES["local_flow"] > 0 and tk.LAUNCHES["aperture"] > 0
    assert (ref.r_local > 0).sum() > 40
    for col in ("vx", "vy", "r_local", "theta_local", "r_true", "theta_true",
                "scale"):
        np.testing.assert_array_equal(getattr(got, col), getattr(ref, col),
                                      err_msg=col)


@pytest.mark.cuda
@pytest.mark.parametrize("correction", [0, 32])
def test_cuda_one_rank_halo_engine_equals_single_engine(cuda, correction):
    """The halo engine on one card (no process group) runs every halo mode
    of every kernel and gives the single engine's outputs bitwise."""
    from farms_tpu_torch.events.io import synthetic_translating_bar
    from farms_tpu_torch.parallel.halo import HaloFlowEngine
    from farms_tpu_torch.pipeline.engine import FlowEngine

    cfg = TConfig(width=64, height=48, chunk_size=128, steps_per_scan=2,
                  max_window=10, window_jump=5, sub_phases=4,
                  aperture_sub_phases=2, causal_snapshots=2,
                  center_correction=correction, wire="f16")
    ev = synthetic_translating_bar(width=64, height=48, bar_len=16,
                                   duration_us=15000, jitter_us=10, seed=4)
    ev.y[:] = np.clip(ev.y, 0, 47)
    ref = FlowEngine(cfg, device=cuda).process(ev)
    tk.reset_launches()
    got = HaloFlowEngine(cfg, device=cuda).process(ev)
    assert tk.LAUNCHES["local_flow"] > 0 and tk.LAUNCHES["aperture"] > 0
    assert (ref.r_local > 0).sum() > 40
    for col in ("vx", "vy", "r_local", "theta_local", "r_true", "theta_true",
                "scale"):
        np.testing.assert_array_equal(getattr(got, col), getattr(ref, col),
                                      err_msg=col)


@pytest.mark.cuda
def test_cuda_halo_engine_with_a_129_surface_chain_equals_single_engine(
        cuda):
    """The one-rank halo engine at k = 7 with a 129-surface correction
    chain (every halo mode of the general kernel, no pre-check) gives the
    single engine's outputs on the card bitwise."""
    from farms_tpu_torch.events.io import synthetic_random_events
    from farms_tpu_torch.parallel.halo import HaloFlowEngine
    from farms_tpu_torch.pipeline.engine import FlowEngine

    cfg = TConfig(width=64, height=64, filter_size=7, chunk_size=1024,
                  sub_phases=8, causal_snapshots=16, center_correction=64)
    ev = synthetic_random_events(4096, width=64, height=64, rate_hz=2e6,
                                 seed=6)
    ref = FlowEngine(cfg, device=cuda).process(ev)
    tk.reset_launches()
    got = HaloFlowEngine(cfg, device=cuda).process(ev)
    assert tk.LAUNCHES["local_flow_general"] > 0
    assert (ref.r_local > 0).sum() > 20
    for col in ("vx", "vy", "r_local", "theta_local", "r_true", "theta_true",
                "scale"):
        np.testing.assert_array_equal(getattr(got, col), getattr(ref, col),
                                      err_msg=col)


@pytest.mark.cuda
def test_cuda_kernels_on_padded_arrays_match_plain(cuda):
    """The kernels on a padded array geometry (pad cells never written):
    equal to their plain versions, and on the sensor's cells to the
    unpadded kernels' outputs, bitwise."""
    import dataclasses

    cfg = TConfig(width=60, height=44, max_window=10)
    padded = dataclasses.replace(cfg, padded_width=64, padded_height=48)
    pre, post = _random_surfaces(60, 44, seed=3)
    fields = _flow_fields(60, 44, seed=4)

    def put(a, shape):
        out = np.zeros(shape, a.dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return torch.from_numpy(out).to(cuda)

    chain, center = put(pre, (64, 48))[None], put(post, (64, 48))
    got = tk.local_flow(chain, center, padded)
    want = tdf.local_flow_core(chain, center, padded)
    plain = tk.local_flow(put(pre, (60, 44))[None], put(post, (60, 44)), cfg)
    for name, g, w, p in zip(["accept", "a", "b", "dtdp", "cand"], got,
                             want, plain):
        assert torch.equal(g, w), name
        assert torch.equal(g[:60, :44], p), name
    fl = [put(a, (64, 48)) for a in fields]
    got = tk.aperture(*fl, padded)
    want = tdf.dense_aperture(*fl, padded)
    plain = tk.aperture(*(put(a, (60, 44)) for a in fields), cfg)
    for name, g, w, p in zip(["tvx", "tvy", "scale"], got, want, plain):
        assert torch.equal(g, w), name
        assert torch.equal(g[:60, :44], p), name


@pytest.mark.cuda
def test_cuda_one_rank_dp_multihost_and_padded_engines_equal_single(cuda):
    """On one card, dp and multihost (no process group) and the single
    engine on padded arrays give the single engine's outputs bitwise."""
    import dataclasses

    from farms_tpu_torch.events.io import synthetic_translating_bar
    from farms_tpu_torch.parallel import (MultiHostFlowEngine,
                                          ShardedFlowEngine)
    from farms_tpu_torch.pipeline.engine import FlowEngine

    cfg = TConfig(width=64, height=48, chunk_size=128, steps_per_scan=2,
                  max_window=10, window_jump=5, sub_phases=4,
                  aperture_sub_phases=2, causal_snapshots=2,
                  center_correction=32, wire="f16")
    ev = synthetic_translating_bar(width=64, height=48, bar_len=16,
                                   duration_us=15000, jitter_us=10, seed=4)
    ev.y[:] = np.clip(ev.y, 0, 47)
    ref = FlowEngine(cfg, device=cuda).process(ev)
    assert (ref.r_local > 0).sum() > 40
    padded = dataclasses.replace(cfg, padded_width=68, padded_height=52)
    for make in (lambda: ShardedFlowEngine(cfg, device=cuda),
                 lambda: MultiHostFlowEngine(cfg, device=cuda),
                 lambda: FlowEngine(padded, device=cuda)):
        tk.reset_launches()
        got = make().process(ev)
        assert tk.LAUNCHES["local_flow"] > 0 and tk.LAUNCHES["aperture"] > 0
        for col in ("vx", "vy", "r_local", "theta_local", "r_true",
                    "theta_true", "scale"):
            np.testing.assert_array_equal(getattr(got, col),
                                          getattr(ref, col), err_msg=col)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_input(cuda):
    cfg = TConfig(width=32, height=32)
    center = torch.zeros((32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tk.local_flow(center[None].float(), center, cfg)
    with pytest.raises(ValueError):
        tk.local_flow(center[None], center.t().contiguous()[:, :31], cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 7])
def test_cuda_local_flow_batch_equals_cpu(cuda, k):
    """The per-event plane fit on the card: its sums fold in one order on
    both devices, so the accept flags are the CPU's; the outputs differ
    only through the trig tail's last-ulp rounding."""
    from farms_tpu_torch.ops.local_flow import local_flow_batch
    from test_torch_perevent import _plane_case

    cfg = TConfig(width=40, height=40, filter_size=k)
    arrays = _plane_case(40, 40, seed=k, shift=2**31 - 10000)
    want = local_flow_batch(*(torch.from_numpy(a) for a in arrays), cfg)
    got = local_flow_batch(*(torch.from_numpy(a).to(cuda) for a in arrays),
                           cfg)
    assert torch.equal(got[2].cpu(), want[2]) and want[2].sum() > 20
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("quirk", [False, True])
def test_cuda_aperture_batch_equals_cpu(cuda, quirk):
    """Per-event pooling over the integral kernel's output equals the CPU
    bit for bit: one integral launch, the same float64 corners, one f32
    rounding, true divisions."""
    from farms_tpu_torch.ops import aperture as tap

    cfg = TConfig(width=260, height=200, replicate_y_clamp_quirk=quirk)
    fields = _flow_fields(260, 200, seed=3)
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.integers(0, 260, 5000).astype(np.int32))
    ys = torch.from_numpy(rng.integers(0, 200, 5000).astype(np.int32))

    def pool(dev):
        f = [torch.from_numpy(a).to(dev) for a in fields]
        return tap.aperture_batch(tap.build_integral(*f), f[1], f[2],
                                  xs.to(dev), ys.to(dev), cfg)

    want = pool("cpu")
    tk.reset_launches()
    got = pool(cuda)
    assert tk.LAUNCHES["integral"] == 1 and sum(tk.LAUNCHES.values()) == 1
    assert (want[2] > 0).sum() > 100
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_perevent_and_serial_engines_equal_cpu(cuda):
    """The per-event engine (chunk 256, 2 phases, f32 wire) and the serial
    engine on the card give the CPU's valid flags and scale ids on every
    event, the first with one integral launch per phase and one wire
    decode a call, the second with one integral launch per valid event and
    no other kernel."""
    from farms_tpu_torch.events.io import synthetic_translating_bar
    from farms_tpu_torch.pipeline.engine import FlowEngine
    from farms_tpu_torch.pipeline.serial import SerialFlowEngine

    ev = synthetic_translating_bar(width=64, height=64, bar_len=20,
                                   duration_us=30000, jitter_us=20, seed=1)
    cfg = TConfig(width=64, height=64, chunk_size=256, sub_phases=2,
                  steps_per_scan=2, use_dense=False)
    scfg = TConfig(width=64, height=64, chunk_size=1)
    runs = ((lambda d: FlowEngine(cfg, device=d).process(ev),
             lambda out: 2 * 2 * -(-len(ev) // 512), -(-len(ev) // 512)),
            (lambda d: SerialFlowEngine(scfg, device=d).run(ev[:500],
                                                            quiet=True)[0],
             lambda out: int((out.r_local > 0).sum()), 0))
    for run, integrals, decodes in runs:
        want = run("cpu")
        tk.reset_launches()
        got = run(cuda)
        assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES},
                               "integral": integrals(want),
                               "decode_wire": decodes}
        np.testing.assert_array_equal(got.r_local > 0, want.r_local > 0)
        np.testing.assert_array_equal(got.scale, want.scale)
        valid = want.r_local > 0
        assert valid.sum() > 100
        # the trig tail rounds differently on the two devices: magnitudes
        # within 1e-5 relative, components within 1e-5 of the magnitude
        for col in ("r_local", "r_true"):
            np.testing.assert_allclose(getattr(got, col), getattr(want, col),
                                       rtol=1e-5, atol=1e-6, err_msg=col)
        for col in ("vx", "vy"):
            err = np.abs(getattr(got, col) - getattr(want, col))[valid]
            assert (err <= 1e-5 * want.r_local[valid] + 1e-6).all(), col


@pytest.mark.cuda
def test_cuda_resident_sparse_and_stream_equal_cpu(cuda):
    """On the card: process_resident (the 5-row batch) decodes to
    process()'s output bit for bit; the sparse wire to the f16 wire's; a
    stream of unaligned chunks gives the CPU's valid flags and scale ids;
    each launches the kernels (2 phases a micro-step)."""
    import dataclasses

    from farms_tpu_torch.events.io import synthetic_translating_bar
    from farms_tpu_torch.events.stream import stream_flow
    from farms_tpu_torch.events.io import FlowOutput
    from farms_tpu_torch.pipeline.engine import FlowEngine

    ev = synthetic_translating_bar(width=64, height=64, bar_len=20,
                                   duration_us=30000, jitter_us=20, seed=1)
    cfg = TConfig(width=64, height=64, chunk_size=256, sub_phases=2,
                  wire="f16")
    steps = -(-len(ev) // 256)
    want = FlowEngine(cfg, device=cuda).process(ev)
    eng = FlowEngine(cfg, device=cuda)
    fn, n = eng.process_resident(ev)
    tk.reset_launches()
    main, aux = fn()
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES},
                           "local_flow": 2 * steps, "aperture": 2 * steps,
                           "integral": 2 * steps}
    got = eng._unpack_outputs([(main.cpu().numpy(), aux.cpu().numpy())],
                              ev, n)
    sparse = FlowEngine(dataclasses.replace(cfg, wire="sparse"),
                        device=cuda).process(ev)
    for out in (got, sparse):
        for col in ("vx", "vy", "r_true", "theta_true", "r_local",
                    "theta_local", "scale"):
            a, b = getattr(out, col), getattr(want, col)
            assert a.tobytes() == b.tobytes(), col

    def chunks():
        for s in range(0, len(ev), 300):
            yield ev[s:s + 300]

    card = FlowOutput.concatenate(list(stream_flow(
        FlowEngine(cfg, device=cuda), chunks())))
    cpu = FlowOutput.concatenate(list(stream_flow(
        FlowEngine(cfg, device="cpu"), chunks())))
    np.testing.assert_array_equal(card.r_local > 0, cpu.r_local > 0)
    np.testing.assert_array_equal(card.scale, cpu.scale)
    assert (cpu.r_local > 0).sum() > 100

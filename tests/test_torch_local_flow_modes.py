"""The local-flow modes the fidelity slice adds, against the JAX reference.

- Correction mode: `local_flow_core(..., fold_center=False)` against
  `farms_tpu`'s `dense_local_flow(..., t_center=)` (k = 3 and 5) and the
  Pallas kernel in interpreter mode (k = 3), on stamps that wrap past 2^31.
- Filter sizes past 5 (the general kernel's plain version): against
  `dense_local_flow` run eagerly under `jax.disable_jit()` (its jitted
  graph compiles for minutes at k = 7), in both fold modes, and a
  chunk_size=1 engine run at k = 7 against the float64 oracle.
- Chain length: the engine runs its 129-surface correction chain at
  k = 7 (and 65 at k = 5), and the CUDA engine no longer refuses it when
  built. The kernels' own sizing (csrc/local_flow.cu) is tested on the
  card, in tests/test_torch_cuda.py.

Tolerances are those of tests/test_torch_kernels.py (candidate ids exact off
near-ties, accept flips <= 5e-4, float fields within 0.1% / 5% of the
velocity magnitude).
"""
import numpy as np
import pytest
import torch

from farms_tpu_torch.config import FlowConfig as TConfig
from farms_tpu_torch.events import io as tio
from farms_tpu_torch.ops import dense_flow as tdf
from farms_tpu_torch.ops import kernels as tk
from farms_tpu_torch.pipeline import engine as teng
from farms_tpu_torch.pipeline.oracle import run_oracle

torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from farms_tpu.config import FlowConfig as JConfig  # noqa: E402
from farms_tpu.ops import dense_flow as jdf  # noqa: E402
from farms_tpu.ops.pallas import kernels as pk  # noqa: E402
from test_torch_kernels import _assert_local_equivalent  # noqa: E402


def _chain_and_centers(W, H, seed, n_mid=1):
    """A stamp1 chain (pre, n_mid boundaries, post) and a rank-2 center
    surface. The post surface is a noisy ramp (a bar sweeping the sensor)
    whose stamps cross 2^31 or wrap past 2^32, with a fifth of the cells
    untouched; each earlier surface holds older stamps at a random 30 %
    of the cells; the centers sit a little before the post value at a
    third of the touched pixels (0 elsewhere)."""
    rng = np.random.default_rng(seed)
    px, py = np.meshgrid(np.arange(W), np.arange(H), indexing="ij")
    off = (2**31, 2**32)[seed % 2] - 20000
    ramp = off + 700 * px + 230 * py + rng.integers(0, 40, (W, H))
    touched = rng.random((W, H)) < 0.8
    surfs = [np.where(touched, ramp, 0).astype(np.int64)]
    for _ in range(n_mid + 1):
        hot = (rng.random((W, H)) < 0.3) & (surfs[0] != 0)
        older = surfs[0] - rng.integers(2000, 9000, (W, H))
        surfs.insert(0, np.where(hot, older, surfs[0]))
    post = surfs[-1]
    pick = (rng.random((W, H)) < 0.34) & (post != 0)
    center = np.where(pick, post - rng.integers(1, 600, (W, H)), 0)
    as_i32 = lambda a: (a % 2**32).astype(np.uint32).view(np.int32)
    return [as_i32(a) for a in surfs], as_i32(center)


def _port(chain, center, cfg, fold_center):
    acc, a, b, dtdp, cand = tk.local_flow(
        torch.from_numpy(np.stack(chain)), torch.from_numpy(center), cfg,
        fold_center=fold_center)
    return [o.numpy() for o in tdf.trig_tail(acc, a, b, dtdp)], cand.numpy()


def _jax_dense(chain, center, jc, fold_center):
    """dense_local_flow with the chain split as the JAX engine calls it:
    (pre, boundaries...) and post, plus t_center in correction mode."""
    js = [jnp.asarray(s) for s in chain]
    if fold_center:
        pre = tuple(js) if len(js) > 1 else js[0]
        return jdf.dense_local_flow(pre, jnp.asarray(center), jc,
                                    want_ids=True)
    pre = tuple(js[:-1]) if len(js) > 2 else js[0]
    return jdf.dense_local_flow(pre, js[-1], jc, want_ids=True,
                                t_center=jnp.asarray(center))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("n_mid", [0, 2])
def test_correction_mode_matches_jax_dense(k, n_mid):
    W, H = 48, 40
    jc = JConfig(width=W, height=H, filter_size=k,
                 min_evts_on_plane=5 if k == 3 else 3)
    tc = TConfig(width=W, height=H, filter_size=k,
                 min_evts_on_plane=5 if k == 3 else 3)
    chain, center = _chain_and_centers(W, H, seed=31 + k + n_mid, n_mid=n_mid)
    *ref, rbest, scores = _jax_dense(chain, center, jc, fold_center=False)
    out, pcand = _port(chain, center, tc, fold_center=False)
    assert (pcand >= 0).mean() > 0.5
    assert out[2][center != 0].any()        # some rank-2 fits are valid
    _assert_local_equivalent(ref, rbest, scores, out, pcand,
                             f"correction k{k} chain {n_mid + 2}")
    # not the default mode under another name: folding the center in
    # changes the fits
    base, bcand = _port(chain, center, tc, fold_center=True)
    assert (bcand != pcand).any() or (base[2] != out[2]).any()


def test_correction_mode_matches_pallas_interpret():
    W, H = 48, 40
    jc = JConfig(width=W, height=H)
    tc = TConfig(width=W, height=H)
    chain, center = _chain_and_centers(W, H, seed=41, n_mid=1)
    *_, scores = _jax_dense(chain, center, jc, fold_center=False)
    js = [jnp.asarray(s) for s in chain]
    *ref, rcand = pk.local_flow_pallas(tuple(js[:-1]), js[-1], jc,
                                       want_ids=True,
                                       t_center=jnp.asarray(center))
    out, pcand = _port(chain, center, tc, fold_center=False)
    _assert_local_equivalent(ref, rcand, scores, out, pcand,
                             "pallas correction k3")


@pytest.mark.parametrize("k", [7, 9, 11])
@pytest.mark.parametrize("fold_center", [True, False])
def test_large_filter_matches_jax_dense_eager(k, fold_center):
    """k >= 7 goes to the general kernel, whose plain version is the same
    local_flow_core; held against the JAX dense path run eagerly. k = 11
    (the kernel's radius at run time) on a sensor of at least 4F + 1 rows
    and columns, so that every pixel has an in-bounds window."""
    W, H = (24, 20) if k < 11 else (24, 22)
    kw = dict(width=W, height=H, filter_size=k, min_evts_on_plane=8)
    jc, tc = JConfig(**kw), TConfig(**kw)
    chain, center = _chain_and_centers(W, H, seed=50 + k, n_mid=1)
    if fold_center:
        center = chain[-1]
        chain = chain[:-1]
    with jax.disable_jit():
        *ref, rbest, scores = _jax_dense(chain, center, jc, fold_center)
    out, pcand = _port(chain, center, tc, fold_center)
    assert (pcand >= 0).all() and out[2].any()
    _assert_local_equivalent(ref, rbest, scores, out, pcand,
                             f"k{k} fold_center={fold_center}")


def test_large_filter_long_chain_matches_jax_dense_eager():
    """k = 7 on a chain of 101 surfaces and its center, longer than the
    whole-chain tile the earlier general kernel staged, against the JAX
    dense path run eagerly; the tolerances and near-tie masks of
    test_large_filter_matches_jax_dense_eager."""
    W, H = 24, 20
    kw = dict(width=W, height=H, filter_size=7, min_evts_on_plane=8)
    jc, tc = JConfig(**kw), TConfig(**kw)
    chain, _ = _chain_and_centers(W, H, seed=57, n_mid=100)
    center = chain.pop()
    assert len(chain) == 101
    with jax.disable_jit():
        *ref, rbest, scores = _jax_dense(chain, center, jc, True)
    out, pcand = _port(chain, center, tc, True)
    assert (pcand >= 0).all() and out[2].any()
    _assert_local_equivalent(ref, rbest, scores, out, pcand, "k7 chain 101")


def test_filter_size_7_engine_matches_oracle():
    """chunk_size=1 at k = 7 reproduces the float64 oracle, as
    tests/test_configs_sweep.py holds the JAX engine to it."""
    ev = tio.synthetic_translating_bar(
        width=40, height=40, bar_len=16, duration_us=25000,
        speed_px_per_sec=1500, jitter_us=30, seed=3)[:200]
    cfg = TConfig(width=40, height=40, filter_size=7, min_evts_on_plane=10,
                  chunk_size=1, steps_per_scan=25)
    ref = run_oracle(ev, cfg)
    got = teng.FlowEngine(cfg, device="cpu").process(ev)
    np.testing.assert_array_equal(ref.r_local > 0, got.r_local > 0)
    m = ref.r_local > 0
    assert m.sum() > 30
    np.testing.assert_allclose(got.r_local[m], ref.r_local[m], rtol=1e-4)
    np.testing.assert_allclose(got.r_true[m], ref.r_true[m], rtol=1e-4)
    np.testing.assert_array_equal(ref.scale[m], got.scale[m])


def _chain_lengths_seen(cfg, ev):
    """Chain lengths of every local-flow call of a CPU engine run on ev."""
    seen = []
    local_flow = tk.local_flow

    def recording(chain, *a, **kw):
        seen.append(chain.shape[0])
        return local_flow(chain, *a, **kw)

    tk.local_flow = recording
    try:
        teng.FlowEngine(cfg, device="cpu").process(ev)
    finally:
        tk.local_flow = local_flow
    return sorted(set(seen))


def test_cuda_engine_accepts_129_surface_chain():
    """A correction chain of 1 + P*S = 129 surfaces at k = 7, which no
    whole-chain tile held, passes the CUDA engine's construction checks:
    the engine has none left for the chain (without a card the build
    stops only at "CUDA is not available"). On the CPU the same config
    runs its 16- and 129-surface chains."""
    cfg = TConfig(width=64, height=64, filter_size=7, chunk_size=1024,
                  sub_phases=8, causal_snapshots=16, center_correction=64,
                  steps_per_scan=1)
    if torch.cuda.is_available():
        teng.FlowEngine(cfg, device="cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teng.FlowEngine(cfg, device="cuda")
    ev = tio.synthetic_random_events(1024, width=64, height=64,
                                     rate_hz=2e6, seed=5)
    assert _chain_lengths_seen(cfg, ev) == [16, 129]


def test_long_chain_passes_the_cuda_engine_check():
    """At k = 5 the same shape's 65-surface correction chain (past the
    whole-chain tile the earlier kernel staged): the engine runs a 16- and
    a 65-surface chain. The card run is tests/test_torch_cuda.py's."""
    cfg = TConfig(width=64, height=64, filter_size=5, chunk_size=1024,
                  sub_phases=4, causal_snapshots=16, center_correction=64,
                  steps_per_scan=1)
    ev = tio.synthetic_random_events(1024, width=64, height=64,
                                     rate_hz=2e6, seed=5)
    assert _chain_lengths_seen(cfg, ev) == [16, 65]


def test_wrapper_raises_on_a_device_without_a_kernel():
    cfg = TConfig(width=24, height=20, filter_size=7)
    chain = torch.zeros((1, 24, 20), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no local-flow kernel"):
        tk.local_flow(chain, chain[0], cfg)
    with pytest.raises(ValueError, match="no aperture kernel"):
        z = torch.zeros((24, 20), device="meta")
        tk.aperture(z, z, z, cfg)

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


@pytest.mark.cuda
@pytest.mark.parametrize("geom, quirk", [((320, 320), False),
                                         ((260, 346), True)])
def test_cuda_aperture_kernel_matches_plain(cuda, geom, quirk):
    W, H = geom
    cfg = TConfig(width=W, height=H, replicate_y_clamp_quirk=quirk)
    ins = [torch.from_numpy(a).to(cuda) for a in _flow_fields(W, H, seed=3)]
    tk.reset_launches()
    got = tk.aperture(*ins, cfg)
    assert tk.LAUNCHES["aperture"] == 1
    want = tdf.dense_aperture(*ins, cfg)
    for name, g, w in zip(["tvx", "tvy", "scale"], got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_input(cuda):
    cfg = TConfig(width=32, height=32)
    center = torch.zeros((32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tk.local_flow(center[None].float(), center, cfg)
    with pytest.raises(ValueError):
        tk.local_flow(center[None], center.t().contiguous()[:, :31], cfg)

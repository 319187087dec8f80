"""The histogram kernel on an NVIDIA GPU against its plain torch version.

These tests need a CUDA card and nvcc; elsewhere they skip. They import
no jax, so on a machine with a card and without jax they run without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from histogan_tpu_torch.ops import histogram_cuda
from histogan_tpu_torch.ops.histogram import RGBuvHistBlock, histogram_feature

pytestmark = pytest.mark.cuda

INV_SIGMA2 = 1.0 / (0.02 * 0.02)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from histogan_tpu_torch.utils.platform import setup_runtime

    return setup_runtime("cuda")


def _packed(b, n, seed, dev):
    x = np.random.default_rng(seed).random((b, n, 3), dtype=np.float32)
    return histogram_cuda.pack_pixels(torch.from_numpy(x).to(dev)).contiguous()


def _normalise(h):
    return h / (h.sum(dim=(1, 2, 3), keepdim=True) + histogram_cuda.EPS)


# ragged edges (1, 63, 65 pixels), one chunk and many, and the main path's shapes
@pytest.mark.parametrize("b,n", [(1, 1), (1, 63), (1, 65), (3, 1000), (2, 4096),
                                 (1, 150 * 150), (16, 64 * 64), (8, 250 * 250)])
def test_kernel_matches_plain(dev, b, n):
    packed = _packed(b, n, seed=b * 100003 + n, dev=dev)
    got = histogram_cuda.hist_core(packed, INV_SIGMA2)
    want = histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
    torch.cuda.synchronize()
    assert got.shape == (b, 3, 64, 64)
    assert torch.isfinite(got).all()
    g, w = _normalise(got), _normalise(want)
    err = (g - w).abs().max().item()
    assert err <= 1e-6
    assert err / w.abs().max().item() <= 1e-5
    # un-normalised sums: fp32 accumulated in another order
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_counter_counts_each_launch_once(dev):
    packed = _packed(2, 5000, seed=1, dev=dev)
    before = histogram_cuda.launches
    histogram_cuda.hist_core(packed, INV_SIGMA2)
    histogram_cuda.hist_core_reference(packed, INV_SIGMA2)
    assert histogram_cuda.launches == before + 1


def test_deterministic(dev):
    packed = _packed(4, 22500, seed=2, dev=dev)
    a = histogram_cuda.hist_core(packed, INV_SIGMA2)
    b = histogram_cuda.hist_core(packed, INV_SIGMA2)
    assert torch.equal(a, b)


def test_histogram_feature_on_cuda_goes_through_kernel(dev):
    img = np.random.default_rng(3).random((2, 170, 190, 3), dtype=np.float32)
    before = histogram_cuda.launches
    got = RGBuvHistBlock(insz=150, h=64)(torch.from_numpy(img).to(dev))
    assert histogram_cuda.launches == before + 1
    want = histogram_feature(torch.from_numpy(img))  # plain einsum on the CPU
    assert (got.cpu() - want).abs().max().item() <= 1e-6


def test_other_configs_stay_plain(dev):
    img = torch.from_numpy(np.random.default_rng(4).random((1, 40, 40, 3), dtype=np.float32))
    before = histogram_cuda.launches
    for kw in ({"method": "RBF"}, {"h": 32}, {"green_only": True}, {"space": "lab"}):
        got = histogram_feature(img.to(dev), **kw)
        want = histogram_feature(img, **kw)
        assert (got.cpu() - want).abs().max().item() <= 1e-6
    assert histogram_cuda.launches == before


def test_backward_is_not_ported(dev):
    packed = _packed(1, 100, seed=5, dev=dev).requires_grad_(True)
    out = histogram_cuda.hist_core(packed, INV_SIGMA2)
    with pytest.raises(NotImplementedError):
        out.sum().backward()


def test_rejects_what_the_kernel_does_not_take(dev):
    packed = _packed(1, 100, seed=6, dev=dev)
    with pytest.raises(TypeError):
        histogram_cuda.hist_core(packed.double(), INV_SIGMA2)
    with pytest.raises(ValueError):
        histogram_cuda.hist_core(packed[:, ::2], INV_SIGMA2)
    with pytest.raises(ValueError):
        histogram_cuda.hist_core(packed[..., :7].contiguous(), INV_SIGMA2)

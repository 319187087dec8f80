"""The port's VGG16 perceptual loss (histogan_tpu_torch.ops.vgg) against
the JAX package's (histogan_tpu.ops.vgg), on the CPU, with the seeded
weights of ``random_vgg16_state`` written to a file as a user's would be.

Tolerances: the loss as ``tests/test_vgg.py`` holds the JAX loss to its
torch oracle (2e-4 relative for the feature L1, 1e-3 for the Gram term);
the resize alone 1e-5; the input gradient at 224 px as set out beside
``VGG_GRAD_RTOL``. The 224 px runs take batch 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.ops import vgg as jax_vgg
from histogan_tpu_torch.ops import vgg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg16_random.npz"
    np.savez(path, **vgg.random_vgg16_state(0))
    return str(path)


def _pair(seed, n, size):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 3), dtype=np.float32),
            rng.random((n, size, size, 3), dtype=np.float32))


def test_random_vgg16_state_is_jax_bit_for_bit():
    got, want = vgg.random_vgg16_state(3), jax_vgg.random_vgg16_state(3)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_npz_and_pth_load_the_same_tensors(weights, tmp_path):
    pth = tmp_path / "vgg16.pth"
    torch.save({k: torch.from_numpy(v) for k, v in vgg.random_vgg16_state(0).items()}, pth)
    a, b = vgg.load_vgg16_weights(weights), vgg.load_vgg16_weights(str(pth))
    assert sorted(a) == sorted(b) == sorted(i for blk in vgg._BLOCK_CONVS for i in blk)
    for idx, cin, cout in vgg._VGG16_CONVS:
        assert a[idx][0].shape == (cout, cin, 3, 3) and a[idx][1].shape == (cout,)
        assert torch.equal(a[idx][0], b[idx][0]) and torch.equal(a[idx][1], b[idx][1])
    # OIHW as torchvision stores it, the JAX loader's HWIO transposed back
    w, _ = jax_vgg.load_vgg16_weights(weights)[10]
    assert np.array_equal(a[10][0].numpy(), np.transpose(w, (3, 2, 0, 1)))


def test_missing_weights_raise(monkeypatch):
    monkeypatch.delenv("VGG16_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError):
        vgg.VGGPerceptualLoss()


@pytest.mark.parametrize("feature_layers,style_layers,rtol", [
    ((0, 1, 2, 3), (), 2e-4),
    ((), (0, 1), 1e-3),
])
def test_loss_matches_jax_without_resize(weights, feature_layers, style_layers, rtol):
    a, b = _pair(1, 2, 32)
    want = jax_vgg.VGGPerceptualLoss(weights, resize=False)(
        jnp.asarray(a), jnp.asarray(b), feature_layers=feature_layers, style_layers=style_layers)
    got = vgg.VGGPerceptualLoss(weights, resize=False)(
        torch.from_numpy(a), torch.from_numpy(b), feature_layers, style_layers)
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


@pytest.mark.parametrize("size", [32, 256])
def test_prep_resize_matches_jax(weights, size):
    """Normalise and resize to 224: up from 32, and down from 256 (no
    antialiasing on either side)."""
    x, _ = _pair(2, 1, size)
    want = np.asarray(jax_vgg.VGGPerceptualLoss(weights)._prep(jnp.asarray(x)))
    got = vgg.VGGPerceptualLoss(weights)._prep(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# The input gradient at 224 px, port against JAX, relative to its largest
# entry. Both are fp32: where a feature difference a - b or a ReLU input
# lies within rounding of 0, the L1's sign or the ReLU's slope goes the
# other way on one side, and the resize spreads each such entry over many
# pixels. Measured here (1 thread): the gap 6.9e-4, its median entry
# 4.4e-8; each side 5.5e-3 to 7.4e-3 from the same gradient in float64.
# So the gradient is held to VGG_GRAD_RTOL and, tighter, to no more than
# VGG_F64_FACTOR times JAX's own distance from the float64 gradient.
VGG_GRAD_RTOL = 1e-3
VGG_GRAD_MEDIAN_RTOL = 1e-6
VGG_F64_FACTOR = 1.05


def test_full_loss_and_input_gradient_match_jax(weights):
    a, b = _pair(3, 1, 64)
    jl = jax_vgg.VGGPerceptualLoss(weights)
    want, want_g = jax.value_and_grad(lambda x: jl._loss(x, jnp.asarray(b)))(jnp.asarray(a))
    loss = vgg.VGGPerceptualLoss(weights)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(a).to(dtype).requires_grad_(True)
        got = loss.to(dtype)(x, torch.from_numpy(b).to(dtype))
        got.backward()
        grads[dtype] = x.grad.numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got.item(), float(want), rtol=2e-4)
    want_g = np.asarray(want_g)
    scale = np.abs(want_g).max()
    gap = np.abs(grads[torch.float32] - want_g) / scale
    assert gap.max() < VGG_GRAD_RTOL and np.median(gap) < VGG_GRAD_MEDIAN_RTOL, gap.max()
    exact = grads[torch.float64]
    assert (np.abs(grads[torch.float32] - exact).max()
            <= VGG_F64_FACTOR * np.abs(want_g - exact).max())

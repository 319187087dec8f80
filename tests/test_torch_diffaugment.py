"""The port's DiffAugment (histogan_tpu_torch/ops/diffaugment.py) against
the JAX package's, on the CPU.

The port's functions take their random values as tensors; ``jax_aug_draws``
rebuilds the values that the JAX package draws from a key, split for
split (aug_wrapper: gate, flip, augment; diff_augment: one split per
function; two per translation, cutout and offset). The images are NHWC
(2, 12, 16, 3) for JAX and the same NCHW for the port, not square, so that
an axis taken for the other shows. Translation, cutout, offset and the
flip only move or zero pixels: exact. The color functions do arithmetic
in another order of operations: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.ops import diffaugment as jaug
from histogan_tpu_torch.ops import diffaugment as aug

torch.set_num_threads(1)

COLOR_ATOL = 1e-6
B, H, W = 2, 12, 16
TYPES = ["color", "translation", "cutout", "offset", "offset_h", "offset_v"]


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_fn_values(key, kind, args, b, h, w, dtype=jnp.float32):
    """The values one JAX augmentation function draws from ``key``."""
    if kind == "uniform":
        return [_torch(jax.random.uniform(key, (b, 1, 1, 1), dtype).astype(jnp.float32)
                       ).reshape(b)]
    kx, ky = jax.random.split(key)
    if kind == "translation":
        sh, sw = int(h * args[0] + 0.5), int(w * args[0] + 0.5)
        return [_torch(jax.random.randint(kx, (b, 1, 1), -sh, sh + 1), torch.int64).reshape(b),
                _torch(jax.random.randint(ky, (b, 1, 1), -sw, sw + 1), torch.int64).reshape(b)]
    if kind == "cutout":
        ch, cw = int(h * args[0] + 0.5), int(w * args[0] + 0.5)
        return [_torch(jax.random.randint(kx, (b, 1, 1), 0, h + (1 - ch % 2)),
                       torch.int64).reshape(b),
                _torch(jax.random.randint(ky, (b, 1, 1), 0, w + (1 - cw % 2)),
                       torch.int64).reshape(b)]
    out = []
    for k, m in zip((kx, ky), aug.offset_ranges(h, w, *args)):
        v = (jax.random.randint(k, (b,), 0, m + 1) * 2 - m if m > 0
             else jnp.zeros((b,), jnp.int32))
        out.append(_torch(v, torch.int64))
    return out


def jax_aug_draws(key, b, h, w, prob, types, dtype=jnp.float32) -> aug.AugDraws:
    """The AugDraws of ``histogan_tpu.ops.diffaugment.aug_wrapper(key, ...)``
    on a (b, h, w, C) batch whose compute dtype is ``dtype``."""
    k_gate, k_flip, k_aug = jax.random.split(key, 3)
    values = []
    for _, kind, args in aug.augment_fns(types):
        k_aug, sub = jax.random.split(k_aug)
        values.append(jax_fn_values(sub, kind, args, b, h, w, dtype))
    return aug.AugDraws(apply=bool(jax.random.uniform(k_gate, ()) < prob),
                        flip=bool(jax.random.uniform(k_flip, ()) >= 0.5), values=values,
                        types=tuple(types))


def _images(seed=0):
    x = np.random.default_rng(seed).random((B, H, W, 3), dtype=np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


JAX_FNS = {"brightness": jaug.rand_brightness, "saturation": jaug.rand_saturation,
           "contrast": jaug.rand_contrast, "translation": jaug.rand_translation,
           "cutout": jaug.rand_cutout, "offset": jaug.rand_offset,
           "offset_h": jaug.rand_offset_h, "offset_v": jaug.rand_offset_v}
PORT = {"brightness": ("color", 0), "saturation": ("color", 1), "contrast": ("color", 2),
        "translation": ("translation", 0), "cutout": ("cutout", 0), "offset": ("offset", 0),
        "offset_h": ("offset_h", 0), "offset_v": ("offset_v", 0)}


@pytest.mark.parametrize("name", sorted(JAX_FNS))
def test_each_function_matches_jax(name):
    x, xt = _images(1)
    typ, i = PORT[name]
    fn, kind, args = aug.AUGMENT_FNS[typ][i]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JAX_FNS[name](key, jnp.asarray(x)))
        got = _nhwc(fn(xt, *jax_fn_values(key, kind, args, B, H, W)))
        if typ == "color":
            np.testing.assert_allclose(got, want, atol=COLOR_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got, want)


def test_offset_rolls_w_by_value_h_and_h_by_value_v():
    _, xt = _images(2)
    got = aug.rand_offset(xt, torch.tensor([3, 0]), torch.tensor([0, -5]))
    assert torch.equal(got[0], torch.roll(xt[0], 3, dims=2))  # W
    assert torch.equal(got[1], torch.roll(xt[1], -5, dims=1))  # H
    # value_h's range is the H size, value_v's the W size (the JAX package's)
    assert aug.offset_ranges(H, W, 1.0, 1.0) == (H, W)
    assert aug.offset_ranges(H, W, 1.0, 0.0) == (H, 0)


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_aug_wrapper_matches_jax(prob):
    x, xt = _images(3)
    seen = set()
    wrapper = jax.jit(lambda k, v: jaug.aug_wrapper(k, v, prob, TYPES))
    for seed in range(8):
        key = jax.random.PRNGKey(100 + seed)
        want = np.asarray(wrapper(key, jnp.asarray(x)))
        draws = jax_aug_draws(key, B, H, W, prob, TYPES)
        seen.add((draws.apply, draws.flip))
        got = _nhwc(aug.aug_wrapper(xt, draws))
        np.testing.assert_allclose(got, want, atol=COLOR_ATOL, rtol=0)
        if not draws.apply:
            assert np.array_equal(got, x)
    if prob == 0.0:
        assert {a for a, _ in seen} == {False}
    if prob == 1.0:  # every function ran, flipped and not
        assert seen == {(True, False), (True, True)}


def test_gradient_through_the_augmentation_matches_jax():
    """The gradient penalty differentiates through the wrapper: the
    gradient with respect to the images before it."""
    x, xt = _images(4)
    w = np.random.default_rng(5).standard_normal((B, H, W, 3), dtype=np.float32)
    key = jax.random.PRNGKey(7)
    draws = jax_aug_draws(key, B, H, W, 1.0, TYPES)
    want = jax.grad(lambda v: jnp.sum(jaug.aug_wrapper(key, v, 1.0, TYPES) * w))(jnp.asarray(x))
    xt.requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 3, 1, 2)))
    (got,) = torch.autograd.grad((aug.aug_wrapper(xt, draws) * wt).sum(), xt)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_port_draws_have_the_jax_ranges():
    """draw_aug's values lie where JAX's randint and uniform put them; the
    gate passes about ``prob`` of the batches and the flip half; the coins
    come from the host generator and nothing else."""
    gen = torch.Generator().manual_seed(0)
    coins = torch.Generator().manual_seed(1)
    n, prob = 2000, 0.3
    all_draws = [aug.draw_aug(gen, coins, 8, H, W, prob, TYPES, "cpu") for _ in range(n)]
    assert abs(np.mean([d.apply for d in all_draws]) - prob) < 0.04
    assert abs(np.mean([d.flip for d in all_draws]) - 0.5) < 0.04
    fns = aug.augment_fns(TYPES)
    for i, (_, kind, args) in enumerate(fns):
        vals = [torch.stack([d.values[i][j] for d in all_draws]) for j in
                range(len(all_draws[0].values[i]))]
        if kind == "uniform":
            assert 0.0 <= vals[0].min() and vals[0].max() < 1.0
        elif kind == "translation":
            sh, sw = int(H * 0.125 + 0.5), int(W * 0.125 + 0.5)
            assert (vals[0].min(), vals[0].max()) == (-sh, sh)
            assert (vals[1].min(), vals[1].max()) == (-sw, sw)
        elif kind == "cutout":
            assert (vals[0].min(), vals[0].max()) == (0, H)  # ch = 6: [0, H + 1)
            assert (vals[1].min(), vals[1].max()) == (0, W)
        else:
            for v, m in zip(vals, aug.offset_ranges(H, W, *args)):
                assert v.abs().max() == m and bool(((v + m) % 2 == 0).all())
    c1 = torch.Generator().manual_seed(1)
    again = aug.draw_aug(torch.Generator().manual_seed(9), c1, 8, H, W, prob, TYPES, "cpu")
    first = aug.draw_aug(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1),
                         8, H, W, prob, TYPES, "cpu")
    assert (again.apply, again.flip) == (first.apply, first.flip)

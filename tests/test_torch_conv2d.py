"""``ops/conv2d.py::conv2d``, the discriminator's convolution with its
double backward written out, on the CPU at toy sizes: its first and
second derivatives against finite differences in float64; its forward
and first-order gradients bit for bit those of ``F.conv2d``; a toy D's
gradient penalty and D gradients as with ``F.conv2d`` throughout; and in
the GP step no convolution whose filter is a feature map and no weight
gradient in the GP's first backward."""

import itertools
from contextlib import contextmanager

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from histogan_tpu_torch.models.discriminator import Discriminator
from histogan_tpu_torch.models.layers import DConv
from histogan_tpu_torch.ops import losses
from histogan_tpu_torch.ops.conv2d import conv2d
from histogan_tpu_torch.train import steps

torch.set_num_threads(1)

GRID = list(itertools.product([1, 3], [1, 2], [0, 1], [True, False]))
GRID_IDS = [f"k{k}-s{s}-p{p}-{'bias' if b else 'nobias'}" for k, s, p, b in GRID]


def conv_args(k, bias, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 3, 7, 7, dtype=dtype, generator=g).requires_grad_(True)
    w = torch.randn(4, 3, k, k, dtype=dtype, generator=g).requires_grad_(True)
    b = torch.randn(4, dtype=dtype, generator=g).requires_grad_(True) if bias else None
    return x, w, b


@pytest.mark.parametrize("k,stride,padding,bias", GRID, ids=GRID_IDS)
def test_first_and_second_derivatives_match_finite_differences(k, stride, padding, bias):
    x, w, b = conv_args(k, bias)
    args = (x, w) + ((b,) if bias else ())

    def f(x, w, *b):
        return conv2d(x, w, b[0] if b else None, stride, padding)

    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


@pytest.mark.parametrize("k,stride,padding,bias", GRID, ids=GRID_IDS)
def test_forward_and_first_order_gradients_are_f_conv2ds(k, stride, padding, bias):
    x, w, b = conv_args(k, bias, torch.float32)
    inputs = [t for t in (x, w, b) if t is not None]
    with torch.no_grad():
        assert torch.equal(conv2d(x, w, b, stride, padding), F.conv2d(x, w, b, stride, padding))
    ours, native = conv2d(x, w, b, stride, padding), F.conv2d(x, w, b, stride, padding)
    assert torch.equal(ours, native)
    g = torch.randn(native.shape, generator=torch.Generator().manual_seed(1))
    for a, n in zip(torch.autograd.grad(ours, inputs, g), torch.autograd.grad(native, inputs, g)):
        assert torch.equal(a, n)


@contextmanager
def native_d():
    """D's convolutions through ``F.conv2d`` and aten's own double backward."""
    forward = DConv.forward
    DConv.forward = nn.Conv2d.forward
    try:
        yield
    finally:
        DConv.forward = forward


def toy_d(attn: bool) -> Discriminator:
    torch.manual_seed(0)
    d = Discriminator(32, 2, attn_layers=(1,) if attn else ())
    with torch.no_grad():
        for name, p in d.named_parameters():
            if name.endswith(".g"):  # Rezero's 0 would hide the attention
                p.fill_(0.7)
    return d


def gp_step(d: Discriminator):
    """A D loss on a GP step and D's gradients of it."""
    g = torch.Generator().manual_seed(2)
    fake, real = torch.rand(2, 3, 32, 32, generator=g), torch.rand(2, 3, 32, 32, generator=g)
    loss, _, _, gp = steps.d_loss(d, fake, real, apply_gp=True)
    return gp.detach(), torch.autograd.grad(loss, list(d.parameters()))


@pytest.mark.parametrize("attn", [False, True], ids=["plain_d", "attn_d"])
def test_toy_d_gp_and_gradients_match_the_native_path(attn):
    d = toy_d(attn)
    gp, grads = gp_step(d)
    with native_d():
        gp_n, grads_n = gp_step(d)
    assert gp > 0 and torch.equal(gp, gp_n)  # the first backward is the same aten call
    for (name, _), a, n in zip(d.named_parameters(), grads, grads_n):
        scale = n.abs().max()
        assert scale > 0 or name == "to_logit.bias", name
        assert (a - n).abs().max() <= 1e-5 * max(scale, 1e-30), name


class Convolutions(TorchDispatchMode):
    """Records each ``aten.convolution``'s weight shape and each
    ``aten.convolution_backward``'s output mask."""

    def __init__(self):
        super().__init__()
        self.weights, self.masks = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.weights.append(tuple(args[1].shape))
        elif func is torch.ops.aten.convolution_backward.default:
            self.masks.append(list(args[-1]))
        return func(*args, **(kwargs or {}))


def record_gp_step(d: Discriminator):
    """(first, outer): the convolutions of the GP's forward and first
    backward, and of the D loss's backward through it."""
    g = torch.Generator().manual_seed(2)
    real = torch.rand(2, 3, 32, 32, generator=g)
    with Convolutions() as first:
        logits, q, gp = losses.shared_forward_gradient_penalty(
            lambda x: steps.d_apply(d, x, torch.float32, None), real, has_aux=True)
    with Convolutions() as outer:
        torch.autograd.grad(torch.mean(torch.relu(1.0 - logits)) + q + gp, list(d.parameters()))
    return first, outer


@pytest.mark.parametrize("attn", [False, True], ids=["plain_d", "attn_d"])
def test_gp_step_takes_no_feature_map_filter_and_no_early_weight_gradient(attn):
    d = toy_d(attn)
    n_convs = sum(isinstance(m, DConv) for m in d.modules())
    assert n_convs == (19 + 8 if attn else 19)  # 5 blocks x 3 + 4 downsamples (+ 2 x 4)
    first, outer = record_gp_step(d)
    assert len(first.masks) == n_convs and not any(m[1] for m in first.masks)
    assert all(w[-1] <= 3 and w[-2] <= 3 for w in first.weights + outer.weights)
    # each double backward's weight gradient is one convolution_backward on its own shapes
    assert sum(m == [False, True, False] for m in outer.masks) == n_convs
    with native_d():  # aten's double backward: a filter the size of a feature map
        _, native = record_gp_step(d)
    assert max(w[-1] for w in native.weights) == 32

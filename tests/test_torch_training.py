"""The port's training pieces against the JAX package, on the CPU: the
histogram backward (K2's plain version), the losses, the discriminator
and DiffGrad.

Inputs are made with numpy from a seed and handed to both packages. The
JAX Pallas kernel runs in interpret mode, as its own tests run it; the
port's kernel module runs its plain versions (the CUDA kernels are
tested on the card, tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from histogan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from histogan_tpu.ops import histogram_pallas as jpallas
from histogan_tpu.ops import losses as jlosses
from histogan_tpu.ops.histogram import histogram_feature as jax_histogram_feature
from histogan_tpu.optim.diffgrad import diffgrad as jax_diffgrad
from histogan_tpu.train import convert as jax_convert
from histogan_tpu_torch.models.discriminator import Discriminator
from histogan_tpu_torch.models.layers import TorchConv
from histogan_tpu_torch.ops import histogram_cuda, losses
from histogan_tpu_torch.ops.histogram import histogram_feature
from histogan_tpu_torch.optim.diffgrad import DiffGrad
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.utils.inits import reset_parameters_
from test_torch_models import random_params

torch.set_num_threads(1)

INV_SIGMA2 = 1.0 / (0.02 * 0.02)
ATOL_D = 2e-5  # module forwards, as tests/test_convert.py holds the JAX package


def _packed(b, n, seed):
    flat = np.random.default_rng(seed).random((b, n, 3), dtype=np.float32)
    return np.array(jpallas.pack_pixels(jnp.asarray(flat)))[:, :n]


def _g(b, seed):
    # 1e-3 N(0, 1): the scale of a loss gradient, so dpacked is O(0.1)
    return 1e-3 * np.random.default_rng(seed).standard_normal((b, 3, 64, 64), dtype=np.float32)


# ------------------------------------------------ K2's plain version
@pytest.mark.parametrize("b,n", [(2, 1024), (1, 1000), (2, 4097)])  # 1000, 4097: ragged
def test_hist_core_bwd_reference_matches_jax_vjp(b, n):
    packed, g = _packed(b, n, seed=n), _g(b, seed=n + 1)
    padded = np.array(jpallas._pad_pixels(jnp.asarray(packed)))
    _, vjp = jax.vjp(lambda p: jpallas._hist_core(p, INV_SIGMA2, True), jnp.asarray(padded))
    want = np.asarray(vjp(jnp.asarray(g))[0])[:, :n]
    got = histogram_cuda.hist_core_bwd_reference(
        torch.from_numpy(packed), torch.from_numpy(g), INV_SIGMA2).numpy()
    assert got.shape == (b, n, 8)
    assert np.all(got[..., 7] == 0.0)
    err = np.abs(got - want).max()
    assert err <= 1e-6
    assert err / np.abs(want).max() <= 1e-5


def test_hist_core_bwd_reference_matches_autograd():
    packed = torch.from_numpy(_packed(3, 777, seed=5)).requires_grad_(True)
    g = torch.from_numpy(_g(3, seed=6))
    histogram_cuda.hist_core_reference(packed, INV_SIGMA2).backward(g)
    got = histogram_cuda.hist_core_bwd_reference(packed.detach(), g, INV_SIGMA2)
    assert (got - packed.grad).abs().max().item() <= 1e-5 * packed.grad.abs().max().item()


def test_hist_core_backward_runs_the_plain_backward_on_the_cpu():
    packed = torch.from_numpy(_packed(2, 300, seed=7)).requires_grad_(True)
    g = torch.from_numpy(_g(2, seed=8))
    histogram_cuda.hist_core(packed, INV_SIGMA2).backward(g)
    want = histogram_cuda.hist_core_bwd_reference(packed.detach(), g, INV_SIGMA2)
    assert torch.equal(packed.grad, want)


@pytest.mark.parametrize("shape,resizing", [((2, 48, 48, 3), "sampling"),
                                            ((1, 160, 170, 3), "interpolation"),
                                            ((2, 256, 256, 3), "sampling")])
def test_hellinger_image_gradient_matches_jax(shape, resizing):
    rng = np.random.default_rng(shape[1])
    x = rng.random(shape, dtype=np.float32) * 1.2 - 0.1  # relu and clip both bite
    target = np.asarray(jax_histogram_feature(
        jnp.asarray(rng.random(shape, dtype=np.float32)), resizing=resizing))

    def jax_loss(x):
        return jlosses.hellinger_histogram_loss(
            jnp.asarray(target), jax_histogram_feature(jax.nn.relu(x), resizing=resizing))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = losses.hellinger_histogram_loss(
        torch.from_numpy(target),
        histogram_feature(torch.relu(xt), resizing=resizing))
    loss.backward()
    assert abs(loss.item() - float(jax_loss(jnp.asarray(x)))) <= 1e-5 * abs(loss.item())
    assert np.abs(xt.grad.numpy() - want).max() / np.abs(want).max() < 1e-4


# ------------------------------------------------ the other losses
def test_hinge_divergence_matches_jax():
    rng = np.random.default_rng(0)
    real, fake = rng.standard_normal((2, 16), dtype=np.float32) * 2
    want = float(jlosses.hinge_divergence(jnp.asarray(real), jnp.asarray(fake)))
    got = losses.hinge_divergence(torch.from_numpy(real), torch.from_numpy(fake)).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    # the reference's sign: real logits are pushed negative
    assert losses.hinge_divergence(torch.tensor([-1.0]), torch.tensor([1.0])).item() == 0.0


def _conv_net(seed):
    """A small D-like function of NCHW images in both packages."""
    conv = reset_parameters_(TorchConv(3, 4, 3, padding=1), torch.Generator().manual_seed(seed))
    w = conv.weight.detach().numpy()
    b = conv.bias.detach().numpy()

    def jax_fn(x):  # NHWC
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(w.transpose(2, 3, 1, 0)), (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
        return jnp.mean(jnp.square(jax.nn.leaky_relu(y, 0.2)), axis=(1, 2, 3))

    def torch_fn(x):  # NCHW
        return torch.mean(torch.square(torch.nn.functional.leaky_relu(conv(x), 0.2)),
                          dim=(1, 2, 3))

    return jax_fn, torch_fn, conv


@pytest.mark.parametrize("form", ["separate", "shared"])
def test_gradient_penalty_matches_jax(form):
    x = np.random.default_rng(1).random((3, 8, 8, 3), dtype=np.float32)
    jax_fn, torch_fn, conv = _conv_net(2)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    if form == "separate":
        want = float(jlosses.gradient_penalty(jax_fn, jnp.asarray(x)))
        got = losses.gradient_penalty(torch_fn, xt)
    else:
        want_logits, _, want_gp = jlosses.shared_forward_gradient_penalty(
            lambda v: (jax_fn(v), None), jnp.asarray(x))
        logits, got = losses.shared_forward_gradient_penalty(torch_fn, xt)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=1e-5)
        want = float(want_gp)
    assert abs(got.item() - want) <= 1e-5 * abs(want)
    # differentiable with respect to the parameters (the double backward)
    (gw,) = torch.autograd.grad(got, conv.weight)
    assert torch.isfinite(gw).all() and gw.abs().max() > 0


def test_path_length_matches_jax_and_guards_nan():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 2, 3, 5, 5), dtype=np.float32)
    nchw = losses.path_length_lengths(torch.from_numpy(a), torch.from_numpy(b))
    nhwc = losses.path_length_lengths(torch.from_numpy(a).permute(0, 2, 3, 1),
                                      torch.from_numpy(b).permute(0, 2, 3, 1))
    want = np.asarray(jlosses.path_length_lengths(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(nchw.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(nhwc.numpy(), want, rtol=1e-6)
    for pl_mean in (0.3, float("nan")):
        want = float(jlosses.path_length_penalty(jnp.asarray(want), jnp.float32(pl_mean)))
        got = losses.path_length_penalty(nchw, torch.tensor(pl_mean)).item()
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    assert losses.path_length_penalty(nchw, torch.tensor(float("nan"))).item() == 0.0


# ------------------------------------------------ the discriminator
@pytest.mark.parametrize("size", [32, 64])
def test_discriminator_matches_jax(size):
    x = np.random.default_rng(size).random((2, size, size, 3), dtype=np.float32)
    jd = JaxDiscriminator(size, 4)
    params = random_params(jd, size + 1, jnp.asarray(x))
    want_logits, qloss = jax.jit(jd.apply)({"params": params}, jnp.asarray(x))
    d = Discriminator(size, 4)
    sd = {}
    convert.discriminator_state(params, "D", sd)
    d.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    got, got_q = d(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert got.shape == (2,)
    assert float(qloss) == 0.0 and got_q.item() == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_logits), atol=ATOL_D)


def test_discriminator_bridge_matches_export_and_refuses_unported():
    """The bridge writes export_discriminator's keys and values, with and
    without the attention and VQ layers (which the port now builds), and
    still refuses a key it does not know."""
    for opts in ({}, {"attn_layers": (1,)}, {"fq_layers": (1,)}):
        jd = JaxDiscriminator(32, 2, **opts)
        params = random_params(jd, 9, jnp.zeros((1, 32, 32, 3)))
        vq = ({"vq_0": {k: np.random.default_rng(1).random(s, dtype=np.float32)
                        for k, s in (("embed", (2, 256)), ("embed_avg", (2, 256)),
                                     ("cluster_size", (256,)))}}
              if opts.get("fq_layers") else None)
        want = {}
        jax_convert.export_discriminator(params, "D", want, vq)
        got = {}
        convert.discriminator_state(params, "D", got, vq)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert set(got) == {f"D.{k}" for k in Discriminator(32, 2, **opts).state_dict()}
    with pytest.raises(ValueError, match="attn_9_0"):
        convert.discriminator_state({**params, "attn_9_0": {}}, "D", {})
    with pytest.raises(ValueError, match="vq_9"):
        convert.discriminator_state(params, "D", {}, {"vq_9": {}})


def test_torch_conv_init():
    conv = reset_parameters_(TorchConv(20, 30, 3), torch.Generator().manual_seed(0))
    assert abs(conv.weight.std().item() - (2.0 / 180) ** 0.5) < 0.005
    assert conv.bias.abs().max().item() <= 1.0 / 180 ** 0.5


# ------------------------------------------------ DiffGrad
def test_diffgrad_matches_jax():
    rng = np.random.default_rng(10)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3)}
    params = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
    # three updates; the third gradient repeats some entries of the second
    # (dfc = sigmoid(0) = 0.5 there) and one is 0
    grads = [{k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[2]["a"][0] = grads[1]["a"][0]
    grads[2]["b"][1] = 0.0

    tx = jax_diffgrad(2e-4, 0.5, 0.9)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = DiffGrad(tp.values(), lr=2e-4, betas=(0.5, 0.9), eps=1e-8)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            want = np.asarray(jp[k])
            moved = np.abs(want - params[k]).max()
            # the parameters to 1e-6 of their size, the steps to 1e-5 of theirs
            np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=1e-6, atol=0)
            assert np.abs(tp[k].detach().numpy() - want).max() <= 1e-5 * moved
    for k, p in tp.items():
        state = opt.state[p]
        assert state["step"] == 3
        np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(st.exp_avg[k]), rtol=1e-6)
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(st.exp_avg_sq[k]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(state["previous_grad"].numpy(), grads[-1][k])

"""The port's reHistoGAN modules against the JAX package's, on the CPU:
the filters, the reconstruction and variance losses, the recoloring
encoder-decoder (all four ``skip_conn_to_GAN`` x ``internal_hist``
variants), the GAN head, the recolor forward and the weight bridge.

Weights are random in the flax parameter trees (``random_params``) and
reach the port through ``rehisto_state_dict_from_jax`` with
``strict=True``; inputs are made with numpy from a seed. Images are NHWC
on the JAX side and NCHW in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import RecoloringEncoderDecoder as JaxED
from histogan_tpu.models import RecoloringGAN as JaxRecoloringGAN
from histogan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from histogan_tpu.ops import filters as jfilters
from histogan_tpu.ops import losses as jlosses
from histogan_tpu.ops.histogram import histogram_feature as jax_histogram_feature
from histogan_tpu.train import convert as jax_convert
from histogan_tpu.train import rehisto_steps as jax_rehisto_steps
from histogan_tpu.utils.config import ReHistoGANConfig as JaxReConfig
from histogan_tpu_torch.models.layers import InstanceNorm
from histogan_tpu_torch.models.rehisto import RecoloringEncoderDecoder, RecoloringGAN
from histogan_tpu_torch.models.vectorizers import HistVectorizer
from histogan_tpu_torch.ops import filters, losses
from histogan_tpu_torch.ops.histogram import histogram_feature
from histogan_tpu_torch.train import convert, rehisto_steps
from histogan_tpu_torch.utils.config import ReHistoGANConfig
from test_torch_models import random_params

torch.set_num_threads(1)

# Every output is held by max|port - JAX| <= tol * max(1, max|JAX|): an
# absolute gate for outputs of order 1, relative to the largest entry for
# larger ones, where fp32 rounding alone is larger. With these random
# weights the encoder-decoder's outputs reach ~60, and the JAX and the port
# forwards both sit ~2e-5 from a float64 forward there.
FILTER_TOL = 1e-6  # the fixed filters: up to 27 products summed in another order
LOSS_RTOL = 1e-5  # the losses: means and std's of such filters, relative
ATOL = 2e-5  # module forwards, as tests/test_convert.py holds the JAX package
SIZE, CAP, LATENT, DEPTH, HBIN = 32, 4, 32, 2, 16
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]  # (skip, internal)


def _rand(shape, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random(shape, dtype=np.float32)
    return rng.standard_normal(shape, dtype=np.float32)


def _hists(b, seed, h=HBIN):
    x = _rand((b, 3, h, h), seed, "uniform")
    return x / x.sum(axis=(1, 2, 3), keepdims=True)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------ filters
def test_gaussian_kernel_matches_jax():
    for k, sigma in ((15, 3.0), (15, 5.0), (5, 1.0)):
        want = np.asarray(jfilters.gaussian_kernel(k, sigma))
        got = filters.gaussian_kernel(k, sigma).numpy()
        assert got.shape == (k, k) and got.dtype == np.float32
        _close(got, want, FILTER_TOL)


@pytest.mark.parametrize("op", ["gaussian", "laplacian", "sobel0", "sobel1"])
def test_filters_match_jax(op):
    x = _rand((2, 24, 20, 3), 1, "uniform")
    if op == "gaussian":
        kern = jfilters.gaussian_kernel(15, 5.0)
        want = jfilters.gaussian_op(jnp.asarray(x), kern)
        got = filters.gaussian_op(_nchw(x), filters.gaussian_kernel(15, 5.0))
        assert got.shape == (2, 3, 10, 6)  # VALID: shrinks by k - 1
    elif op == "laplacian":
        want = jfilters.laplacian_op(jnp.asarray(x))
        got = filters.laplacian_op(_nchw(x))
    else:
        d = int(op[-1])
        want = jfilters.sobel_op(jnp.asarray(x), d)
        got = filters.sobel_op(_nchw(x), d)
    if op != "gaussian":
        assert got.shape == (2, 1, 24, 20)  # one channel summing all three, SAME
    _close(_nhwc(got), want, FILTER_TOL)


def test_instance_norm_matches_jax():
    from histogan_tpu.models.layers import InstanceNorm as JaxInstanceNorm

    x = _rand((2, 6, 5, 4), 2) * 3 + 1
    want = np.asarray(JaxInstanceNorm().apply({}, jnp.asarray(x)))
    got = InstanceNorm()(_nchw(x))
    assert list(InstanceNorm().parameters()) == [] and list(InstanceNorm().buffers()) == []
    _close(_nhwc(got), want, ATOL)


# ------------------------------------------------ losses
@pytest.mark.parametrize("variant", ["L1", "1st gradient", "2nd gradient"])
def test_reconstruction_loss_matches_jax(variant):
    a, b = _rand((2, 20, 20, 3), 3, "uniform"), _rand((2, 20, 20, 3), 4, "uniform")
    want = float(jlosses.reconstruction_loss(jnp.asarray(a), jnp.asarray(b), variant))
    got = losses.reconstruction_loss(_nchw(a), _nchw(b), variant).item()
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    with pytest.raises(ValueError):
        losses.reconstruction_loss(_nchw(a), _nchw(b), "3rd gradient")


@pytest.mark.parametrize("hbin", [16, 64])  # 64: the hist-of-hist through K1's plain version
def test_variance_loss_with_hist_of_hist_matches_jax(hbin):
    size = 32
    hist = _hists(2, 5, hbin)
    x_in, x_gen = _rand((2, size, size, 3), 6, "uniform"), _rand((2, size, size, 3), 7, "uniform")
    kern = 5.0

    def jax_value():
        hoh = jax_histogram_feature(jnp.transpose(jax.nn.relu(jnp.asarray(hist)), (0, 2, 3, 1)),
                                    h=hbin, resizing="sampling")
        return float(jlosses.variance_loss(jnp.asarray(hist), hoh, jnp.asarray(x_in),
                                           jnp.asarray(x_gen), jfilters.gaussian_kernel(15, kern),
                                           1.5))

    h = torch.from_numpy(hist)
    hoh = histogram_feature(torch.relu(h).permute(0, 2, 3, 1), h=hbin, resizing="sampling")
    got = losses.variance_loss(h, hoh, _nchw(x_in), _nchw(x_gen),
                               filters.gaussian_kernel(15, kern), 1.5).item()
    want = jax_value()
    assert want < 0
    assert abs(got - want) <= LOSS_RTOL * abs(want)


# ------------------------------------------------ models
def _ed_args(skip, internal, b=2, seed=10):
    x = _rand((b, SIZE, SIZE, 3), seed, "uniform")
    h = _rand((b, LATENT), seed + 1) if internal else _hists(b, seed + 1)
    return x, h


@pytest.mark.parametrize("skip,internal", VARIANTS)
def test_encoder_decoder_matches_jax(skip, internal):
    x, h = _ed_args(skip, internal)
    jed = JaxED(SIZE, CAP, HBIN, LATENT, DEPTH, skip, internal)
    params = random_params(jed, 11, jnp.asarray(x), jnp.asarray(h))
    want = jax.jit(jed.apply)({"params": params}, jnp.asarray(x), jnp.asarray(h))
    out = {}
    convert.encoder_decoder_state(params, "ED", out)
    ed = RecoloringEncoderDecoder(SIZE, CAP, HBIN, LATENT, DEPTH, skip, internal)
    ed.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in out.items()}, strict=True)
    got = ed(_nchw(x), torch.from_numpy(h))
    assert len(got) == (4 if skip else 2)
    shapes = [(2, 8 * CAP, SIZE // 4, SIZE // 4), (2, 3, SIZE // 4, SIZE // 4),
              (2, 4 * CAP, SIZE // 2, SIZE // 2), (2, 2 * CAP, SIZE, SIZE)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        _close(_nhwc(g), w, ATOL)


def test_recoloring_gan_matches_jax_and_ignores_rgb():
    b = 2
    x = _rand((b, SIZE // 4, SIZE // 4, 8 * CAP), 20)
    rgb = _rand((b, SIZE // 4, SIZE // 4, 3), 21)
    h_w = _rand((b, LATENT), 22)
    noise = _rand((b, SIZE, SIZE, 1), 23, "uniform")
    l1, l2 = _rand((b, SIZE // 2, SIZE // 2, 4 * CAP), 24), _rand((b, SIZE, SIZE, 2 * CAP), 25)
    jg = JaxRecoloringGAN(SIZE, LATENT, CAP)
    args = [jnp.asarray(a) for a in (x, rgb, h_w, noise, l1, l2)]
    params = random_params(jg, 26, *args)
    want = np.asarray(jax.jit(jg.apply)({"params": params}, *args))
    out = {}
    for i in range(2):
        convert.generator_block_state(params[f"blocks_{i}"], f"blocks.{i}", out)
    g = RecoloringGAN(SIZE, LATENT, CAP)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in out.items()}, strict=True)
    targs = (_nchw(x), _nchw(rgb), torch.from_numpy(h_w), torch.from_numpy(noise), _nchw(l1),
             _nchw(l2))
    got = g(*targs)
    assert tuple(got.shape) == (b, 3, SIZE, SIZE)
    _close(_nhwc(got), want, ATOL)
    assert torch.equal(got, g(targs[0], None, *targs[2:]))  # the passed rgb is discarded


def _jax_bundle(skip, internal, seed=30, size=SIZE, hbin=HBIN, latent=LATENT, depth=DEPTH):
    """Random JAX recoloring weights {'params_g': {'ED', 'H', 'G'},
    'params_d'} at capacity CAP."""
    x = jnp.zeros((1, size, size, 3))
    hist = jnp.zeros((1, 3, hbin, hbin))
    h_w = jnp.zeros((1, latent))
    jed = JaxED(size, CAP, hbin, latent, depth, skip, internal)
    ed_out = jax.eval_shape(jed.apply, jax.eval_shape(jed.init, jax.random.PRNGKey(0), x,
                                                      h_w if internal else hist),
                            x, h_w if internal else hist)
    pl = ed_out[2:] if skip else (None, None)
    zeros = [None if a is None else jnp.zeros(a.shape) for a in (*ed_out[:2], *pl)]
    return {"params_g": {
        "ED": random_params(jed, seed, x, h_w if internal else hist),
        "H": random_params(JaxHistVectorizer(hbin, latent, depth), seed + 1, hist),
        "G": random_params(JaxRecoloringGAN(size, latent, CAP), seed + 2, zeros[0], zeros[1],
                           h_w, jnp.zeros((1, size, size, 1)), zeros[2], zeros[3])},
        "params_d": random_params(JaxDiscriminator(size, CAP), seed + 3, x)}


def _port_models(sd, skip, internal, size=SIZE, hbin=HBIN):
    parts, others = convert.split_by_prefix(sd, convert.REHISTO_PREFIXES)
    assert others == []
    ed = RecoloringEncoderDecoder(size, CAP, hbin, LATENT, DEPTH, skip, internal)
    hv = HistVectorizer(hbin, LATENT, DEPTH)
    g = RecoloringGAN(size, LATENT, CAP)
    for m, p in ((ed, "ED"), (hv, "H"), (g, "G")):
        m.load_state_dict(parts[p], strict=True)
    return rehisto_steps.RecolorModels(ed, hv, g, None)


@pytest.mark.parametrize("skip,internal", VARIANTS)
def test_recolor_forward_matches_jax(skip, internal):
    """The four-way ED/G dispatch, end to end through the bridge."""
    bundle = _jax_bundle(skip, internal)
    jcfg = JaxReConfig(image_size=SIZE, network_capacity=CAP, latent_dim=LATENT,
                       style_depth=DEPTH, hist_bin=HBIN, skip_conn_to_GAN=skip,
                       internal_hist=internal)
    jmodels = jax_rehisto_steps.RecolorModels(
        JaxED(SIZE, CAP, HBIN, LATENT, DEPTH, skip, internal),
        JaxHistVectorizer(HBIN, LATENT, DEPTH), JaxRecoloringGAN(SIZE, LATENT, CAP), None)
    x = _rand((2, SIZE, SIZE, 3), 31, "uniform")
    hist = _hists(2, 32)
    noise = _rand((2, SIZE, SIZE, 1), 33, "uniform")
    want = np.asarray(jax.jit(lambda p, a, b, c: jax_rehisto_steps.recolor_forward(
        jmodels, p, a, b, c, jcfg))(bundle["params_g"], jnp.asarray(x), jnp.asarray(hist),
                                    jnp.asarray(noise)))
    cfg = ReHistoGANConfig(image_size=SIZE, network_capacity=CAP, latent_dim=LATENT,
                           style_depth=DEPTH, hist_bin=HBIN, skip_conn_to_GAN=skip,
                           internal_hist=internal)
    models = _port_models(convert.rehisto_state_dict_from_jax(bundle), skip, internal)
    with torch.no_grad():
        got = rehisto_steps.recolor_forward(models, _nchw(x), torch.from_numpy(hist),
                                            torch.from_numpy(noise), cfg)
    assert tuple(got.shape) == (2, 3, SIZE, SIZE)
    _close(_nhwc(got), want, ATOL)


# ------------------------------------------------ the weight bridge
@pytest.mark.parametrize("skip,internal", VARIANTS)
def test_rehisto_state_dict_from_jax_matches_export_bitwise(skip, internal):
    bundle = _jax_bundle(skip, internal, seed=40)
    want = jax_convert.export_rehistogan_checkpoint(bundle)
    got = convert.rehisto_state_dict_from_jax(bundle)
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == set(convert.REHISTO_PREFIXES)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert convert.detect_rehistogan_variant(got) == jax_convert.detect_rehistogan_variant(want) \
        == {"skip_conn_to_GAN": skip, "internal_hist": internal}

"""The port's modules (histogan_tpu_torch.models / ops.conv2dmod) against
the JAX package's flax modules, on the CPU.

Weights are random in the flax modules' parameter trees (so that the
zero-initialised noise projections matter), are bridged by ``state_dict_from_jax``'s helpers into
the reference layout and loaded with ``strict=True``. Outputs are compared
in NHWC at atol 2e-5, the convention of tests/test_convert.py; the full
generator chains 12 modulated convs summed in another order and is held
to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.models.blocks import GeneratorBlock as JaxGeneratorBlock
from histogan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from histogan_tpu.models.generator import Generator as JaxGenerator
from histogan_tpu.models.vectorizers import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models.vectorizers import StyleVectorizer as JaxStyleVectorizer
from histogan_tpu.ops.conv2dmod import conv2d_mod as jax_conv2d_mod
from histogan_tpu.train import convert as jax_convert
from histogan_tpu_torch.models.blocks import GeneratorBlock
from histogan_tpu_torch.models.generator import Generator, generator_filters
from histogan_tpu_torch.models.layers import TorchLinear
from histogan_tpu_torch.models.vectorizers import HistVectorizer, StyleVectorizer
from histogan_tpu_torch.ops.conv2dmod import conv2d_mod
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.utils.inits import reset_parameters_

torch.set_num_threads(1)

ATOL = 2e-5
ATOL_G = 1e-4


def _rand(shape, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random(shape, dtype=np.float32)
    return rng.standard_normal(shape, dtype=np.float32)


def random_params(module, seed, *args):
    """Random weights in the flax module's parameter tree (its shapes come
    from ``eval_shape``, so nothing compiles): kernels N(0, 2/fan_in), 1-d
    leaves N(0, 0.01), so the zero-initialised noise projections are live."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(leaf):
        scale = 0.1 if len(leaf.shape) == 1 else (2.0 / np.prod(leaf.shape[:-1])) ** 0.5
        return scale * rng.standard_normal(leaf.shape, dtype=np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _load(module, state_fn, tree):
    out = {}
    state_fn(tree, "m", out)
    module.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in out.items()},
                           strict=True)
    return module


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("demod", [True, False])
def test_conv2d_mod(demod, kernel):
    x = _rand((2, 6, 6, 5), 0)
    w = _rand((kernel, kernel, 5, 7), 1) * 0.3
    s = _rand((2, 5), 2)
    want = np.asarray(jax_conv2d_mod(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), demod=demod))
    got = conv2d_mod(_nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                     torch.from_numpy(s), demod=demod)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)


@pytest.mark.parametrize("case", ["up_up", "noup_up", "up_noup_prev", "latent", "overrides"])
def test_generator_block(case):
    latent, cin, cout = 8, 6, 5
    upsample = case != "noup_up"
    upsample_rgb = case != "up_noup_prev"
    hw = 5
    s = 2 * hw if upsample else hw
    x = _rand((2, hw, hw, cin), 10)
    istyle = _rand((2, latent), 11)
    inoise = _rand((2, s + 3, s + 3, 1), 12, "uniform")  # cropped to s x s
    prev = _rand((2, s, s, 3), 13) if case == "up_noup_prev" else None
    lat = _rand((2, s, s, cout), 14) if case == "latent" else None
    jblk = JaxGeneratorBlock(latent, cin, cout, upsample=upsample, upsample_rgb=upsample_rgb)
    params = random_params(jblk, 15, jnp.asarray(x), None, jnp.asarray(istyle), jnp.asarray(inoise))
    jkw, tkw = {}, {}
    if case == "overrides":
        st1, st2, rs = _rand((2, cin), 16), _rand((2, cout), 17), _rand((2, cout), 18)
        n1, n2 = _rand((2, s, s, cout), 19), _rand((2, s, s, cout), 20)
        jkw = dict(style1=st1, style2=st2, rgb_style=rs, noise1=n1, noise2=n2)
        tkw = dict(style1=torch.from_numpy(st1), style2=torch.from_numpy(st2),
                   rgb_style=torch.from_numpy(rs), noise1=_nchw(n1), noise2=_nchw(n2))
        jkw = {k: jnp.asarray(v) for k, v in jkw.items()}
    want_x, want_rgb = jax.jit(jblk.apply)(
        {"params": params}, jnp.asarray(x), None if prev is None else jnp.asarray(prev),
        jnp.asarray(istyle), jnp.asarray(inoise), None if lat is None else jnp.asarray(lat),
        **jkw)
    blk = _load(GeneratorBlock(latent, cin, cout, upsample, upsample_rgb),
                convert.generator_block_state, params)
    got_x, got_rgb = blk(_nchw(x), None if prev is None else _nchw(prev),
                         torch.from_numpy(istyle), torch.from_numpy(inoise),
                         None if lat is None else _nchw(lat), **tkw)
    np.testing.assert_allclose(_nhwc(got_x), np.asarray(want_x), atol=ATOL)
    np.testing.assert_allclose(_nhwc(got_rgb), np.asarray(want_rgb), atol=ATOL)


def test_noise_quirk_transposes():
    """A noise image that is not symmetric must land transposed."""
    blk = reset_parameters_(GeneratorBlock(4, 3, 2, upsample=False), torch.Generator().manual_seed(0))
    with torch.no_grad():
        blk.conv1.weight.zero_()  # conv2's input is then leaky_relu(noise1)
        blk.to_noise1.weight.fill_(1.0)
    noise = torch.arange(16.0).reshape(1, 4, 4, 1)
    seen = {}
    blk.conv2.register_forward_pre_hook(lambda m, args: seen.update(x=args[0]))
    blk(torch.zeros(1, 3, 4, 4), None, torch.zeros(1, 4), noise)
    for f in range(2):
        assert torch.equal(seen["x"][0, f], noise[0, :, :, 0].T)


def test_style_vectorizer():
    z = _rand((4, 16), 30)
    jsv = JaxStyleVectorizer(emb=16, depth=3)
    params = random_params(jsv, 31, jnp.asarray(z))
    sv = _load(StyleVectorizer(16, 3), convert.style_vectorizer_state, params)
    np.testing.assert_allclose(sv(torch.from_numpy(z)).detach().numpy(),
                               np.asarray(jsv.apply({"params": params}, jnp.asarray(z))), atol=ATOL)


def test_hist_vectorizer():
    h = _rand((2, 3, 8, 8), 40, "uniform")
    jhv = JaxHistVectorizer(insize=8, emb=16, depth=3)
    params = random_params(jhv, 41, jnp.asarray(h))
    hv = _load(HistVectorizer(8, 16, 3), convert.hist_vectorizer_state, params)
    assert [tuple(p.shape) for p in hv.fcs.parameters()][::2] == [(32, 192), (16, 32), (16, 16)]
    np.testing.assert_allclose(hv(torch.from_numpy(h)).detach().numpy(),
                               np.asarray(jhv.apply({"params": params}, jnp.asarray(h))), atol=ATOL)


def test_generator():
    size, latent, cap = 32, 16, 2
    nl = 4
    styles = _rand((2, nl - 2, latent), 50)
    hists = _rand((2, 2, latent), 51)
    noise = _rand((2, size, size, 1), 52, "uniform")
    jg = JaxGenerator(size, latent, cap)
    params = random_params(jg, 53, jnp.asarray(styles), jnp.asarray(hists), jnp.asarray(noise))
    want = np.asarray(jax.jit(jg.apply)({"params": params}, jnp.asarray(styles),
                                        jnp.asarray(hists), jnp.asarray(noise)))
    g = _load(Generator(size, latent, cap), convert.generator_state, params)
    got = g(torch.from_numpy(styles), torch.from_numpy(hists), torch.from_numpy(noise))
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL_G)


def test_state_dict_from_jax_matches_export_bitwise():
    size, latent, cap, depth, hbin = 16, 16, 2, 2, 8
    nl = 3
    z, h = jnp.zeros((1, latent)), jnp.zeros((1, 3, hbin, hbin))
    g_args = (jnp.zeros((1, nl - 2, latent)), jnp.zeros((1, 2, latent)),
              jnp.zeros((1, size, size, 1)))
    params_g = {
        "S": random_params(JaxStyleVectorizer(latent, depth), 4, z),
        "H": random_params(JaxHistVectorizer(hbin, latent, depth), 5, h),
        "G": random_params(JaxGenerator(size, latent, cap), 6, *g_args),
    }
    bundle = {
        "params_g": params_g,
        "ema": {"S": random_params(JaxStyleVectorizer(latent, depth), 7, z),
                "H": random_params(JaxHistVectorizer(hbin, latent, depth), 8, h),
                "G": random_params(JaxGenerator(size, latent, cap), 9, *g_args)},
        "params_d": random_params(JaxDiscriminator(size, cap), 10, jnp.zeros((1, size, size, 3))),
    }
    want = jax_convert.export_histogan_checkpoint(bundle)
    got = convert.state_dict_from_jax(bundle)
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == set(convert.PREFIXES)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_init_scheme_and_seed():
    lin = TorchLinear(200, 300)
    reset_parameters_(lin, torch.Generator().manual_seed(0))
    assert abs(lin.weight.std().item() - (2.0 / 200) ** 0.5) < 0.005
    assert lin.bias.abs().max().item() <= 1.0 / 200 ** 0.5
    zero = reset_parameters_(TorchLinear(1, 8, zero_init=True), torch.Generator().manual_seed(0))
    assert not zero.weight.any() and not zero.bias.any()
    a = reset_parameters_(Generator(16, 8, 2), torch.Generator().manual_seed(5)).state_dict()
    b = reset_parameters_(Generator(16, 8, 2), torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [(cin, cout) for cin, cout in generator_filters(16, 2)] == [(8, 16), (16, 8), (8, 4)]

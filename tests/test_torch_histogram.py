"""The port's histogram feature (histogan_tpu_torch.ops) against the JAX
package and the golden vectors, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port's kernel module runs here through its plain torch version (the CUDA
kernel itself is tested on the card, tests/test_torch_cuda.py); the JAX
Pallas kernel runs in interpret mode, as its own tests run it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.ops import histogram as jhist
from histogan_tpu.ops import histogram_pallas as jpallas
from histogan_tpu_torch.ops import histogram as thist
from histogan_tpu_torch.ops import histogram_cuda

torch.set_num_threads(1)

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "hist_golden.npz"))
TOL = 1e-5  # as tests/test_histogram.py: hist feature L1 < 1e-5 vs the reference
TOL_THRESHOLDING = 5e-4  # step-function flips on fp64-vs-fp32 boundaries, as there
PARITY = 1e-6  # port vs JAX, both fp32 on the CPU


def _img(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _nhwc(x_nchw):
    return np.ascontiguousarray(np.transpose(x_nchw, (0, 2, 3, 1)))


def _port(x, **kw):
    return thist.histogram_feature(torch.from_numpy(x), **kw).numpy()


# ------------------------------------------------ port vs JAX, every option
@pytest.mark.parametrize("resizing", ["interpolation", "sampling"])
@pytest.mark.parametrize("method", ["inverse-quadratic", "RBF", "thresholding"])
@pytest.mark.parametrize("space", ["rgb-uv", "rg-chroma", "lab"])
def test_matches_jax(space, method, resizing):
    x = _img((2, 40, 36, 3), seed=3)
    boundary = (-3.0, 3.0) if space == "rgb-uv" else (0.0, 1.0)
    kw = dict(space=space, method=method, resizing=resizing, h=16, insz=24,
              boundary=boundary, intensity_scale=space == "rgb-uv")
    want = np.asarray(jhist.histogram_feature(jnp.asarray(x), **kw))
    got = _port(x, **kw)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= PARITY


@pytest.mark.parametrize("kw", [
    {"green_only": True, "h": 32},
    {"intensity_scale": False},
    {"space": "rg-chroma", "intensity_scale": True, "boundary": (0.0, 1.0)},
    {"space": "lab", "intensity_scale": True, "boundary": (0.0, 1.0)},
    {"boundary": (2.0, -2.0)},
], ids=["green_only", "no_intensity", "rg_intensity", "lab_intensity", "boundary"])
def test_matches_jax_options(kw):
    x = _img((2, 30, 34, 4), seed=7)  # RGBA: the alpha channel is dropped
    want = np.asarray(jhist.histogram_feature(jnp.asarray(x), **kw))
    assert np.abs(_port(x, **kw) - want).max() <= PARITY


# ------------------------------------------------ port vs the golden vectors
@pytest.mark.parametrize("method", ["inverse-quadratic", "RBF", "thresholding"])
@pytest.mark.parametrize("resizing", ["interpolation", "sampling"])
@pytest.mark.parametrize("size", ["big", "small"])
def test_golden_rgbuv(method, resizing, size):
    want = GOLDEN[f"rgbuv_{method}_{resizing}_{size}"]
    got = _port(_nhwc(GOLDEN[f"img_{size}"]), h=64, insz=150, resizing=resizing,
                method=method, sigma=0.02)
    tol = TOL_THRESHOLDING if method == "thresholding" else TOL
    assert got.shape == want.shape
    assert np.abs(got - want).max() < tol


def test_golden_other_blocks():
    big, small = GOLDEN["img_big"], GOLDEN["img_small"]
    got = _port(_nhwc(big), h=32, green_only=True)
    assert got.shape == (2, 1, 32, 32)
    assert np.abs(got - GOLDEN["rgbuv_green_big"]).max() < 4 * TOL  # h=32: 4x the mass per bin
    assert np.abs(_port(_nhwc(small), intensity_scale=False)
                  - GOLDEN["rgbuv_noscale_small"]).max() < TOL
    rg = thist.rgChromaHistBlock(h=64, insz=150, data_format="NCHW")(torch.from_numpy(big))
    assert rg.shape == (2, 1, 64, 64)
    assert np.abs(rg.numpy() - GOLDEN["rgchroma_big"]).max() < TOL
    lab = thist.LabHistBlock(h=64, insz=150, data_format="NCHW")(big)
    assert np.abs(lab.numpy() - GOLDEN["lab_big"]).max() < TOL


def test_block_wrappers():
    x = _img((50, 50, 3), seed=4)
    out = thist.HistBlock()(x)
    assert out.shape == (1, 3, 64, 64)
    np.testing.assert_array_equal(out.numpy(), _port(x[None]))
    assert thist.RGBuvHistBlock(device="cuda").intensity_scale  # reference kwarg dropped


# ------------------------------------------------ the kernel module
@pytest.mark.parametrize("shape,resizing", [((2, 64, 64, 3), "sampling"),
                                            ((1, 170, 190, 3), "interpolation")])
def test_histogram_feature_cuda_matches_pallas(shape, resizing):
    # 170x190: the resize quirk, and a pixel count that is no multiple of 512
    x = _img(shape, seed=shape[1])
    want = np.asarray(jpallas.histogram_feature_pallas(
        jnp.asarray(x), resizing=resizing, interpret=True))
    got = histogram_cuda.histogram_feature_cuda(torch.from_numpy(x), resizing=resizing).numpy()
    assert np.abs(got - want).max() <= PARITY


def test_kernel_config_matches_dense_path():
    x = torch.from_numpy(_img((2, 70, 60, 3), seed=11))
    a = histogram_cuda.histogram_feature_cuda(x, insz=50)
    b = thist.histogram_feature(x, insz=50)
    assert (a - b).abs().max().item() <= PARITY


def test_hist_core_reference_matches_jax_core():
    flat = _img((2, 1000, 3), seed=12)
    packed = np.array(jpallas.pack_pixels(jnp.asarray(flat)))  # padded to 1024
    want = np.asarray(jpallas._hist_core(jnp.asarray(packed), 2500.0, True))
    got = histogram_cuda.hist_core_reference(torch.from_numpy(packed), 2500.0).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= PARITY
    norm = lambda h: h / (h.sum(axis=(1, 2, 3), keepdims=True) + 1e-6)
    assert np.abs(norm(got) - norm(want)).max() <= PARITY


def test_pack_pixels_matches_jax():
    flat = _img((2, 600, 3), seed=13)
    want = np.asarray(jpallas.pack_pixels(jnp.asarray(flat)))[:, :600]
    got = histogram_cuda.pack_pixels(torch.from_numpy(flat)).numpy()
    assert got.shape == (2, 600, 8)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("batch,n", [(1, 1), (1, 63), (1, 150 * 150), (16, 64 * 64),
                                     (8, 250 * 250), (300, 4096)])
def test_split_pixels_covers_every_pixel(batch, n):
    chunk, n_chunks = histogram_cuda.split_pixels(batch, n, num_sms=132)
    assert chunk % histogram_cuda.TILE == 0
    assert (n_chunks - 1) * chunk < n <= n_chunks * chunk
    assert n_chunks == 1 or chunk >= histogram_cuda.MIN_CHUNK


def test_no_fallback_off_the_cpu():
    packed = torch.empty((1, 10, 8), device="meta")
    with pytest.raises(ValueError):
        histogram_cuda.hist_core(packed, 2500.0)
    with pytest.raises(ValueError):
        histogram_cuda.histogram_feature_cuda(torch.zeros(1, 8, 8, 3), h=32)


def test_build_dir_is_beside_the_package():
    pkg = os.path.dirname(os.path.dirname(histogram_cuda.__file__))
    assert str(histogram_cuda.BUILD_DIR).startswith(os.path.join(os.path.dirname(pkg), "build"))
    assert set(histogram_cuda.SOURCES) == {"histogram_fwd", "histogram_bwd"}
    paths = {name: histogram_cuda.library_path(name) for name in histogram_cuda.SOURCES}
    for name, src in histogram_cuda.SOURCES.items():
        assert src.is_file()
        assert paths[name].parent == histogram_cuda.BUILD_DIR
        assert paths[name].name.startswith(f"lib{name}-")  # each keyed on its own source
    assert len(set(paths.values())) == 2

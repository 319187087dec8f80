"""The port's host post-processing (``histogan_tpu_torch/post``,
``histogan_tpu_torch/native``) against the JAX package's on the CPU.

The same seeded numpy inputs go through both packages: ``imresize``,
``MKL`` and ``color_transfer_MKL``, ``pyramid_upsampling`` and the scipy
BGU (``bgu_fit``, ``bgu_slice``, ``bgu_upsample``) are float64 numpy on
both sides, so they are held to 1e-12. The native (C++) BGU solves the
same system by conjugate gradient instead of a direct solve, so it is
held to the scipy backend at the tolerance of ``tests/test_bgu_native.py``
(5e-3 on the sliced image).
"""

import importlib
import os
import shutil

import numpy as np
import pytest
import torch

from histogan_tpu_torch import native

# the modules, not the functions that the packages' post/__init__ exports
# under the same names
jax_bgu, jax_imresize, jax_mkl, jax_pyramid = (
    importlib.import_module(f"histogan_tpu.post.{m}") for m in ("bgu", "imresize", "mkl", "pyramid"))
bgu, bgu_native, imresize, mkl, pyramid = (
    importlib.import_module(f"histogan_tpu_torch.post.{m}")
    for m in ("bgu", "bgu_native", "imresize", "mkl", "pyramid"))

torch.set_num_threads(1)

EXACT = 1e-12  # float64 numpy on both sides
NATIVE_TOL = 5e-3  # CG against a direct solve, on the sliced image (tests/test_bgu_native.py)


def _image(h=48, w=40, seed=0):
    """A smooth image with structure and a little noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 9.0) * 0.5 + 0.5, (y / h) * 0.8 + 0.1,
                    ((x + y) % 17) / 17.0], axis=-1)
    return np.clip(img + rng.random((h, w, 3)) * 0.05, 0, 1)


@pytest.mark.parametrize("case", ["bicubic_up", "bicubic_down_antialias", "bilinear_shape",
                                  "uint8_down", "grey_2d"])
def test_imresize_matches_jax(case):
    img = _image(30, 26, seed=1)
    args = {"bicubic_up": (img, dict(scalar_scale=2.0, method="bicubic")),
            "bicubic_down_antialias": (img, dict(scalar_scale=0.4, method="bicubic")),
            "bilinear_shape": (img, dict(output_shape=(41, 17), method="bilinear")),
            "uint8_down": ((img * 255).astype(np.uint8), dict(scalar_scale=0.5)),
            "grey_2d": (img[..., 0], dict(output_shape=(12, 50)))}[case]
    got = imresize.imresize(args[0], **args[1])
    want = jax_imresize.imresize(args[0], **args[1])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


def test_imresize_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        imresize.imresize(_image(), method="lanczos", scalar_scale=2.0)
    with pytest.raises(ValueError):
        imresize.imresize(_image())


@pytest.mark.parametrize("seed", [2, 3])
def test_mkl_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src = rng.random((24, 20, 3)) * 0.4
    tgt = np.clip(rng.random((18, 30, 3)) * 0.5 + 0.4, 0, 1)
    a, b = np.cov(src.reshape(-1, 3), rowvar=False), np.cov(tgt.reshape(-1, 3), rowvar=False)
    np.testing.assert_allclose(mkl.MKL(a, b), jax_mkl.MKL(a, b), rtol=0, atol=EXACT)
    got = mkl.color_transfer_MKL(src, tgt)
    want = jax_mkl.color_transfer_MKL(src, tgt)
    assert got.shape == src.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    # the linear map carries the target's mean (clip aside)
    np.testing.assert_allclose(got.mean((0, 1)), tgt.mean((0, 1)), atol=5e-2)


@pytest.mark.parametrize("levels,swapping,blending,shape", [
    (3, 1, False, (50, 45)), (3, 1, True, (50, 45)), (4, 2, False, (64, 64)),
    (4, 1, True, (64, 64)), (5, 1, False, (40, 70))])
def test_pyramid_upsampling_matches_jax(levels, swapping, blending, shape):
    ref = _image(*shape, seed=4)
    tgt = np.clip(ref[::3, ::3] * 0.7 + 0.2, 0, 1)
    kw = dict(levels=levels, swapping_levels=swapping, blending=blending)
    got = pyramid.pyramid_upsampling(tgt, ref, **kw)
    want = jax_pyramid.pyramid_upsampling(tgt, ref, **kw)
    m = 2 ** levels
    assert got.shape == want.shape == (-(-shape[0] // m) * m, -(-shape[1] // m) * m, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


def test_pyramid_blending_past_one_swapped_level_raises_in_both():
    """The reference's blend weights have levels - swapping + 1 entries but
    are read at indices up to levels - 1: with blending, more than one
    swapped level runs off their end in both packages."""
    ref = _image(64, 64, seed=4)
    for fn in (pyramid.pyramid_upsampling, jax_pyramid.pyramid_upsampling):
        with pytest.raises(IndexError):
            fn(ref[::2, ::2], ref, levels=4, swapping_levels=2, blending=True)


def test_bgu_fit_and_slice_match_jax():
    img = _image(80, 72, seed=5)
    ds_in = imresize.imresize(img, output_shape=(40, 36))
    ds_out = np.clip(ds_in * 0.6 + 0.2, 0, 1)
    edge = bgu.rgb2luminance(ds_in)
    assert bgu.default_grid_size(ds_in, ds_out) == jax_bgu.default_grid_size(ds_in, ds_out)
    for weight in (None, np.ones_like(ds_out), np.linspace(0.5, 1.5, ds_out.size)
                   .reshape(ds_out.shape)):
        got = bgu.bgu_fit(ds_in, edge, ds_out, weight_ds=weight)
        want = jax_bgu.bgu_fit(ds_in, edge, ds_out, weight_ds=weight)
        assert got.shape == want.shape == (2, 2, 8, 3, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    gamma = bgu.bgu_fit(ds_in, edge, ds_out)
    full_edge = bgu.rgb2luminance(img)
    np.testing.assert_allclose(bgu.bgu_slice(gamma, img, full_edge),
                               jax_bgu.bgu_slice(gamma, img, full_edge), rtol=0, atol=EXACT)


@pytest.mark.parametrize("max_ds", [300, 16])
def test_bgu_upsample_scipy_matches_jax(max_ds):
    img = _image(44, 38, seed=6)
    low = np.clip(imresize.imresize(img, output_shape=(22, 20)) ** 1.5, 0, 1)
    got = bgu.bgu_upsample(img, low, max_ds=max_ds, backend="scipy")
    want = jax_bgu.bgu_upsample(img, low, max_ds=max_ds, backend="scipy")
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


def test_bgu_recovers_an_affine_operator():
    img = _image(48, 40, seed=7)
    m = np.array([[0.7, 0.1, 0.0], [0.0, 0.8, 0.1], [0.2, 0.0, 0.6]])
    bias = np.array([0.05, 0.0, 0.1])
    ds_in = imresize.imresize(img, output_shape=(24, 20))
    out = bgu.bgu_upsample(img, np.clip(ds_in @ m.T + bias, 0, 1))
    assert np.abs(out - np.clip(img @ m.T + bias, 0, 1)).mean() < 1e-3


needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")


@needs_gxx
def test_native_library_builds_under_build_native():
    so = native.build()
    assert so.is_file() and so.parent == native.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "native")
    assert not list(so.parent.glob("*.tmp"))
    assert native.load_library() is native.load_library()


@needs_gxx
def test_native_bgu_matches_the_scipy_backend():
    img = _image(40, 40, seed=8)
    ds_in = imresize.imresize(img, output_shape=(20, 20))
    ds_out = np.clip(ds_in * 0.6 + 0.2, 0, 1)
    edge = bgu.rgb2luminance(ds_in)
    g_scipy = bgu.bgu_fit(ds_in, edge, ds_out)
    g_native = bgu_native.bgu_fit_native(ds_in, edge, ds_out)
    assert g_native.shape == g_scipy.shape
    full_edge = bgu.rgb2luminance(img)
    sliced = bgu_native.bgu_slice_native(g_native, img, full_edge)
    assert np.abs(sliced - bgu.bgu_slice(g_scipy, img, full_edge)).max() < NATIVE_TOL
    # the slice itself is exact: the same gamma through both slicers
    np.testing.assert_allclose(bgu_native.bgu_slice_native(g_scipy, img, full_edge),
                               bgu.bgu_slice(g_scipy, img, full_edge), rtol=0, atol=1e-10)


@needs_gxx
def test_native_slice_stays_inside_a_one_cell_grid():
    """A 20x20 fit has a grid one cell high and wide (round(20 / 16) = 1):
    the slice's far corners then have weight 0 and must not be read past
    the grid. The grid lies in front of NaN memory, so any read past it
    shows."""
    img = _image(40, 40, seed=8)
    ds_in = imresize.imresize(img, output_shape=(20, 20))
    gamma = bgu.bgu_fit(ds_in, bgu.rgb2luminance(ds_in), np.clip(ds_in * 0.6 + 0.2, 0, 1))
    assert gamma.shape[:2] == (1, 1)
    fenced = np.full((2, *gamma.shape[1:]), np.nan)
    fenced[:1] = gamma
    full_edge = bgu.rgb2luminance(img)
    np.testing.assert_allclose(bgu_native.bgu_slice_native(fenced[:1], img, full_edge),
                               bgu.bgu_slice(gamma, img, full_edge), rtol=0, atol=1e-10)


@needs_gxx
def test_bgu_backend_dispatch(monkeypatch):
    img = _image(36, 32, seed=9)
    low = imresize.imresize(img, output_shape=(18, 16)) * 0.8
    by_scipy = bgu.bgu_upsample(img, low, backend="scipy")
    by_native = bgu.bgu_upsample(img, low, backend="native")
    assert np.abs(by_scipy - by_native).max() < NATIVE_TOL
    monkeypatch.setenv("HISTOGAN_BGU", "native")
    np.testing.assert_array_equal(bgu.bgu_upsample(img, low), by_native)
    monkeypatch.setenv("HISTOGAN_BGU", "scipy")
    np.testing.assert_array_equal(bgu.bgu_upsample(img, low), by_scipy)
    monkeypatch.delenv("HISTOGAN_BGU")
    np.testing.assert_array_equal(bgu.bgu_upsample(img, low), by_scipy)  # the default
    with pytest.raises(ValueError, match="unknown BGU backend"):
        bgu.bgu_upsample(img, low, backend="matlab")


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build is an error, never a quiet fall back to scipy."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    with pytest.raises((RuntimeError, FileNotFoundError)):
        native.build()
    assert not list((tmp_path / "native").glob("*.so"))


def test_post_exports_what_the_jax_package_exports():
    import histogan_tpu.post as jax_post
    import histogan_tpu_torch.post as post

    names = {n for n in vars(jax_post) if not n.startswith("_")
             and not isinstance(getattr(jax_post, n), type(os))}
    assert names == {"imresize", "color_transfer_MKL", "MKL", "pyramid_upsampling"}
    assert all(callable(getattr(post, n)) for n in names)

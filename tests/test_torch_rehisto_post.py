"""reHistoGAN's full-resolution output, post-recoloring and face extraction
in the port, against the JAX package's on the CPU.

The JAX package draws the recolor's noise from its own key, so the two
packages never share a recolor. For the post-processing path each side's
recolor is replaced by the same array (JAX's ``_recolor``, the port's
``recolor``): ``RecoloringTrainer.evaluate`` and ``process_image`` of both
packages then write their files from one recolored image, and the files
must be equal pixel for pixel (both write the same float32 grid through
PIL's JPEG encoder). The recolor itself is held to JAX's through
``recolor_forward`` on shared noise in ``tests/test_torch_rehisto.py``
(fp32) and ``tests/test_torch_rehisto_bf16.py`` (bf16).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.cli import rehistogan as jax_cli
from histogan_tpu.train.rehisto_trainer import RecoloringTrainer as JaxRecoloringTrainer
from histogan_tpu.utils import face_preprocessing as jax_fp
from histogan_tpu.utils.config import ReHistoGANConfig as JaxReConfig
from histogan_tpu_torch.cli import rehistogan as cli
from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
from histogan_tpu_torch.utils import face_preprocessing as fp

torch.set_num_threads(1)

SIZE, HBIN = 32, 16
BORDER = 4  # save_image_grid's padding, 2 px a side


def _photo(path, h, w, seed):
    """A smooth photo (colour blocks plus noise), H x W, written as JPEG."""
    rng = np.random.default_rng(seed)
    base = rng.random((-(-h // 8), -(-w // 8), 3)) * 255
    img = np.kron(base, np.ones((8, 8, 1)))[:h, :w] + rng.normal(0, 10, (h, w, 3))
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=95)
    return path


def _pinned(n, seed=1):
    """A recolored batch with entries outside [0, 1], as a recolor gives."""
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3), dtype=np.float32) * 1.4 - 0.2


def _pair(tmp_path, recolored):
    """The JAX package's evaluate on a bare trainer and the port's, each
    with its recolor replaced by ``recolored``; results under tmp_path/jax
    and tmp_path/port."""
    jax_t = types.SimpleNamespace(cfg=JaxReConfig(image_size=SIZE, hist_bin=HBIN),
                                  results_dir=tmp_path / "jax", name="re",
                                  _recolor=lambda img, hist: jnp.asarray(recolored))
    jax_t.evaluate = types.MethodType(JaxRecoloringTrainer.evaluate, jax_t)
    port = RecoloringTrainer("re", str(tmp_path / "port"), str(tmp_path / "m"), device="cpu",
                             image_size=SIZE, network_capacity=2, hist_bin=HBIN)
    port.recolor = lambda img, hist: torch.clamp(torch.from_numpy(recolored), 0.0, 1.0)
    return jax_t, port


def _same_file(a, b):
    ia, ib = Image.open(a), Image.open(b)
    assert ia.size == ib.size, (a, ia.size, ib.size)
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib), err_msg=str(b))
    return ia.size


@pytest.mark.parametrize("mode", ["pyramid", "pyramid_blend", "BGU", "downscaling",
                                  "post_recoloring", "pyramid_post_recoloring", "none"])
def test_evaluate_matches_jax(tmp_path, mode):
    big = mode not in ("downscaling",)
    h, w = (96, 80) if big else (20, 24)
    src = _photo(tmp_path / "photo.jpg", h, w, seed=3)
    original = np.asarray(Image.open(src).convert("RGB")) / 255.0
    resizing = {"pyramid": "upscaling", "pyramid_blend": "upscaling", "BGU": "upscaling",
                "downscaling": "downscaling", "pyramid_post_recoloring": "upscaling"}.get(mode)
    kw = dict(image_batch=np.zeros((1, SIZE, SIZE, 3), np.float32),
              hist_batch=np.zeros((1, 3, HBIN, HBIN), np.float32), resizing=resizing,
              resizing_method="BGU" if mode == "BGU" else "pyramid", pyramid_levels=4,
              level_blending=mode == "pyramid_blend", original_size=[w, h],
              input_image_name=str(src), original_image=original,
              post_recoloring=mode.endswith("post_recoloring"), save_input=False)
    recolored = _pinned(1)
    jax_t, port = _pair(tmp_path, recolored)
    jax_t.evaluate("out", **kw)
    got = port.evaluate("out", **kw)
    np.testing.assert_array_equal(got, np.clip(recolored, 0, 1))
    size = _same_file(tmp_path / "jax" / "re" / "out-generated.jpg",
                      tmp_path / "port" / "re" / "out-generated.jpg")
    # every grid has save_image_grid's 2 px border (BORDER), but the
    # downscaled file, which PIL resizes to the photo's size; the pyramid
    # pads to a multiple of 2**4 = 16, which 96 x 80 already is
    want = (w + BORDER, h + BORDER) if mode != "none" else (SIZE + BORDER, SIZE + BORDER)
    assert size == ((w, h) if mode == "downscaling" else want)
    assert not (tmp_path / "port" / "re" / "out-input.jpg").exists()


def test_evaluate_pyramid_returns_the_padded_size(tmp_path):
    """The reference's quirk, kept: the pyramid's output is the photo's size
    padded up to a multiple of 2**levels, here 100 x 90 -> 128 x 96 (and
    the grid's border)."""
    src = _photo(tmp_path / "odd.jpg", 100, 90, seed=4)
    jax_t, port = _pair(tmp_path, _pinned(1, seed=2))
    kw = dict(image_batch=np.zeros((1, SIZE, SIZE, 3), np.float32),
              hist_batch=np.zeros((1, 3, HBIN, HBIN), np.float32), resizing="upscaling",
              resizing_method="pyramid", pyramid_levels=5, input_image_name=str(src),
              save_input=False)
    jax_t.evaluate(0, **kw)
    port.evaluate(0, **kw)
    assert _same_file(tmp_path / "jax" / "re" / "0-generated.jpg",
                      tmp_path / "port" / "re" / "0-generated.jpg") == (96 + BORDER, 128 + BORDER)


@pytest.mark.parametrize("h,w,upsampling,method,post", [
    (96, 80, True, "pyramid", False), (96, 80, True, "BGU", True),
    (20, 24, True, "pyramid", False), (20, 24, False, "pyramid", True)])
def test_process_image_matches_jax(tmp_path, monkeypatch, h, w, upsampling, method, post):
    """Both CLIs' process_image on one photo toward a target .npy: the same
    file names (the clock fixed) and the same files."""
    src = _photo(tmp_path / "photo.jpg", h, w, seed=5)
    target = np.random.default_rng(6).random((1, 3, HBIN, HBIN)).astype(np.float32)
    np.save(tmp_path / "target.npy", target / target.sum())

    class Clock:
        @staticmethod
        def now():
            import datetime

            return datetime.datetime(2024, 1, 2, 3, 4, 5)

    monkeypatch.setattr(jax_cli, "datetime", Clock)
    monkeypatch.setattr(cli, "datetime", Clock)
    recolored = _pinned(1, seed=7)
    jax_t, port = _pair(tmp_path, recolored)
    kw = dict(image_size=SIZE, upsampling_output=upsampling, upsampling_method=method,
              post_recoloring=post, hist_bin=HBIN)
    jax_cli.process_image(jax_t, "re", str(src), str(tmp_path / "target.npy"),
                          results_dir=str(tmp_path / "jax"), rng=np.random.default_rng(8), **kw)
    cli.process_image(port, "re", str(src), str(tmp_path / "target.npy"),
                      results_dir=str(tmp_path / "port"), rng=np.random.default_rng(8), **kw)
    names = sorted(p.name for p in (tmp_path / "port" / "re").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "re").iterdir())
    assert len(names) == 1 and names[0].startswith("output-target-01-02-2024_03-04-05-")
    size = _same_file(tmp_path / "jax" / "re" / names[0], tmp_path / "port" / "re" / names[0])
    if post:  # MKL of the original photo overwrites whatever was written
        assert size == (w + BORDER, h + BORDER)
    elif upsampling and h > SIZE:  # pyramid_levels 5 pads 96 x 80 to 96 x 96
        assert size == {"pyramid": (96 + BORDER, 96 + BORDER), "BGU": (w + BORDER, h + BORDER)}[method]
    elif upsampling:  # downscaled to the photo's size
        assert size == (w, h)


def _landmarks(cx=100.0, cy=100.0, eye_dx=30.0, mouth_dy=40.0):
    """A 68-point layout with plausible eye and mouth geometry."""
    lm = np.zeros((68, 2))
    lm[36:42] = [cx - eye_dx, cy - 10]
    lm[42:48] = [cx + eye_dx, cy - 10]
    lm[48] = [cx - 15, cy + mouth_dy]
    lm[54] = [cx + 15, cy + mouth_dy]
    return lm


@pytest.mark.parametrize("size,lm,out_size", [
    ((200, 200), _landmarks(), 64),  # the padded (reflect + blur) path
    ((240, 260), _landmarks(130, 120, 12, 16), 16),  # a crop, no padding
    ((400, 400), _landmarks(200, 200, 70, 90), 32)])  # the shrink path
def test_align_face_matches_jax(tmp_path, size, lm, out_size):
    src = _photo(tmp_path / "face.jpg", *size, seed=9)
    kw = dict(output_size=out_size, transform_size=4 * out_size)
    jax_fp.align_face(str(src), lm, str(tmp_path / "jax.png"), **kw)
    fp.align_face(str(src), lm, str(tmp_path / "port.png"), **kw)
    assert _same_file(tmp_path / "jax.png", tmp_path / "port.png") == (out_size, out_size)


@pytest.fixture
def detector(monkeypatch):
    monkeypatch.setattr(fp, "_detector", lambda path: _landmarks(80, 80, 20, 28))


def test_face_extraction_with_a_registered_detector(tmp_path, monkeypatch):
    src = _photo(tmp_path / "f.jpg", 160, 160, seed=10)
    fp.set_landmark_detector(lambda path: _landmarks(80, 80, 20, 28))
    try:
        out = fp.face_extraction(str(src), dst_dir=str(tmp_path / "faces"), output_size=32)
    finally:
        monkeypatch.setattr(fp, "_detector", None)
    assert out == str(tmp_path / "faces" / "f.jpg")
    assert Image.open(out).size == (32, 32)


def test_face_extraction_without_a_detector_raises(tmp_path, monkeypatch):
    src = _photo(tmp_path / "g.jpg", 64, 64, seed=11)
    monkeypatch.setattr(fp, "_detector", None)
    monkeypatch.setitem(__import__("sys").modules, "dlib", None)  # no dlib, as here
    with pytest.raises(RuntimeError, match="set_landmark_detector"):
        fp.face_extraction(str(src), dst_dir=str(tmp_path / "faces"))
    assert not (tmp_path / "faces").exists()


def test_cli_face_extraction_pre_pass(tmp_path, monkeypatch, detector):
    """--face_extraction True aligns the input photo (or each photo of a
    folder) into ./temp-faces/ and recolors that instead, as the JAX CLI."""
    monkeypatch.chdir(tmp_path)
    # the alignment at a small size (its default, 1024 from 4096, is held by
    # the tests above and costs seconds a face)
    align = fp.align_face
    monkeypatch.setattr(fp, "align_face", lambda src, lm, dst, output_size:
                        align(src, lm, dst, output_size=64, transform_size=128))
    photos = tmp_path / "photos"
    photos.mkdir()
    for i, name in enumerate(("a.jpg", "b.png")):
        _photo(photos / name, 160, 160, seed=12 + i)
    (photos / "notes.txt").write_text("not a photo")
    target = np.full((1, 3, HBIN, HBIN), 1.0 / (3 * HBIN * HBIN), np.float32)
    np.save(tmp_path / "t.npy", target)
    seen = []
    real = cli.process_image

    def spy(model, name, input_image, *args, **kwargs):
        seen.append(input_image)
        return real(model, name, input_image, *args, **kwargs)

    monkeypatch.setattr(cli, "process_image", spy)
    base = ["--generate", "True", "--face_extraction", "True", "--target_hist", "t.npy",
            "--image_size", str(SIZE), "--network_capacity", "2", "--hist_bin", str(HBIN),
            "--device", "cpu", "--new", "True", "--name", "re", "--results_dir", "res",
            "--models_dir", "mod"]
    cli.main([*base, "--input_image", str(photos / "a.jpg")])
    assert seen == ["./temp-faces/a.jpg"]  # as the JAX CLI names it
    assert Image.open("temp-faces/a.jpg").size == (64, 64)
    (tmp_path / "temp-faces" / "stale.jpg").write_bytes(b"")
    seen.clear()
    cli.main([*base, "--input_image", str(photos)])
    assert sorted(p.name for p in (tmp_path / "temp-faces").iterdir()) == ["a.jpg", "b.png"]
    assert [p.split("/")[-1] for p in seen] == ["a.jpg", "b.png"]
    assert len(list((tmp_path / "res" / "re").glob("output-t-*-generated.jpg"))) >= 1
    with pytest.raises(Exception, match="not supported"):
        cli.main([*base, "--input_image", str(photos / "notes.txt")])


def test_cli_upsampling_and_post_recoloring_flags_reach_evaluate(tmp_path, monkeypatch):
    """rehistogan-torch's flags go through train_from_folder and
    process_image into evaluate, with process_image's resizing decision."""
    src = _photo(tmp_path / "in.jpg", 70, 50, seed=14)
    np.save(tmp_path / "t.npy", np.full((1, 3, HBIN, HBIN), 1.0 / (3 * HBIN * HBIN), np.float32))
    calls = []
    monkeypatch.setattr(RecoloringTrainer, "evaluate",
                        lambda self, num, **kw: calls.append(kw))
    cli.main(["--generate", "True", "--input_image", str(src), "--target_hist",
              str(tmp_path / "t.npy"), "--image_size", str(SIZE), "--network_capacity", "2",
              "--hist_bin", str(HBIN), "--device", "cpu", "--new", "True",
              "--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
              "--upsampling_output", "True", "--upsampling_method", "BGU",
              "--pyramid_levels", "3", "--swapping_levels", "2", "--level_blending", "True",
              "--post_recoloring", "True"])
    (kw,) = calls
    assert kw["resizing"] == "upscaling" and kw["resizing_method"] == "BGU"
    assert (kw["pyramid_levels"], kw["swapping_levels"], kw["level_blending"]) == (3, 2, True)
    assert kw["post_recoloring"] is True and kw["original_size"] == [50, 70]
    assert kw["input_image_name"] == str(src) and kw["original_image"].shape == (70, 50, 3)

"""The port's histogram-pool CLIs (``histogan-create-hist-data-torch``,
``histogan-create-hist-sample-torch``) against the JAX package's on the
same folder of seeded JPEGs, on the CPU (where the port's histogram runs
the histogram kernel's plain version): the histograms within the repo's
histogram gate, L1 < 1e-5 (BASELINE.md), and the shapes and default
output paths of the JAX CLIs.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.cli import create_hist_data as jax_data
from histogan_tpu.cli import create_hist_sample as jax_sample
from histogan_tpu_torch.cli import create_hist_data, create_hist_sample

torch.set_num_threads(1)

HIST_L1 = 1e-5  # the repo's histogram gate (ROADMAP.md, BASELINE.md)


@pytest.fixture
def photos(tmp_path):
    """Four seeded JPEGs of one size (one JAX compile)."""
    root = tmp_path / "histogram_data"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        base = rng.random((6, 5, 3)) * 255
        img = np.kron(base, np.ones((10, 10, 1))) + rng.normal(0, 8, (60, 50, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(root / f"{i}.jpg")
    return root


def _l1(a, b):
    return np.abs(a - b).sum(axis=(-3, -2, -1)).max()


def test_create_hist_data_matches_jax(photos, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default --input_dir is ./histogram_data/
    out = create_hist_data.main(["--device", "cpu"])
    assert out.as_posix() == "histogram_data/histograms.npy"
    got = np.load(photos / "histograms.npy")
    jax_data.main(["--output", str(tmp_path / "jax.npy")])
    want = np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (4, 1, 3, 64, 64) and got.dtype == np.float32
    assert _l1(got, want) < HIST_L1
    np.testing.assert_allclose(got.sum(axis=(2, 3, 4)), 1.0, atol=1e-5)

    # the flags the JAX CLI has, with another bin count and resizing
    flags = ["--input_dir", str(photos), "--hist_bin", "16", "--hist_insz", "40",
             "--hist_resizing", "interpolation"]
    create_hist_data.main([*flags, "--output", str(tmp_path / "p16.npy"), "--device", "cpu"])
    jax_data.main([*flags, "--output", str(tmp_path / "j16.npy")])
    got, want = np.load(tmp_path / "p16.npy"), np.load(tmp_path / "j16.npy")
    assert got.shape == want.shape == (4, 1, 3, 16, 16)
    assert _l1(got, want) < HIST_L1


def test_create_hist_data_refuses_an_empty_folder(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        create_hist_data.main(["--input_dir", str(tmp_path / "empty"), "--device", "cpu"])
    if not torch.cuda.is_available():  # no silent move to the CPU
        with pytest.raises(RuntimeError):
            create_hist_data.main(["--input_dir", str(tmp_path / "empty")])


def test_create_hist_sample_matches_jax(photos, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default --output_dir is ./histograms/
    src = photos / "2.jpg"
    out = create_hist_sample.main(["--image", str(src), "--device", "cpu"])
    assert out.as_posix() == "histograms/2.npy"
    got = np.load(tmp_path / "histograms" / "2.npy")
    jax_sample.main(["--image", str(src), "--output_dir", str(tmp_path / "jax")])
    want = np.load(tmp_path / "jax" / "2.npy")
    assert got.shape == want.shape == (1, 3, 64, 64) and got.dtype == np.float32
    assert _l1(got, want) < HIST_L1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_hist_sample.main(["--image", str(src)])


def test_a_pool_feeds_rehistogan_sampling(photos, tmp_path):
    """The pool the port writes is what ``rehistogan-torch --sampling``
    reads: five-way mixes of its (N, 1, 3, h, h) entries."""
    from histogan_tpu_torch.cli import rehistogan as cli

    create_hist_data.main(["--input_dir", str(photos), "--hist_bin", "16",
                           "--output", str(tmp_path / "pool.npy"), "--device", "cpu"])
    cli.main(["--generate", "True", "--input_image", str(photos / "0.jpg"), "--sampling", "True",
              "--target_number", "2", "--histogram_pool", str(tmp_path / "pool.npy"),
              "--image_size", "32", "--network_capacity", "2", "--hist_bin", "16",
              "--device", "cpu", "--new", "True", "--results_dir", str(tmp_path / "res"),
              "--models_dir", str(tmp_path / "mod"), "--name", "re"])
    assert len(list((tmp_path / "res" / "re").glob("*-output-*-generated.jpg"))) == 2

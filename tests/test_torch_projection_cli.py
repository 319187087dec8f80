"""The port's projection CLIs (histogan-projection-gaussian-torch and
histogan-projection-to-latent-torch) on the CPU: their flags and defaults
against the JAX package's, a toy run of each and of its ``--generate``
toward a .npy, a JPEG and a folder, and the options the port refuses."""

import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.cli import projection_gaussian as jax_gaussian
from histogan_tpu.cli import projection_to_latent as jax_to_latent
from histogan_tpu.cli.projection_common import build_parser as jax_build_parser
from histogan_tpu_torch.cli import projection_gaussian, projection_to_latent
from histogan_tpu_torch.cli.projection_common import build_parser

torch.set_num_threads(1)

ENTRIES = [("gaussian", projection_gaussian, jax_gaussian, "./results_projection_gaussian"),
           ("latent", projection_to_latent, jax_to_latent, "./results_projection_to_latent")]


@pytest.mark.parametrize("mode,port,jax_cli,results", ENTRIES, ids=["gaussian", "to_latent"])
def test_parser_defaults_match_jax(mode, port, jax_cli, results):
    got = vars(build_parser(results, defaults=port.REFERENCE_DEFAULTS).parse_args([]))
    want = vars(jax_build_parser(results, defaults=jax_cli.REFERENCE_DEFAULTS).parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    args = build_parser(results).parse_args(
        ["--random_styles", "3", "4", "--latent_noise", "True", "--device", "cpu", "--gpu", "1"])
    assert args.random_styles == [3, 4] and args.latent_noise is True and args.device == "cpu"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    (root / "targets").mkdir()
    for path, shape in ((root / "input.jpg", (40, 36, 3)), (root / "target.jpg", (30, 30, 3)),
                        (root / "targets" / "a.png", (20, 24, 3))):
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(path)
    h = rng.random((1, 3, 64, 64)).astype(np.float32)
    np.save(root / "hist.npy", h / h.sum())
    np.save(root / "targets" / "b.npy", h / h.sum())
    (root / "targets" / "notes.txt").write_text("skipped")
    return root


@pytest.mark.parametrize("mode,port,jax_cli,results", ENTRIES, ids=["gaussian", "to_latent"])
def test_cli_projects_then_recolors(mode, port, jax_cli, results, images, tmp_path, capsys):
    common = ["--device", "cpu", "--name", "m", "--image_size", "32", "--network_capacity", "2",
              "--models_dir", str(tmp_path / "models"), "--results_dir", str(tmp_path / "res"),
              "--input_image", str(images / "input.jpg")]
    port.main([*common, "--num_train_steps", "2", "--save_every", "1",
               "--vgg_loss_weight", "0", "--optimize_noise", "True"])
    out_dir = tmp_path / "res" / "m" / "input"
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        [f"input_{k}.{e}" for k in ("1", "2", "final") for e in ("jpg", "npz")]
        + ["input_start.jpg"])
    final = np.load(out_dir / "input_final.npz")
    assert ("styles" in final.files) == (mode == "gaussian")
    assert final["in_noise"].shape == (1, 32, 32, 1)
    logged = [l for l in capsys.readouterr().out.splitlines() if l.startswith("Optimization step")]
    assert len(logged) == 2

    for target, n in (("hist.npy", 1), ("target.jpg", 1), ("targets", 2)):
        before = set(out_dir.glob("generated-*.jpg"))
        port.main([*common, "--generate", "True", "--optimize_noise", "True",
                   "--target_hist", str(images / target), "--random_styles", "1"])
        made = set(out_dir.glob("generated-*.jpg")) - before
        assert len(made) == n and all(Image.open(p).size == (32, 32) for p in made), target
    assert "notes.txt is not supported" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--attn_layers", "--fq_layers"])
def test_cli_refuses_the_options_not_ported(flag, tmp_path):
    with pytest.raises(NotImplementedError):
        projection_gaussian.main(["--device", "cpu", "--image_size", "32",
                                  "--network_capacity", "2", "--models_dir", str(tmp_path),
                                  "--results_dir", str(tmp_path), flag, "1"])

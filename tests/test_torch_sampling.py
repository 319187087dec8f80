"""The port's sampling slice (Trainer, CLI) against the JAX package, on
the CPU.

One JAX Trainer per module: the port's Trainer takes its weights through
the bridge, the same truncation centre ``av``, latents, noise and target
image, and the two ``evaluate`` outputs agree within 1e-4 (4 latents at
batch size 2, so the chunking and the tile doubling run).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.cli import histogan as jax_cli
from histogan_tpu.models import Discriminator as JaxDiscriminator
from histogan_tpu.models import Generator as JaxGenerator
from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import StyleVectorizer as JaxStyleVectorizer
from histogan_tpu.ops.histogram import RGBuvHistBlock as JaxRGBuvHistBlock
from histogan_tpu.train import Trainer as JaxTrainer
from histogan_tpu.train import convert as jax_convert
from histogan_tpu.train.state import HistoGANState
from histogan_tpu_torch.cli import histogan as cli
from histogan_tpu_torch.ops.histogram import RGBuvHistBlock
from histogan_tpu_torch.train import convert
from histogan_tpu_torch.train.trainer import Trainer
from test_torch_models import random_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2,
             hist_bin=64, batch_size=2, seed=0)
ATOL = 1e-4  # 4 generator blocks of fp32 convs summed in another order


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """A JAX Trainer holding random weights, with a distinct EMA so that
    sampling from the live weights would show. Its modules and state are
    set as init_GAN sets them; init_GAN itself would add some 35 s of
    eager flax inits on a CPU, and evaluate needs only these."""
    root = tmp_path_factory.mktemp("jax_sampling")
    t = JaxTrainer(name="j", results_dir=str(root / "r"), models_dir=str(root / "m"),
                   num_devices=1, **SMALL)
    cfg = t.cfg
    t.S = JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth)
    t.H = JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth)
    t.G = JaxGenerator(cfg.image_size, cfg.latent_dim, cfg.network_capacity, cfg.transparent)
    nl, size = cfg.num_layers, cfg.image_size
    args = {"S": (jnp.zeros((1, cfg.latent_dim)),),
            "H": (jnp.zeros((1, 3, cfg.hist_bin, cfg.hist_bin)),),
            "G": (jnp.zeros((1, nl - 2, cfg.latent_dim)), jnp.zeros((1, 2, cfg.latent_dim)),
                  jnp.zeros((1, size, size, 1)))}

    def params(seed):
        return {k: random_params(getattr(t, k), seed + i, *args[k]) for i, k in enumerate("SHG")}

    t.state = HistoGANState(
        step=jnp.zeros((), jnp.int32), params_g=params(0),
        params_d=random_params(JaxDiscriminator(size, cfg.network_capacity), 5,
                               jnp.zeros((1, size, size, 3))),
        ema=params(10), opt_g=None, opt_d=None, pl_mean=jnp.zeros(()))
    t.av = 0.1 * np.random.default_rng(0).standard_normal((1, cfg.latent_dim), dtype=np.float32)
    return t


@pytest.fixture(scope="module")
def bundle(jax_trainer):
    return jax_convert.bundle_from_trainer(jax_trainer)


def _port_trainer(tmp_path, bundle, av):
    t = Trainer(name="p", results_dir=str(tmp_path / "r"), models_dir=str(tmp_path / "m"),
                device="cpu", **SMALL)
    t.init_GAN()
    assert t.load_state_dict(convert.state_dict_from_jax(bundle)) == []
    t.av = torch.from_numpy(av)
    return t


def test_evaluate_matches_jax(jax_trainer, bundle, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.random((160, 170, 3), dtype=np.float32)  # resized to 150x150
    latents = rng.standard_normal((4, SMALL["latent_dim"]), dtype=np.float32)
    noise = rng.random((4, 32, 32, 1), dtype=np.float32)

    jblock = JaxRGBuvHistBlock(insz=150, h=64, resizing="interpolation")
    jhist = jax_cli.tile_double(np.asarray(jblock(img[None])), 2)
    want = jax_trainer.evaluate(None, hist_batch=jnp.asarray(jhist),
                                latents=jnp.asarray(latents), n=jnp.asarray(noise))

    port = _port_trainer(tmp_path, bundle, jax_trainer.av)
    block = RGBuvHistBlock(insz=150, h=64, resizing="interpolation")
    got = cli.sample_target(port, block, image=img, num_image_tiles=2,
                            latents=latents, n=noise)
    assert got.shape == want.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the EMA weights drive sampling, not the live ones
    live = port.generate_truncated(
        {"S": port.S, "H": port.H, "G": port.G}, torch.from_numpy(jhist),
        torch.from_numpy(latents), torch.from_numpy(noise), trunc_psi=port.cfg.trunc_psi)
    assert np.abs(live.numpy() - got).max() > 1e-3


def test_load_pt_of_jax_export(jax_trainer, bundle, tmp_path):
    """The file JAX's --export_pt writes loads strictly into the port,
    every key of it, the discriminator's included."""
    sd = jax_convert.export_histogan_checkpoint(bundle)
    jax_convert.save_pt_file(sd, str(tmp_path / "m.pt"))
    port = Trainer(name="p", results_dir=str(tmp_path / "r"), models_dir=str(tmp_path / "m"),
                   device="cpu", **SMALL)
    port.init_GAN()
    skipped = port.load_pt(tmp_path / "m.pt")
    assert skipped == []
    bridged = convert.state_dict_from_jax(bundle)
    mine = port.reference_state_dict()
    assert set(mine) == set(bridged) == set(sd)
    assert any(k.startswith("D.") for k in mine)
    assert all(torch.equal(mine[k], bridged[k]) for k in mine)


def test_tile_double_and_chunking(bundle, jax_trainer, tmp_path):
    port = _port_trainer(tmp_path, bundle, jax_trainer.av)
    h = np.random.default_rng(2).random((1, 3, 64, 64), dtype=np.float32)
    np.testing.assert_array_equal(cli.tile_double(h, 8), jax_cli.tile_double(h, 8))
    assert cli.tile_double(h, 5).shape[0] == 4
    out = cli.sample_target(port, None, hist=h, num_image_tiles=4)  # 16 samples, 8 chunks
    assert out.shape == (16, 32, 32, 3)
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    with pytest.raises(ValueError):
        cli.sample_target(port, None, num_image_tiles=2)


# (n, batch): whole chunks, a ragged last chunk, fewer samples than a chunk
CHUNKINGS = [(4, 2), (5, 2), (3, 4)]


def _chunking_case(tmp_path, n, bs):
    """A port Trainer at batch ``bs`` with a fixed truncation centre, and
    the draws of ``n`` samples (one target histogram a row)."""
    t = Trainer(name="c", results_dir=str(tmp_path / "r"), models_dir=str(tmp_path / "m"),
                device="cpu", **dict(SMALL, batch_size=bs))
    t.init_GAN()
    rng = np.random.default_rng(10 * n + bs)
    t.av = torch.from_numpy(0.1 * rng.standard_normal((1, SMALL["latent_dim"]),
                                                      dtype=np.float32))
    hist = torch.from_numpy(rng.random((n, 3, 64, 64), dtype=np.float32))
    latents = torch.from_numpy(rng.standard_normal((n, SMALL["latent_dim"]), dtype=np.float32))
    noise = torch.from_numpy(rng.random((n, 32, 32, 1), dtype=np.float32))
    return t, hist, latents, noise


def _unchunked_generate_truncated(t, models, hist_batch, style, noi, trunc_psi):
    """generate_truncated as one loop over G's chunks, its images clamped
    after the concatenation: the form the chunk iterator replaced."""
    av, n = t.av, style.shape[0]
    w = models["S"](style)
    w = trunc_psi * (w - av) + av
    w_styles = w[:, None, :].expand(n, t.cfg.num_layers - 2, w.shape[-1])
    h_w = models["H"](hist_batch)
    h_rows = torch.stack([h_w, h_w], dim=1)
    for _ in range(int(np.log2(np.sqrt(n)))):
        h_rows = torch.cat([h_rows, h_rows], dim=0)
    h_rows = h_rows[:n]
    bs = t.cfg.batch_size
    outs = [models["G"](w_styles[s : s + bs], h_rows[s : s + bs], noi[s : s + bs])
            for s in range(0, n, bs)]
    return torch.clamp(torch.cat(outs, dim=0).permute(0, 2, 3, 1), 0.0, 1.0)


@pytest.mark.parametrize("n,bs", CHUNKINGS)
def test_generate_truncated_is_unchanged_by_its_chunk_iterator(tmp_path, n, bs):
    t, hist, latents, noise = _chunking_case(tmp_path, n, bs)
    models = t._ema_params()
    with torch.inference_mode():
        want = _unchunked_generate_truncated(t, models, hist, latents, noise, t.cfg.trunc_psi)
    got = t.generate_truncated(models, hist, latents, noise, trunc_psi=t.cfg.trunc_psi)
    assert got.shape == want.shape == (n, 32, 32, 3) and got.stride() == want.stride()
    assert torch.equal(got, want)
    starts = [s for s, _ in t._truncated_chunks(models, hist, latents, noise, 0.6)]
    assert starts == list(range(0, n, bs))


@pytest.mark.parametrize("n,bs", CHUNKINGS)
def test_evaluate_on_the_cpu_returns_the_array_it_did(tmp_path, n, bs):
    t, hist, latents, noise = _chunking_case(tmp_path, n, bs)
    with torch.inference_mode():
        want = _unchunked_generate_truncated(t, t._ema_params(), hist, latents, noise,
                                             t.cfg.trunc_psi).cpu().numpy()
    got = t.evaluate(None, hist_batch=hist, latents=latents, n=noise)
    assert got.shape == want.shape and got.strides == want.strides
    np.testing.assert_array_equal(got, want)


def test_config_json_is_trusted(tmp_path):
    from histogan_tpu_torch.utils.config import HistoGANConfig

    (tmp_path / "m" / "p").mkdir(parents=True)
    HistoGANConfig(image_size=16, network_capacity=2).write_config(
        tmp_path / "m" / "p" / ".config.json")
    t = Trainer(name="p", results_dir=str(tmp_path / "r"), models_dir=str(tmp_path / "m"),
                device="cpu", **dict(SMALL, image_size=32, network_capacity=4))
    t.load_config()
    assert (t.cfg.image_size, t.cfg.network_capacity) == (16, 2)
    assert t.G.initial_block.shape == (8, 4, 4)


def _cli(tmp_path, target, *extra, device="cpu"):
    cli.main(["--generate", "True", "--device", device, "--name", "t",
              "--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
              "--image_size", "32", "--network_capacity", "2", "--num_image_tiles", "2",
              "--target_hist", str(target), *extra])
    return list((tmp_path / "res" / "t").glob(f"generated-{Path(target).stem}-*-ema.jpg"))


def test_cli_generate_from_image(tmp_path):
    from PIL import Image

    arr = (np.random.default_rng(3).random((60, 50, 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "target.png")
    outs = _cli(tmp_path, tmp_path / "target.png")
    assert len(outs) == 1
    assert Image.open(outs[0]).size == (2 * 34 + 2, 2 * 34 + 2)  # 2x2 grid, 2 px padding


def test_cli_generate_from_npy(tmp_path):
    h = np.random.default_rng(4).random((1, 3, 16, 16)).astype(np.float32)
    np.save(tmp_path / "hist.npy", h / h.sum())
    assert len(_cli(tmp_path, tmp_path / "hist.npy", "--hist_bin", "16")) == 1


def test_cli_without_generate_or_gpu_raises(tmp_path):
    # training without images, and options that are not ported, raise
    (tmp_path / "empty").mkdir()
    dirs = ["--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
            "--image_size", "32", "--network_capacity", "2", "--new", "True"]
    with pytest.raises(FileNotFoundError):
        cli.main(["--device", "cpu", "--data", str(tmp_path / "empty"), *dirs])
    # --aug_prob is ported: it trains (DiffAugment on D's inputs)
    from PIL import Image

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(5)
    for i in range(4):
        Image.fromarray((rng.random((36, 40, 3)) * 255).astype(np.uint8)).save(data / f"{i}.png")
    cli.main(["--device", "cpu", "--aug_prob", "0.3", "--data", str(data), "--batch_size", "2",
              "--gradient_accumulate_every", "1", "--num_train_steps", "1", *dirs])
    assert (tmp_path / "mod" / "histoGAN_model" / "model_0.pt").is_file()
    if not torch.cuda.is_available():  # no silent move to the CPU
        with pytest.raises(RuntimeError):
            _cli(tmp_path, tmp_path / "x.npy", device="cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import histogan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'histogan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'histogan_tpu', 'PIL')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('histogan_tpu_torch.')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = set(res.stdout.split())
    assert len(loaded) >= 25
    training = {"models.discriminator", "ops.losses", "optim.diffgrad", "train.steps",
                "train.state", "train.checkpoint", "train.trainer", "data.dataset",
                "utils.logging", "cli.histogan"}
    rehisto = {"models.rehisto", "ops.filters", "train.rehisto_steps", "train.rehisto_trainer",
               "cli.rehistogan"}
    post = {"post", "post.imresize", "post.mkl", "post.pyramid", "post.bgu", "post.bgu_native",
            "native", "utils.face_preprocessing", "cli.create_hist_data",
            "cli.create_hist_sample"}
    assert {f"histogan_tpu_torch.{m}" for m in training | rehisto | post} <= loaded

"""The port's training surface on the CPU: the data pipeline against the
JAX package's, the Trainer's checkpoints and ``.config.json``, the NaN
rollback, the options that are not ported, and the CLI's training and
``--export_pt``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.data import dataset as jax_dataset
from histogan_tpu.models import Discriminator as JaxDiscriminator
from histogan_tpu.models import Generator as JaxGenerator
from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import StyleVectorizer as JaxStyleVectorizer
from histogan_tpu.train import convert as jax_convert
from histogan_tpu_torch.cli import histogan as cli
from histogan_tpu_torch.data import dataset
from histogan_tpu_torch.train import trainer as trainer_mod
from histogan_tpu_torch.train.trainer import NanException, Trainer
from histogan_tpu_torch.utils.logging import MetricsLogger
from test_torch_models import random_params

torch.set_num_threads(1)

SMALL = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, batch_size=2,
             gradient_accumulate_every=1, seed=0)


@pytest.fixture
def images(tmp_path):
    """8 small images and one larger than hist_insz (resized for the pool)."""
    root = tmp_path / "data"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray((rng.random((40, 36, 3)) * 255).astype(np.uint8)).save(root / f"{i}.png")
    Image.fromarray((rng.random((170, 160, 3)) * 255).astype(np.uint8)).save(root / "big.png")
    return root


def _trainer(tmp_path, **kw):
    return Trainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                   **{**SMALL, **kw})


# ------------------------------------------------ data
@pytest.mark.parametrize("resizing", ["sampling", "interpolation"])
def test_histogram_pool_and_loader_match_jax(images, resizing):
    paths = dataset.list_images(str(images))
    assert [p.name for p in paths] == [p.name for p in jax_dataset.list_images(str(images))]
    pool = dataset.HistogramPool(paths, hist_resizing=resizing)
    want = jax_dataset.HistogramPool(paths, hist_resizing=resizing)
    np.testing.assert_allclose(pool.pool, want.pool, atol=1e-6)

    ds = dataset.ImageFolderDataset(str(images), 32)
    jds = jax_dataset.ImageFolderDataset(str(images), 32)
    loader = dataset.TrainLoader(ds, pool, batch_size=2, accum=2, seed=7)
    jloader = jax_dataset.TrainLoader(jds, want, batch_size=2, accum=2, seed=7)
    try:
        for _ in range(2):
            got, ref = next(loader), next(jloader)
            assert got["d_images"].dtype == np.uint8 and got["d_images"].shape == (2, 2, 32, 32, 3)
            np.testing.assert_array_equal(got["d_images"], ref["d_images"])
            for k in ("d_hists", "g_hists"):
                assert got[k].shape == (2, 2, 3, 64, 64)
                np.testing.assert_allclose(got[k], ref[k], atol=1e-6)
    finally:
        loader.close()
        jloader.close()


def test_image_cache_and_pool_cache(images, tmp_path):
    cache = tmp_path / "cache"
    ds = dataset.ImageFolderDataset(str(images), 32, cache_dir=str(cache))
    plain = dataset.ImageFolderDataset(str(images), 32)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.get_image_u8(i, None), plain.get_image_u8(i, None))
    assert len(list(cache.glob("img_cache_*.npy"))) == 1
    pool = dataset.HistogramPool(ds.paths, cache_dir=str(cache))
    again = dataset.HistogramPool(ds.paths, cache_dir=str(cache))
    np.testing.assert_array_equal(pool.pool, again.pool)
    assert len(list(cache.glob("hist_pool_*.npy"))) == 1


def test_metrics_logger_writes_every_n_steps(tmp_path):
    log = MetricsLogger(tmp_path, "n", every=2, imgs_per_step=4)
    for step in range(5):
        log.log(step, {"d_loss": 1.0 + step})
    rows = [json.loads(line) for line in (tmp_path / "n" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 2, 4]
    assert rows[1]["d_loss"] == 3.0 and rows[1]["imgs_per_sec"] > 0


# ------------------------------------------------ the Trainer
def _opt_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            w = sb["state"][i][k]
            assert torch.equal(v, w) if torch.is_tensor(v) else v == w


def test_checkpoint_round_trip(images, tmp_path):
    t = _trainer(tmp_path)
    t.init_GAN()
    t.set_data_src(str(images))
    try:
        for _ in range(2):  # step 0: GP, PL, save of model_0 and an evaluation
            m = t.train()
            assert all(np.isfinite(v) for v in m.values())
    finally:
        t.close()
    assert (tmp_path / "m" / "t" / "model_0.pt").is_file()
    assert (tmp_path / "r" / "t" / "0-ema.jpg").is_file()
    assert t.state.step == t.steps == 2 and t.state.pl_mean.item() > 0
    t.save(3)

    # .config.json is trusted over the flags
    cfg = json.loads((tmp_path / "m" / "t" / ".config.json").read_text())
    assert (cfg["image_size"], cfg["network_capacity"]) == (32, 2)
    back = _trainer(tmp_path, image_size=64, network_capacity=4)
    back.load(-1)  # the latest: 3
    assert (back.cfg.image_size, back.cfg.network_capacity) == (32, 2)
    assert back.steps == 3 * back.cfg.save_every
    assert back.state.step == 2
    assert back.state.pl_mean.item() == t.state.pl_mean.item()
    want, got = t.reference_state_dict(), back.reference_state_dict()
    assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
    _opt_equal(t.state.opt_g, back.state.opt_g)
    _opt_equal(t.state.opt_d, back.state.opt_d)
    assert not list((tmp_path / "m" / "t").glob("*.tmp"))  # written by rename

    back.set_data_src(str(images))
    try:
        back.train()
    finally:
        back.close()
    assert back.state.step == 3
    assert back.state.opt_d.state[next(back.D.parameters())]["step"] == 3


def test_nan_rolls_back_and_raises(images, tmp_path, monkeypatch):
    t = _trainer(tmp_path)
    t.init_GAN()
    t.save(0)
    saved = {k: v.clone() for k, v in t.reference_state_dict().items()}
    t.set_data_src(str(images))

    def nan_step(state, *args, **kwargs):
        with torch.no_grad():
            for p in state.G.parameters():
                p.add_(1.0)
        nan = torch.tensor(float("nan"))
        return {"d_loss": nan, "g_loss": nan, "h_loss": nan, "q_loss": nan,
                "gp_loss": nan, "pl_mean": nan}

    monkeypatch.setattr(trainer_mod, "train_step", nan_step)
    try:
        with pytest.raises(NanException):
            t.train()
    finally:
        t.close()
    got = t.reference_state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)


@pytest.mark.parametrize("option", [
    {"device_dataset": True}, {"calculate_fid_every": 100}, {"aug_prob": 0.5},
    {"attn_layers": (1,)}, {"fq_layers": (1,)}, {"remat": True}])
def test_unported_options_raise(tmp_path, images, option):
    """The options not ported raise. DiffAugment, the discriminator's
    attention and VQ layers, the dataset held on the device and FID,
    ported since, build and take the step-0 step (GP, PL, save and
    evaluate; FID too), the codebook in D's state dict and no augmentation
    key anywhere."""
    (name, value), = option.items()
    if name == "remat":
        with pytest.raises(NotImplementedError):
            _trainer(tmp_path, **option)
        return
    extra = {"fid_num_samples": 2} if name == "calculate_fid_every" else {}
    t = _trainer(tmp_path, aug_types=["color", "translation", "cutout", "offset"], **option,
                 **extra)
    t.set_data_src(str(images))
    source = type(t.loader).__name__
    try:
        m = t.train()
    finally:
        t.close()
    assert all(np.isfinite(v) for v in m.values())
    if name in ("device_dataset", "calculate_fid_every"):
        assert source == "DeviceDataSource" and getattr(t, name) == value
        assert (t.last_fid is not None) == (name == "calculate_fid_every")
        if name == "calculate_fid_every":
            assert np.isfinite(t.last_fid) and t.fid_provenance == "random-features"
            assert (tmp_path / "r" / "t" / "fid_scores.txt").read_text().startswith("0,")
        return
    assert (m["q_loss"] > 0) == (name == "fq_layers")
    keys = t.reference_state_dict()
    assert not any("aug" in k for k in keys)
    assert any(k.startswith("D.attn_blocks.0.") for k in keys) == (name == "attn_layers")
    assert any(k.startswith("D.quantize_blocks.0.") for k in keys) == (name == "fq_layers")
    assert getattr(t.cfg, name) == (tuple(value) if name != "aug_prob" else value)


@pytest.mark.parametrize("option", [
    {"precision": "fp16"}, {"opt_state_dtype": "fp16"}, {"ema_dtype": "fp16"}])
def test_precision_options_outside_the_accepted_raise(tmp_path, option):
    with pytest.raises(ValueError):
        _trainer(tmp_path, **option)


# ------------------------------------------------ the CLI
def test_cli_trains_and_saves(images, tmp_path):
    cli.main(["--data", str(images), "--name", "c", "--new", "True", "--device", "cpu",
              "--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
              "--image_size", "32", "--network_capacity", "2", "--batch_size", "2",
              "--gradient_accumulate_every", "2", "--num_train_steps", "2", "--save_every", "1"])
    assert sorted(p.name for p in (tmp_path / "mod" / "c").glob("model_*.pt")) == [
        "model_0.pt", "model_1.pt"]
    rows = (tmp_path / "res" / "c" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(rows[0])["step"] == 0
    assert (tmp_path / "res" / "c" / "0-ema.jpg").is_file()


@pytest.mark.parametrize("checkpoint", [False, True])
def test_export_pt_says_when_it_writes_seeded_weights(tmp_path, capsys, checkpoint):
    """With no --load_pt and no checkpoint, --export_pt writes the weights
    drawn from the seed, and says so."""
    args = ["--device", "cpu", "--name", "e", "--results_dir", str(tmp_path / "res"),
            "--models_dir", str(tmp_path / "mod"), "--image_size", "32",
            "--network_capacity", "2", "--seed", "5"]
    if checkpoint:
        t = Trainer("e", str(tmp_path / "res"), str(tmp_path / "mod"), device="cpu",
                    image_size=32, network_capacity=2, seed=5)
        t.init_GAN()
        t.save(0)
    cli.main(args + ["--export_pt", str(tmp_path / "out.pt")])
    out = capsys.readouterr().out
    assert ("exporting weights drawn with seed 5" in out) != checkpoint
    assert (tmp_path / "out.pt").is_file()


def test_export_pt_converts_back_to_the_jax_parameters(tmp_path):
    """--load_pt of a JAX export, then --export_pt: the written file goes
    back through the JAX package's converter to the parameters it came
    from, bit for bit."""
    size, cap, latent, depth = 32, 2, 512, 8  # the CLI's latent width and style depth
    nl = int(np.log2(size) - 1)
    z, h = jnp.zeros((1, latent)), jnp.zeros((1, 3, 64, 64))
    g_args = (jnp.zeros((1, nl - 2, latent)), jnp.zeros((1, 2, latent)),
              jnp.zeros((1, size, size, 1)))

    def params_g(seed):
        return {"S": random_params(JaxStyleVectorizer(latent, depth), seed, z),
                "H": random_params(JaxHistVectorizer(64, latent, depth), seed + 1, h),
                "G": random_params(JaxGenerator(size, latent, cap), seed + 2, *g_args)}

    bundle = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), {
        "params_g": params_g(0), "ema": params_g(10),
        "params_d": random_params(JaxDiscriminator(size, cap), 20,
                                  jnp.zeros((1, size, size, 3)))})
    jax_convert.save_pt_file(jax_convert.export_histogan_checkpoint(bundle),
                             str(tmp_path / "in.pt"))
    cli.main(["--new", "True", "--device", "cpu", "--name", "x",
              "--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
              "--image_size", str(size), "--network_capacity", str(cap),
              "--load_pt", str(tmp_path / "in.pt"), "--export_pt", str(tmp_path / "out.pt")])
    sd = torch.load(tmp_path / "out.pt", weights_only=True)
    back = jax_convert.convert_histogan_checkpoint(sd, image_size=size, style_depth=depth)
    back.pop("vq_stats", None)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(bundle)[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_want[path]),
                                      err_msg=jax.tree_util.keystr(path))

"""The port's FID (``histogan_tpu_torch/metrics``, ``Trainer.calculate_fid``)
against the JAX package on the CPU: the Fréchet math and the scorer to
1e-10 relative, the seeded Inception weights bit for bit, the
preprocessing to 1e-5, the pool3 features within JAX's own oracle gate
(atol 2e-4, rtol 1e-3; ``tests/test_inception.py``), the trainer's score
with the JAX trainer's draws pinned to 1e-4 relative, its
``fid_scores.txt`` row, and a training run that FID leaves as it is."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.metrics import fid as jax_fid
from histogan_tpu.metrics import inception as jax_inception
from histogan_tpu_torch.metrics import fid, inception
from histogan_tpu_torch.train.trainer import FID_DRAW_SEED, Trainer
from histogan_tpu_torch.train import convert
from test_torch_sampling import SMALL as SAMPLING_SMALL
from test_torch_sampling import bundle, jax_trainer  # noqa: F401 (fixtures)

torch.set_num_threads(1)

FID_RTOL = 1e-4


def _features(seed, n=24, d=6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) + rng.random(d)


def cheap_extractor(images):
    """Per-channel mean and standard deviation: (B, 6), numpy."""
    x = np.asarray(images, np.float64)
    return np.concatenate([x.mean(axis=(1, 2)), x.std(axis=(1, 2))], axis=1)


# ------------------------------------------------ the Fréchet math
def test_frechet_math_and_scorer_match_jax():
    real, fake = _features(0), _features(1)
    for a, b in ((real, fake), (real, real + 1e-3)):
        mu_a, s_a = fid.compute_statistics(a)
        mu_b, s_b = fid.compute_statistics(b)
        jmu, js = jax_fid.compute_statistics(a)
        np.testing.assert_array_equal(mu_a, jmu)
        np.testing.assert_array_equal(s_a, js)
        got = fid.frechet_distance(mu_a, s_a, mu_b, s_b)
        want = jax_fid.frechet_distance(mu_a, s_a, mu_b, s_b)
        assert abs(got - want) <= 1e-10 * abs(want)
    np.testing.assert_allclose(fid._sqrtm_product(s_a, s_b), jax_fid._sqrtm_product(s_a, s_b),
                               rtol=0, atol=1e-10 * np.abs(s_a).max())

    def extractor(x):
        return np.asarray(x, np.float64).reshape(len(x), -1)

    scores = []
    for scorer in (fid.FIDScorer(extractor), jax_fid.FIDScorer(extractor)):
        for k in range(0, 24, 8):
            scorer.add_real(real[k:k + 8])
            scorer.add_generated(fake[k:k + 8])
        assert scorer.num_real == 24 and scorer.provenance == "custom"
        scores.append(scorer.score())
        scorer.reset(real=False)
        assert scorer.num_real == 24 and not scorer._fake
    assert abs(scores[0] - scores[1]) <= 1e-10 * abs(scores[1])


def test_extractors_carry_their_provenance(tmp_path, monkeypatch):
    monkeypatch.delenv("INCEPTION_WEIGHTS", raising=False)
    assert fid.default_extractor(device="cpu").provenance == "random-features"
    monkeypatch.setenv("INCEPTION_WEIGHTS", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="missing file"):
        fid.default_extractor(device="cpu")
    monkeypatch.delenv("INCEPTION_WEIGHTS")
    with pytest.raises(FileNotFoundError):
        fid.inception_extractor(device="cpu")
    # a torchvision-layout file: the seeded weights with identity batch norms
    raw = {}
    for name, p in inception.random_params(3).items():
        cout = p["scale"].shape[0]
        raw[f"{name}.conv.weight"] = np.transpose(p["kernel"], (3, 2, 0, 1))
        raw.update({f"{name}.bn.weight": np.ones(cout, np.float32),
                    f"{name}.bn.bias": np.zeros(cout, np.float32),
                    f"{name}.bn.running_mean": np.zeros(cout, np.float32),
                    f"{name}.bn.running_var": np.full(cout, 1.0 - inception.BN_EPS, np.float32)})
    np.savez(tmp_path / "w.npz", **raw)
    torch.save({k: torch.from_numpy(v) for k, v in raw.items()}, tmp_path / "w.pt")
    monkeypatch.setenv("INCEPTION_WEIGHTS", str(tmp_path / "w.pt"))
    pretrained = fid.default_extractor(device="cpu")
    assert pretrained.provenance == "pretrained"
    for path in ("w.npz", "w.pt"):
        loaded = inception.load_weights_file(str(tmp_path / path))
        want = jax_inception.load_weights_file(str(tmp_path / path))
        for name in inception.CONV_SPECS:
            for k in ("kernel", "scale", "shift"):
                np.testing.assert_array_equal(loaded[name][k], want[name][k])


# ------------------------------------------------ Inception
def test_random_params_bit_for_bit():
    got, want = inception.random_params(5), jax_inception.random_params(5)
    assert list(got) == list(want) == list(inception.CONV_SPECS)
    for name in got:
        for k in ("kernel", "scale", "shift"):
            assert got[name][k].dtype == want[name][k].dtype
            np.testing.assert_array_equal(got[name][k], want[name][k])
    assert inception.CONV_SPECS == jax_inception.CONV_SPECS
    assert inception.BN_EPS == jax_inception.BN_EPS


def test_preprocess_matches_jax():
    x = np.random.default_rng(1).random((2, 64, 48, 3), dtype=np.float32)
    got = inception.preprocess(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_inception.preprocess(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    same = np.random.default_rng(2).random((1, 299, 299, 3), dtype=np.float32)
    np.testing.assert_array_equal(inception.preprocess(torch.from_numpy(same)).numpy(),
                                  same * 2.0 - 1.0)


def test_pool3_features_match_jax():
    """2 images at 299x299 through the seeded network: JAX's oracle gate."""
    params = inception.random_params(0)
    x = np.random.default_rng(0).random((2, 299, 299, 3), dtype=np.float32) * 2.0 - 1.0
    with torch.inference_mode():
        got = inception.InceptionPool3(params)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_inception.inception_body)(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


# ------------------------------------------------ the trainer
@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid_data")
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray((rng.random((40, 36, 3)) * 255).astype(np.uint8)).save(root / f"{i}.png")
    return root


def _jax_fid_draws(cfg):
    """The JAX trainer's latents and noise for FID (its fold_in streams)."""
    def draws(step, s, take):
        key = jax.random.fold_in(jax.random.PRNGKey(FID_DRAW_SEED), step)
        latents = jax.random.normal(jax.random.fold_in(key, 2 * s), (take, cfg.latent_dim))
        noise = jax.random.uniform(jax.random.fold_in(key, 2 * s + 1),
                                   (take, cfg.image_size, cfg.image_size, 1))
        return torch.from_numpy(np.array(latents)), torch.from_numpy(np.array(noise))
    return draws


def test_calculate_fid_matches_jax(jax_trainer, bundle, images, tmp_path):  # noqa: F811
    jt = jax_trainer
    jt._fid_extractor, jt._fid_scorer, jt.steps = cheap_extractor, None, 3
    jt.set_data_src(str(images))
    try:
        want = jt.calculate_fid(8)
    finally:
        jt.loader.close()
    t = Trainer(name="p", results_dir=str(tmp_path / "r"), models_dir=str(tmp_path / "m"),
                device="cpu", fid_extractor=cheap_extractor, **SAMPLING_SMALL)
    t.init_GAN()
    assert t.load_state_dict(convert.state_dict_from_jax(bundle)) == []
    t.av = torch.from_numpy(jt.av)
    t.steps = 3
    t._fid_draws = _jax_fid_draws(t.cfg)
    t.set_data_src(str(images))
    try:
        got = t.calculate_fid(8)
    finally:
        t.close()
    assert t.fid_provenance == "custom" and t.last_fid == got
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= FID_RTOL * abs(want)
    assert torch.equal(t.av, torch.from_numpy(jt.av))  # the cached centre stays


def _fid_trainer(tmp_path, every, **kw):
    return Trainer("f", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                   image_size=32, network_capacity=2, latent_dim=16, style_depth=2,
                   batch_size=2, gradient_accumulate_every=1, hist_bin=16, seed=0,
                   calculate_fid_every=every, fid_num_samples=4, **kw)


def test_fid_rows_and_an_unchanged_training_run(images, tmp_path):
    states = []
    for every in (None, 1):
        t = _fid_trainer(tmp_path / str(every), every, fid_extractor=cheap_extractor)
        t.init_GAN()
        t.set_data_src(str(images))
        try:
            for _ in range(2):
                t.train()
        finally:
            t.close()
        states.append(t.reference_state_dict())
    # the JAX trainer's row: f"{step},{fid:.4f},{provenance}"
    rows = (tmp_path / "1" / "r" / "f" / "fid_scores.txt").read_text().splitlines()
    assert len(rows) == 2 and rows[1] == f"1,{t.last_fid:.4f},custom"
    assert re.fullmatch(r"0,\d+\.\d{4},custom", rows[0])
    assert not (tmp_path / "None" / "r" / "f" / "fid_scores.txt").exists()
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_fid_every_zero_is_off_and_the_default_extractor_runs(images, tmp_path, monkeypatch):
    monkeypatch.delenv("INCEPTION_WEIGHTS", raising=False)
    t = _fid_trainer(tmp_path / "zero", 0)
    t.init_GAN()
    t.set_data_src(str(images))
    try:
        t.train()
        assert t.last_fid is None
        score = t.calculate_fid(2)
    finally:
        t.close()
    assert np.isfinite(score) and t.fid_provenance == "random-features"

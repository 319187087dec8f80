"""The port's device-resident dataset (``histogan_tpu_torch/data/
device_source.py``) and ``sync_every`` against the JAX package on the CPU:
the "auto" decision, the batches of one seed (images exact, histograms to
1e-6), the crop boxes bit for bit, the crop and resize to within 1 uint8
level of JAX's and of PIL's, the source each trainer picks, and the
trainers' sync schedule (the same state as syncing every step, the log
and the NaN rollback on sync steps only)."""

import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.data import dataset as jax_dataset
from histogan_tpu.data import device_source as jax_ds
from histogan_tpu.parallel import make_mesh
from histogan_tpu.train.rehisto_trainer import RecoloringTrainer as JaxRecoloringTrainer
from histogan_tpu.train.trainer import Trainer as JaxTrainer
from histogan_tpu_torch.data import dataset, device_source
from histogan_tpu_torch.train import rehisto_trainer as rehisto_trainer_mod
from histogan_tpu_torch.train import trainer as trainer_mod
from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
from histogan_tpu_torch.train.trainer import NanException, Trainer

torch.set_num_threads(1)

HIST_TOL = 1e-6
SMALL = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, batch_size=2,
             gradient_accumulate_every=1, hist_bin=16, seed=0)
REHISTO_SMALL = dict(SMALL, skip_conn_to_GAN=True)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """6 small images of two shapes."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for i in range(6):
        shape = (40, 36, 3) if i % 2 else (32, 48, 3)
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(root / f"{i}.png")
    return root


@pytest.fixture(scope="module")
def data(images, tmp_path_factory):
    """The port's dataset (cached) and pool, and the uint8 cache and pool
    arrays that both packages' device sources take."""
    cache = tmp_path_factory.mktemp("cache")
    ds = dataset.ImageFolderDataset(str(images), 16, cache_dir=str(cache))
    pool = dataset.HistogramPool(ds.paths, hist_bin=16, cache_dir=str(cache))
    return ds, pool, np.array(ds._cache), pool.pool


# ------------------------------------------------ the "auto" decision
def _fake(cache_bytes, pool_bytes):
    ds = types.SimpleNamespace(_cache=None if cache_bytes is None
                               else np.zeros(cache_bytes, np.uint8))
    return ds, types.SimpleNamespace(pool=np.zeros(pool_bytes, np.uint8))


MESH1 = types.SimpleNamespace(shape={"data": 1})


@pytest.mark.parametrize("flag", [True, False, "auto", "true", "FALSE", " Auto ", "1", "no",
                                  "yes", "0", "maybe"])
@pytest.mark.parametrize("case", ["cached", "no_cache", "over_budget"])
@pytest.mark.parametrize("aug", [0.0, 0.5])
def test_device_dataset_decision_matches_jax(flag, case, aug, monkeypatch):
    monkeypatch.setattr(jax_ds, "DEVICE_DATASET_BUDGET", 100)
    monkeypatch.setattr(device_source, "DEVICE_DATASET_BUDGET", 100)
    ds, pool = _fake(*{"cached": (60, 40), "no_cache": (None, 40),
                       "over_budget": (60, 41)}[case])

    def decide(use, mode):
        try:
            return use(), mode()
        except ValueError as e:
            return type(e).__name__, "raised"

    want = decide(lambda: jax_ds.should_use_device_dataset(flag, ds, pool, aug),
                  lambda: jax_ds.device_dataset_mode(flag, ds, pool, MESH1, aug))
    got = decide(lambda: device_source.should_use_device_dataset(flag, ds, pool, aug),
                 lambda: device_source.device_dataset_mode(flag, ds, pool, aug))
    assert got == want
    assert got[1] in (None, "replicated", "raised")


def test_device_dataset_decision_on_a_folder_matches_jax(images, data, tmp_path):
    ds, pool, _, _ = data
    jds = jax_dataset.ImageFolderDataset(str(images), 16, cache_dir=str(tmp_path))
    plain = dataset.ImageFolderDataset(str(images), 16)
    jplain = jax_dataset.ImageFolderDataset(str(images), 16)
    for flag in ("auto", True, False):
        for (a, b) in ((ds, jds), (plain, jplain)):
            want = jax_ds.device_dataset_mode(flag, b, pool, MESH1) if not (
                flag is True and b._cache is None) else "raises"
            got = device_source.device_dataset_mode(flag, a, pool) if not (
                flag is True and a._cache is None) else "raises"
            assert got == want
    with pytest.raises(ValueError):
        device_source.device_dataset_mode(True, plain, pool)


# ------------------------------------------------ the batches
@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1)


@pytest.mark.parametrize("mode", [
    dict(), dict(self_hist=True, include_g_images=True), dict(include_g_images=True),
    dict(self_hist=True), dict(aug_prob=0.5), dict(aug_prob=0.5, include_g_images=True)],
    ids=["histogan", "self_hist_g_images", "g_images", "self_hist", "aug", "aug_g_images"])
def test_device_batches_match_jax(data, mesh, mode, capsys):
    _, _, cache, pool = data
    src = device_source.DeviceDataSource(cache, pool, 2, 3, seed=5, device="cpu", **mode)
    jsrc = jax_ds.DeviceDataSource(cache, pool, mesh, 2, 3, seed=5, **mode)
    if mode.get("aug_prob"):
        assert "center square" in capsys.readouterr().out
    for _ in range(3):
        got, want = next(src), jax.device_get(next(jsrc))
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, k
            if k.endswith("images"):
                assert v.dtype == torch.uint8
                np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
            else:
                assert v.dtype == torch.float32
                np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=HIST_TOL, err_msg=k)


def test_sample_crop_boxes_bit_for_bit():
    for size, prob, seed in ((16, 1.0, 0), (32, 0.5, 1), (7, 0.9, 2), (256, 1.0, 3)):
        got = device_source.sample_crop_boxes(np.random.default_rng(seed), 64, size, prob)
        want = jax_ds.sample_crop_boxes(np.random.default_rng(seed), 64, size, prob)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_crop_resize_u8_matches_jax_and_pil():
    """Within 1 level of JAX's on at most 0.1 % of the entries, and within 1
    level of PIL's crop and BILINEAR resize (the gate of tests/test_data.py);
    the identity box passes through."""
    size = 32
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, size=(40, size, size, 3), dtype=np.uint8)
    boxes = np.concatenate([device_source.sample_crop_boxes(rng, 39, size, 1.0),
                            np.array([[0, 0, size, size]], np.float32)])
    got = device_source.crop_resize_u8(torch.from_numpy(imgs), torch.from_numpy(boxes)).numpy()
    want = np.asarray(jax.vmap(jax_ds.crop_resize_u8)(imgs, boxes))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(got[-1], imgs[-1])
    for img, box, out in zip(imgs[:-1], boxes[:-1], got[:-1]):
        y0, x0, ch, cw = (int(v) for v in box)
        pil = np.asarray(Image.fromarray(img).crop((x0, y0, x0 + cw, y0 + ch))
                         .resize((size, size), Image.BILINEAR))
        assert np.abs(out.astype(np.int16) - pil.astype(np.int16)).max() <= 1


def test_take_and_stage_on_the_cpu(data):
    """On the CPU the streaming path is plain next(): nothing is staged,
    and take_batch returns the loader's next batch as tensors."""
    ds, pool, _, _ = data
    loader = dataset.TrainLoader(ds, pool, 2, 1, seed=7)
    again = dataset.TrainLoader(ds, pool, 2, 1, seed=7)
    try:
        assert device_source.stage_next_batch(loader, "cpu") is None
        got, want = device_source.take_batch(loader, None, "cpu"), next(again)
        assert all(torch.equal(got[k], torch.from_numpy(want[k])) for k in want)
    finally:
        loader.close()
        again.close()


# ------------------------------------------------ the trainers
@pytest.mark.parametrize("flag,aug", [("auto", 0.0), ("auto", 0.25), (False, 0.0),
                                      (True, 0.25), ("true", 0.0)])
def test_trainers_pick_the_source_jax_does(images, tmp_path, flag, aug, capsys):
    jt = JaxTrainer("j", str(tmp_path / "jr"), str(tmp_path / "jm"), num_devices=1, image_size=16,
                    hist_bin=16, batch_size=2, dataset_aug_prob=aug, device_dataset=flag)
    t = Trainer("p", str(tmp_path / "pr"), str(tmp_path / "pm"), device="cpu", image_size=16,
                hist_bin=16, batch_size=2, dataset_aug_prob=aug, device_dataset=flag)
    jt.set_data_src(str(images))
    t.set_data_src(str(images))
    try:
        assert type(t.loader).__name__ == type(jt.loader).__name__
    finally:
        t.close()
        jt.loader.close()
    if aug == 0.0:  # the recoloring trainer's dataset has no augmentation
        jr = JaxRecoloringTrainer("j", str(tmp_path / "jr"), str(tmp_path / "jm"), num_devices=1,
                                  image_size=16, hist_bin=16, batch_size=2, device_dataset=flag)
        r = RecoloringTrainer("p", str(tmp_path / "pr"), str(tmp_path / "pm"), device="cpu",
                              image_size=16, hist_bin=16, batch_size=2, device_dataset=flag)
        jr.set_data_src(str(images))
        r.set_data_src(str(images), sampling=False)
        try:
            assert type(r.loader).__name__ == type(jr.loader).__name__
            if isinstance(r.loader, device_source.DeviceDataSource):
                assert r.loader.self_hist and r.loader.include_g_images
        finally:
            r.close()
            jr.loader.close()
    with pytest.raises(ValueError):
        Trainer("p", str(tmp_path / "pr"), str(tmp_path / "pm"), device="cpu",
                device_dataset="sometimes")


def _make(kind, tmp_path, sync_every, **kw):
    if kind == "histogan":
        return Trainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                       sync_every=sync_every, **{**SMALL, **kw})
    return RecoloringTrainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                             sync_every=sync_every, **{**REHISTO_SMALL, **kw})


@pytest.mark.parametrize("kind", ["histogan", "rehistogan"])
def test_sync_every_keeps_the_state_and_logs_on_sync_steps(kind, images, tmp_path):
    states, logged = [], []
    for sync in (1, 3):
        t = _make(kind, tmp_path / f"s{sync}", sync)
        t.init_GAN()
        t.set_data_src(str(images))
        steps = []
        real_log = t.metrics_logger.log
        t.metrics_logger.log = lambda step, m, real_log=real_log: (steps.append(step),
                                                                    real_log(step, m))
        try:
            out = [t.train() for _ in range(4)]
        finally:
            t.close()
        assert isinstance(t.loader, type(None)) and t.steps == 4
        assert [m is not None for m in out] == [s in steps for s in range(4)]
        assert all(np.isfinite(v) for m in out if m for v in m.values())
        states.append(t.reference_state_dict())
        logged.append(steps)
    assert logged == [[0, 1, 2, 3], [0, 3]]
    assert set(states[0]) == set(states[1])
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.parametrize("kind", ["histogan", "rehistogan"])
def test_nan_rolls_back_at_the_next_sync_step(kind, images, tmp_path, monkeypatch):
    t = _make(kind, tmp_path, 3, save_every=1000)
    t.init_GAN()
    t.set_data_src(str(images))
    mod = trainer_mod if kind == "histogan" else rehisto_trainer_mod
    try:
        t.train()  # step 0: syncs and saves model_0
        saved = {k: v.clone() for k, v in t.reference_state_dict().items()}

        def nan_step(state, *args, **kwargs):
            with torch.no_grad():
                for p in state.G.parameters():
                    p.add_(1.0)
            return {k: torch.tensor(float("nan")) for k in
                    ("d_loss", "g_loss", "h_loss", "r_loss", "var_loss", "q_loss", "gp_loss",
                     "pl_mean")}

        monkeypatch.setattr(mod, "train_step", nan_step)
        assert t.train() is None and t.train() is None  # steps 1 and 2 do not look
        with pytest.raises(NanException):
            t.train()  # step 3 syncs, finds the NaN and reloads checkpoint 0
    finally:
        t.close()
    got = t.reference_state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)

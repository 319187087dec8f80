"""The port's reHistoGAN training and recoloring surface on the CPU: the
train step against ``make_rehisto_train_step`` (with and without the
gradient penalty, at accumulation 1 and 2, and with
``fixed_gan_weights``), the HistoGAN head transplant, the loader's
recoloring options, the RecoloringTrainer's steps, checkpoints and
evaluation grids, the ``rehistogan-torch`` CLI (``--generate`` toward an
image, a ``.npy``, a folder and ``--sampling``; ``--load_pt`` and
``--export_pt``) and the options that are not ported.

The train step runs at 32 px, capacity 4, latent 32, style depth 2 and 64
histogram bins (so the histograms go through K1's and K2's plain
versions), from the same weights (through the bridge, ``strict=True``),
the same batch and the JAX step's own noise, rebuilt from its key.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from histogan_tpu.data import dataset as jax_dataset
from histogan_tpu.models import Discriminator as JaxDiscriminator
from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import RecoloringEncoderDecoder as JaxED
from histogan_tpu.models import RecoloringGAN as JaxRecoloringGAN
from histogan_tpu.optim import diffgrad as jax_diffgrad
from histogan_tpu.train import convert as jax_convert
from histogan_tpu.train import rehisto_steps as jax_rehisto_steps
from histogan_tpu.train.rehisto_trainer import RecoloringTrainer as JaxRecoloringTrainer
from histogan_tpu.train.state import ReHistoGANState as JaxState
from histogan_tpu.utils.config import ReHistoGANConfig as JaxReConfig
from histogan_tpu_torch.cli import rehistogan as cli
from histogan_tpu_torch.data import dataset
from histogan_tpu_torch.train import convert, rehisto_steps
from histogan_tpu_torch.train.rehisto_trainer import RecoloringTrainer
from histogan_tpu_torch.train.trainer import NanException, Trainer
from test_torch_models import random_params
from test_torch_rehisto import _jax_bundle
from test_torch_steps import _jax_vq

torch.set_num_threads(1)

STEP = dict(image_size=32, network_capacity=4, latent_dim=32, style_depth=2, hist_bin=64,
            batch_size=2, skip_conn_to_GAN=True, variance_loss=True, rec_loss="laplacian")
HYPER = dict(alpha=32.0, beta=1.5, gamma=2.0)  # the CLI's defaults
LR = 2e-4
# The tolerances of tests/test_torch_steps.py. Losses: fp32 on both sides,
# convolutions and histograms summed in other orders.
LOSS_RTOL = 1e-4
# Gradients, per tensor, relative to the tensor's largest entry. At this
# size the step's gradients reach the hundreds and cancel (gamma * D, the
# GP, InstanceNorm's division): both packages' fp32 gradients sit up to
# 2.5e-3 of a tensor's largest entry from a float64 run of the same step,
# and JAX's up to 7.3e-3 with the GP at accumulation 2 (the port's 3.7e-4
# there), so the two are held to 1e-2. A conv bias that feeds an
# InstanceNorm has an exact gradient of 0: on both sides it is rounding,
# held to 1e-5 of its weight's gradient.
GRAD_RTOL = 1e-2
NORMED_BIAS_RTOL = 1e-5
# Post-step parameters: all but PARAM_OFF_SHARE of the entries agree to
# PARAM_CLOSE (tests/test_torch_steps.py: a thousandth; here 5e-3, as
# JAX's own gradients with the GP at accumulation 2 move 2.5e-3 of the
# entries by more, the other cases 4e-4 to 6e-4). DiffGrad's first update is
# exactly -lr * u(g), u(g) = sigmoid(|g|) * g / (|g| + eps / sqrt(1 - b2)),
# so every entry is held to PARAM_CLOSE + lr * |u(g_port) - u(g_jax)|, the
# measured gradient gap through the update (the gate of
# tests/test_torch_steps.py, lr plus rounding, assumes signs differ only
# at g ~ 0; here they also differ where |g| is within the gap above).
PARAM_CLOSE = 1e-6
PARAM_OFF_SHARE = 5e-3
# The codebook after a step, relative to its largest entry (EMA sums of
# D's features; tests/test_torch_steps.py's CODEBOOK_RTOL)
CODEBOOK_RTOL = 2e-4
# small trainers for the surface tests
SMALL = dict(image_size=32, network_capacity=2, latent_dim=16, style_depth=2, hist_bin=16,
             batch_size=2, gradient_accumulate_every=1, seed=0, skip_conn_to_GAN=True)


def _batch(accum, seed, size=32, hbin=64):
    rng = np.random.default_rng(seed)

    def hists():
        h = rng.random((accum, 2, 3, hbin, hbin), dtype=np.float32)
        return h / h.sum(axis=(2, 3, 4), keepdims=True)

    def images():
        return rng.integers(0, 256, (accum, 2, size, size, 3), dtype=np.uint8)

    return {"d_images": images(), "d_hists": hists(), "g_images": images(), "g_hists": hists()}


def jax_step_draws(key, cfg):
    """make_rehisto_train_step's noise from ``key``: k_d, k_g = split(key),
    then split(k_d, A) and split(k_g, A), one (B, S, S, 1) uniform each."""
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 1)
    k_d, k_g = jax.random.split(key)
    accum = cfg.gradient_accumulate_every

    def noise(k):
        return [torch.from_numpy(np.array(jax.random.uniform(x, shape)))
                for x in jax.random.split(k, accum)]

    return rehisto_steps.ReHistoDraws(noise(k_d), noise(k_g))


def _u(g):
    """u(g) of DiffGrad's first update (p -= lr * u(g)), float64."""
    return torch.sigmoid(g.abs()) * g / (g.abs() + 1e-8 / (1.0 - 0.9) ** 0.5)


def _named_grads(state, opt, prefixes):
    return {f"{p}.{n}": opt.state[w]["previous_grad"]
            for p in prefixes for n, w in getattr(state, p).named_parameters()}


def _rehisto_step_parity(tmp_path, apply_gp, accum, fixed, **options):
    """One JAX recoloring step and the port's from the same weights, batch
    and noise; with ``options`` (attn_layers, fq_layers, fq_dict_size) the
    D has them, with a random codebook. Returns (port trainer, JAX state
    after, batch, draws)."""
    cfg = JaxReConfig(gradient_accumulate_every=accum, fixed_gan_weights=fixed, **STEP,
                      **options)
    bundle = _jax_bundle(True, False, seed=60, size=cfg.image_size, hbin=cfg.hist_bin)
    jd = JaxDiscriminator(cfg.image_size, cfg.network_capacity, fq_layers=cfg.fq_layers,
                          fq_dict_size=cfg.fq_dict_size, attn_layers=cfg.attn_layers)
    vq = {}
    if options:
        bundle["params_d"] = random_params(jd, 64, jnp.zeros((1, cfg.image_size,
                                                              cfg.image_size, 3)))
        vq = _jax_vq(cfg, seed=65)
        bundle["vq_stats"] = vq
    models = jax_rehisto_steps.RecolorModels(
        JaxED(cfg.image_size, cfg.network_capacity, cfg.hist_bin, cfg.latent_dim,
              cfg.style_depth, True, False),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxRecoloringGAN(cfg.image_size, cfg.latent_dim, cfg.network_capacity), jd)
    tx = jax_diffgrad(LR, 0.5, 0.9)
    state = JaxState(step=jnp.zeros((), jnp.int32), params_g=bundle["params_g"],
                     params_d=bundle["params_d"], opt_g=tx.init(bundle["params_g"]),
                     opt_d=tx.init(bundle["params_d"]), vq_stats=vq)
    batch = _batch(accum, seed=61 + accum)
    key = jax.random.PRNGKey(62)
    step = jax_rehisto_steps.make_rehisto_train_step(models, tx, tx, cfg)
    new, jmetrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                         apply_gp=apply_gp, **HYPER)
    new = jax.device_get(new)

    t = RecoloringTrainer("p", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", seed=0,
                          gradient_accumulate_every=accum, fixed_gan_weights=fixed, **STEP,
                          **options)
    t.init_GAN()
    assert t.load_state_dict(convert.rehisto_state_dict_from_jax(bundle)) == []
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = jax_step_draws(key, t.cfg)
    metrics = rehisto_steps.train_step(t.state, batch, draws, t.cfg, apply_gp, **HYPER)

    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        want, got = float(want), metrics[k].item()
        assert abs(got - want) <= LOSS_RTOL * abs(want) + 1e-7, (k, got, want)
    assert (float(jmetrics["gp_loss"]) > 0) == apply_gp
    assert (float(jmetrics["q_loss"]) > 0) == bool(options.get("fq_layers"))
    assert float(jmetrics["var_loss"]) < 0 and float(jmetrics["r_loss"]) > 0  # both terms ran
    assert t.state.step == 1

    want_grads = convert.rehisto_state_dict_from_jax(
        {"params_g": new.opt_g.previous_grad, "params_d": new.opt_d.previous_grad})
    got_grads = {**_named_grads(t.state, t.state.opt_g, ("ED", "H", "G")),
                 **_named_grads(t.state, t.state.opt_d, ("D",))}
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        if k.startswith("ED.encoder_blocks.") and k.endswith(("net.0.bias", "net.3.bias")):
            scale = want_grads[k.replace("bias", "weight")].abs().max().item()
            assert max(g.abs().max().item(), want_grads[k].abs().max().item()) \
                <= NORMED_BIAS_RTOL * scale, k
            continue
        scale = want_grads[k].abs().max().item()
        assert (g - want_grads[k]).abs().max().item() <= GRAD_RTOL * scale + 1e-12, k

    want = convert.rehisto_state_dict_from_jax({"params_g": new.params_g,
                                                "params_d": new.params_d,
                                                "vq_stats": new.vq_stats})
    got = t.reference_state_dict()
    before = convert.rehisto_state_dict_from_jax(bundle)
    assert set(got) == set(want)
    off = 0
    for k, v in got.items():
        if "quantize_blocks" in k:  # the codebook, a buffer
            w = want[k]
            assert (v - w).abs().max().item() <= CODEBOOK_RTOL * w.abs().max().item(), k
            continue
        g, gj = got_grads[k].double(), want_grads[k].double()
        allowed = PARAM_CLOSE + LR * (_u(g) - _u(gj)).abs()
        assert bool(((v - want[k]).abs().double() <= allowed).all()), k
        off += int(((v - want[k]).abs() > PARAM_CLOSE).sum())
        # an entry moves where its gradient is not 0: with fixed_gan_weights
        # H and G get zeros, and ED's conv_out_rgb reaches no loss
        frozen = fixed and k.split(".")[0] in ("H", "G")
        assert not (frozen and g.any())
        assert torch.equal(v, before[k]) == (not g.any()), k
    assert off <= PARAM_OFF_SHARE * sum(v.numel() for v in got.values())
    return t, batch, draws


@pytest.mark.parametrize("apply_gp,accum,fixed", [
    (True, 1, False), (False, 1, False), (True, 2, False), (False, 2, False), (True, 1, True)])
def test_rehisto_train_step_matches_jax(tmp_path, apply_gp, accum, fixed):
    _rehisto_step_parity(tmp_path, apply_gp, accum, fixed)


def test_rehisto_train_step_with_the_d_options_matches_jax(tmp_path):
    """A GP step at accumulation 1 (tests/test_torch_steps.py runs the
    options at 2) with attention at layers 1-2 and a VQ codebook at layer 3
    (no augmentation: the recoloringTrainer has none); the codebook after
    the step as JAX's, which only the D phase moves, and the port's G
    phase on its own leaves it as it is."""
    t, batch, draws = _rehisto_step_parity(tmp_path, True, 1, False, attn_layers=(1, 2),
                                           fq_layers=(3,), fq_dict_size=16)
    book = {k: v.clone() for k, v in t.state.D.state_dict().items() if "quantize" in k}
    assert book
    rehisto_steps.g_phase(t.state, batch, draws, t.cfg, **HYPER)
    assert all(torch.equal(t.state.D.state_dict()[k], v) for k, v in book.items())
    rehisto_steps.d_phase(t.state, batch, draws, t.cfg, apply_gp=False)
    assert not all(torch.equal(t.state.D.state_dict()[k], v) for k, v in book.items())


def test_port_draws_are_uniform_noise_per_micro_batch():
    cfg = types.SimpleNamespace(batch_size=3, image_size=16, gradient_accumulate_every=2)
    d = rehisto_steps.draw_step(torch.Generator().manual_seed(0), cfg, "cpu")
    assert len(d.d) == len(d.g) == 2
    x = torch.cat(d.d + d.g)
    assert x.shape == (12, 16, 16, 1) and 0.0 <= x.min() and x.max() < 1.0
    assert abs(x.mean().item() - 0.5) < 0.02
    assert not torch.equal(d.d[0], d.d[1])
    assert rehisto_steps.rec_variant(None) == "L1"
    assert rehisto_steps.rec_variant("sobel") == "1st gradient"
    with pytest.raises(ValueError):
        rehisto_steps.rec_variant("edges")


# ------------------------------------------------ head transplant
def test_load_histogan_head_matches_jax(tmp_path):
    """The JAX package's transplant (``RecoloringTrainer.load_histogan_head``
    run on a bare state) and the port's, from the same HistoGAN donor (EMA
    weights through the bridge into both packages)."""
    from histogan_tpu.models import Generator as JaxGenerator
    from histogan_tpu.models import StyleVectorizer as JaxStyleVectorizer
    from test_torch_rehisto import CAP

    size, latent, depth, hbin, nl = 32, 16, 2, 16, 4
    g_args = (jnp.zeros((1, nl - 2, latent)), jnp.zeros((1, 2, latent)),
              jnp.zeros((1, size, size, 1)))

    def gen_tree(seed):
        return {"S": random_params(JaxStyleVectorizer(latent, depth), seed, jnp.zeros((1, latent))),
                "H": random_params(JaxHistVectorizer(hbin, latent, depth), seed + 1,
                                   jnp.zeros((1, 3, hbin, hbin))),
                "G": random_params(JaxGenerator(size, latent, CAP), seed + 2, *g_args)}

    donor_bundle = {"params_g": gen_tree(70), "ema": gen_tree(80),
                    "params_d": random_params(JaxDiscriminator(size, CAP), 90,
                                              jnp.zeros((1, size, size, 3)))}
    kw = dict(image_size=size, network_capacity=CAP, latent_dim=latent, style_depth=depth,
              hist_bin=hbin, batch_size=2, seed=1)
    donor = Trainer("donor", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", **kw)
    donor.init_GAN()
    donor.load_state_dict(convert.state_dict_from_jax(donor_bundle))
    port = RecoloringTrainer("re", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                             skip_conn_to_GAN=True, **kw)
    port.init_GAN()
    port.load_histogan_head(donor)

    bundle = _jax_bundle(True, False, seed=95, size=size, hbin=hbin, latent=latent, depth=depth)
    jax_re = types.SimpleNamespace(
        state=JaxState(step=jnp.zeros((), jnp.int32), params_g=bundle["params_g"],
                       params_d=bundle["params_d"], opt_g=None, opt_d=None))
    jax_re._host_state = lambda: jax_re.state
    jax_re._place = lambda state: state
    JaxRecoloringTrainer.load_histogan_head(jax_re, types.SimpleNamespace(
        state=types.SimpleNamespace(ema=donor_bundle["ema"]),
        cfg=types.SimpleNamespace(num_layers=nl)))
    want = jax_convert.export_rehistogan_checkpoint(
        {"params_g": jax_re.state.params_g, "params_d": bundle["params_d"]})
    got = port.reference_state_dict()
    head = [k for k in want if k.split(".")[0] in ("H", "G")]
    assert head and {k for k in got if k.split(".")[0] in ("H", "G")} == set(head)
    for k in head:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert torch.equal(got["G.blocks.1.conv1.weight"], donor.GE.blocks[nl - 1].conv1.weight)


# ------------------------------------------------ data
@pytest.fixture
def images(tmp_path):
    root = tmp_path / "data"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        arr = np.zeros((40, 36, 3), np.uint8)
        arr[..., i % 3] = 180
        arr += rng.integers(0, 60, (40, 36, 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / f"{i}.jpg")
    return root


@pytest.mark.parametrize("self_hist", [False, True])
def test_loader_recoloring_options_match_jax(images, self_hist):
    paths = dataset.list_images(str(images))
    pool = dataset.HistogramPool(paths, hist_bin=16)
    ds = dataset.ImageFolderDataset(str(images), 32)
    jpool = jax_dataset.HistogramPool(paths, hist_bin=16)
    jds = jax_dataset.ImageFolderDataset(str(images), 32)
    loader = dataset.TrainLoader(ds, pool, 2, 3, seed=11, self_hist=self_hist,
                                 include_g_images=True)
    jloader = jax_dataset.TrainLoader(jds, jpool, 2, 3, seed=11, self_hist=self_hist,
                                      include_g_images=True)
    try:
        for _ in range(2):
            got, want = next(loader), next(jloader)
            assert set(got) == set(want) == {"d_images", "d_hists", "g_images", "g_hists"}
            for k in got:
                assert got[k].shape == want[k].shape, k
                np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    finally:
        loader.close()
        jloader.close()


# ------------------------------------------------ trainer
def _trainer(tmp_path, **kw):
    return RecoloringTrainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu",
                             **{**SMALL, **kw})


def test_trainer_steps_save_load_and_evaluate(tmp_path, images):
    t = _trainer(tmp_path, save_every=2)
    t.init_GAN()
    t.set_data_src(str(images), sampling=True)
    try:
        before = {k: v.clone() for k, v in t.reference_state_dict().items()}
        for _ in range(3):
            m = t.train(32, 1.5, 2)
        assert all(np.isfinite(v) for v in m.values())
        assert t.r_loss > 0 and t.var_loss <= 0 and t.last_gp_loss > 0
        after = t.reference_state_dict()
        for prefix in ("ED", "H", "G", "D"):
            assert any(not torch.equal(after[k], before[k]) for k in after
                       if k.split(".")[0] == prefix), prefix
        out = tmp_path / "r" / "t"
        # step 0 evaluates with triple_hist: 4 images toward 3 sets of
        # targets, a row of the 4 images per set
        assert Image.open(out / "0-generated.jpg").size == (4 * 34 + 2, 3 * 34 + 2)
        assert Image.open(out / "0-input.jpg").size == (4 * 34 + 2, 34 + 2)
        assert t.store.saved_nums() == [0, 1]
        t.print_log()
        grid = t.evaluate(7, double_hist=True)
        assert grid.shape == (8, 32, 32, 3) and 0.0 <= grid.min() and grid.max() <= 1.0
    finally:
        t.close()

    r = _trainer(tmp_path, save_every=2)
    assert r.load(-1) == 0
    assert r.steps == 2 and r.state.step == 3
    saved = r.reference_state_dict()
    assert all(torch.equal(saved[k], after[k]) for k in saved)
    assert _trainer(tmp_path / "empty").load(-1) == -1  # no checkpoint: the CLI transplants


def test_fixed_gan_weights_and_hyperparameter_switch(tmp_path, images, monkeypatch):
    t = _trainer(tmp_path, fixed_gan_weights=True, change_hyperparameters=True,
                 change_hyperparameters_after=0, save_every=1000)
    t.init_GAN()
    t.set_data_src(str(images), sampling=False)
    seen = {}
    real_step = rehisto_steps.train_step

    def spy(state, batch, draws, cfg, apply_gp, alpha, beta, gamma):
        seen.update(alpha=alpha, beta=beta, gamma=gamma, keys=set(batch))
        return real_step(state, batch, draws, cfg, apply_gp, alpha, beta, gamma)

    monkeypatch.setattr("histogan_tpu_torch.train.rehisto_trainer.train_step", spy)
    try:
        before = t.reference_state_dict()
        before = {k: v.clone() for k, v in before.items()}
        t.train(32, 1.5, 4)
    finally:
        t.close()
    assert (seen["alpha"], seen["gamma"], seen["beta"]) == (8.0, 2.0, 1.0)
    assert seen["keys"] == {"d_images", "d_hists", "g_images", "g_hists"}
    after = t.reference_state_dict()
    moved = {k.split(".")[0] for k, v in after.items() if not torch.equal(v, before[k])}
    assert moved == {"ED", "D"}  # only ED learns on the generator side


def test_nan_rolls_back_to_the_checkpoint(tmp_path, images, monkeypatch):
    t = _trainer(tmp_path)
    t.init_GAN()
    t.save(0)
    saved = {k: v.clone() for k, v in t.reference_state_dict().items()}
    t.set_data_src(str(images))

    def nan_step(state, *args, **kwargs):
        with torch.no_grad():
            for p in state.G.parameters():
                p.add_(1.0)
        return {k: torch.tensor(float("nan")) for k in
                ("d_loss", "g_loss", "h_loss", "r_loss", "var_loss", "q_loss", "gp_loss")}

    monkeypatch.setattr("histogan_tpu_torch.train.rehisto_trainer.train_step", nan_step)
    try:
        with pytest.raises(NanException):
            t.train()
    finally:
        t.close()
    got = t.reference_state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)


def test_refused_options(tmp_path, images):
    # the discriminator's attention and VQ layers are ported: they build
    for kw in (dict(fq_layers=(1,)), dict(attn_layers=(1,))):
        t = _trainer(tmp_path, **kw)
        t.init_GAN()
        assert t.cfg.fq_layers == kw.get("fq_layers", ()) and \
            t.cfg.attn_layers == kw.get("attn_layers", ())
        assert any(k.startswith(("D.attn_blocks.0.", "D.quantize_blocks.0."))
                   for k in t.reference_state_dict())
    # the dataset held on the device and sync_every are ported: they train
    for kw in (dict(device_dataset=True), dict(sync_every=4)):
        t = _trainer(tmp_path / "on", **kw)
        t.init_GAN()
        t.set_data_src(str(images))
        try:
            assert type(t.loader).__name__ == "DeviceDataSource"
            out = [t.train(32, 1.5, 4) for _ in range(2)]
        finally:
            t.close()
        assert out[0] is not None and (out[1] is None) == ("sync_every" in kw)
        assert all(np.isfinite(v) for v in out[0].values())
    for kw in (dict(remat=True), dict(num_devices=2), dict(param_sharding="fsdp")):
        with pytest.raises(NotImplementedError):
            _trainer(tmp_path, **kw)
    with pytest.raises(ValueError):
        _trainer(tmp_path, precision="fp16")
    if not torch.cuda.is_available():  # no silent move to the CPU
        with pytest.raises(RuntimeError):
            RecoloringTrainer("t", str(tmp_path / "r"), str(tmp_path / "m"), device="cuda")
    dirs = ["--results_dir", str(tmp_path / "res"), "--models_dir", str(tmp_path / "mod"),
            "--image_size", "32", "--network_capacity", "2", "--device", "cpu", "--new", "True"]
    # the CLI passes what the trainer refuses on (bf16, upsampling,
    # post-recoloring and face extraction are ported: their tests are
    # tests/test_torch_rehisto_bf16.py and tests/test_torch_rehisto_post.py)
    for extra in (["--remat", "True"], ["--num_devices", "2"]):
        with pytest.raises(NotImplementedError):
            cli.main([*dirs, *extra])
    # --fq_layers and --attn_layers reach the trainer, which trains with them
    # and so do --sync_every and --device_dataset
    cli.main([*dirs, "--data", str(images), "--name", "opts", "--hist_bin", "16",
              "--fq_layers", "3", "--attn_layers", "2", "--batch_size", "2",
              "--gradient_accumulate_every", "1", "--num_train_steps", "1",
              "--sync_every", "2", "--device_dataset", "false"])
    saved = torch.load(tmp_path / "mod" / "opts" / "model_0.pt", weights_only=True)["GAN"]
    assert "D.quantize_blocks.2.fn.embed" in saved and "D.attn_blocks.1.0.fn.g" in saved


def test_load_pt_refuses_another_variant(tmp_path):
    t = _trainer(tmp_path)
    t.init_GAN()
    t.export_pt(tmp_path / "skip.pt")
    other = _trainer(tmp_path / "o", skip_conn_to_GAN=False)
    other.init_GAN()
    with pytest.raises(ValueError, match="skip_conn_to_GAN"):
        other.load_pt(tmp_path / "skip.pt")


# ------------------------------------------------ CLI
CLI_TOY = ["--image_size", "32", "--network_capacity", "2", "--hist_bin", "16",
           "--device", "cpu", "--name", "re"]


def _cli(tmp_path, *extra):
    cli.main([*CLI_TOY, "--results_dir", str(tmp_path / "res"), "--models_dir",
              str(tmp_path / "mod"), *extra])
    return tmp_path / "res" / "re"


def test_cli_load_pt_of_a_jax_export_loads_strictly(tmp_path):
    """A .pt written by the JAX package's save_pt_file (at the CLI's latent
    512 and style depth 8) goes through ``--load_pt`` strictly and back out
    through ``--export_pt`` unchanged."""
    from test_torch_rehisto import CAP

    bundle = _jax_bundle(True, False, seed=100, size=32, hbin=16, latent=512, depth=8)
    pt, out = tmp_path / "jax.pt", tmp_path / "back.pt"
    jax_convert.save_pt_file(jax_convert.export_rehistogan_checkpoint(bundle), str(pt))
    _cli(tmp_path, "--network_capacity", str(CAP), "--load_pt", str(pt), "--export_pt", str(out))
    want = torch.load(pt, weights_only=True)
    got = torch.load(out, weights_only=True)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def _target_files(tmp_path):
    rng = np.random.default_rng(5)
    Image.fromarray((rng.random((50, 40, 3)) * 255).astype(np.uint8)).save(tmp_path / "in.jpg")
    Image.fromarray((rng.random((60, 70, 3)) * 255).astype(np.uint8)).save(tmp_path / "t.png")
    h = rng.random((1, 3, 16, 16)).astype(np.float32)
    np.save(tmp_path / "h.npy", h / h.sum())
    folder = tmp_path / "targets"
    folder.mkdir()
    Image.fromarray((rng.random((30, 30, 3)) * 255).astype(np.uint8)).save(folder / "a.jpg")
    np.save(folder / "b.npy", h / h.sum())
    (folder / "notes.txt").write_text("not a target")
    pool = rng.random((5, 1, 3, 16, 16)).astype(np.float32)
    np.save(tmp_path / "pool.npy", pool / pool.sum(axis=(2, 3, 4), keepdims=True))
    return folder


def test_cli_generate_on_the_cpu(tmp_path, capsys):
    folder = _target_files(tmp_path)
    gen = ["--generate", "True", "--input_image", str(tmp_path / "in.jpg")]
    out = _cli(tmp_path, *gen, "--target_hist", str(tmp_path / "t.png"))
    assert len(list(out.glob("output-t-*-generated.jpg"))) == 1
    _cli(tmp_path, *gen, "--target_hist", str(tmp_path / "h.npy"))
    _cli(tmp_path, *gen, "--target_hist", str(folder))
    assert "not supported" in capsys.readouterr().out  # notes.txt
    _cli(tmp_path, *gen, "--sampling", "True", "--target_number", "2",
         "--histogram_pool", str(tmp_path / "pool.npy"))
    names = sorted(p.name for p in out.glob("*-generated.jpg"))
    assert len(names) == 6, names  # image, npy, folder (2), sampling (2)
    assert sum(n.startswith(("output-t-", "output-h-")) for n in names) == 2
    assert sum(n.startswith(("0-output-", "1-output-")) for n in names) == 2
    assert all(Image.open(out / n).size == (36, 36) for n in names)  # one 32x32 image each
    with pytest.raises(Exception, match="No target histogram"):
        _cli(tmp_path, *gen)


def test_cli_recolor_matches_the_trainer(tmp_path, monkeypatch):
    """--generate recolors the resized input toward the target image's
    histogram: the trainer's recolor with the CLI's noise, exactly."""
    _target_files(tmp_path)
    wide = dict(latent_dim=512, style_depth=8)  # the CLI's, which it has no flags for
    t = _trainer(tmp_path / "w", **wide)
    t.init_GAN()
    pt = tmp_path / "w.pt"
    t.export_pt(pt)
    saved = []
    monkeypatch.setattr("histogan_tpu_torch.train.rehisto_trainer.save_image_grid",
                        lambda images, path, nrow: saved.append((images, nrow)))
    _cli(tmp_path, "--generate", "True", "--input_image", str(tmp_path / "in.jpg"),
         "--target_hist", str(tmp_path / "t.png"), "--load_pt", str(pt), "--seed", "0")
    (images, nrow), = saved  # the output alone, no input grid
    assert images.shape == (1, 32, 32, 3) and nrow == 1
    from histogan_tpu_torch.data.dataset import load_rgb
    from histogan_tpu_torch.ops.histogram import RGBuvHistBlock

    img = Image.open(tmp_path / "in.jpg").convert("RGB").resize((32, 32))
    h = RGBuvHistBlock(h=16, resizing="sampling")(load_rgb(tmp_path / "t.png")[None])
    u = _trainer(tmp_path / "x", **wide)
    u.init_GAN()
    u.load_pt(pt)
    want = u.recolor(np.asarray(img, np.float32)[None] / 255.0, h).numpy()
    np.testing.assert_array_equal(images, want)


def test_cli_transplants_a_histogan_head(tmp_path):
    """--new True --load_histoGAN_weights True: G's two blocks and H come
    from the saved HistoGAN model's EMA (its last two blocks and HE)."""
    donor = Trainer("donor", str(tmp_path / "hr"), str(tmp_path / "hm"), device="cpu",
                    image_size=32, network_capacity=2, hist_bin=16, seed=5)
    donor.init_GAN()
    donor.save(0)
    out = tmp_path / "re.pt"
    _cli(tmp_path, "--new", "True", "--load_histoGAN_weights", "True",
         "--histGAN_models_dir", str(tmp_path / "hm"), "--histoGAN_model_name", "donor",
         "--export_pt", str(out))
    got = torch.load(out, weights_only=True)
    n = donor.cfg.num_layers
    for i, src in ((0, donor.GE.blocks[n - 2]), (1, donor.GE.blocks[n - 1])):
        for k, v in src.state_dict().items():
            assert torch.equal(got[f"G.blocks.{i}.{k}"], v), k
    assert all(torch.equal(got[f"H.{k}"], v) for k, v in donor.HE.state_dict().items())
    with pytest.raises(Exception, match="GAN does not exist"):
        _cli(tmp_path, "--new", "True", "--load_histoGAN_weights", "True",
             "--histGAN_models_dir", str(tmp_path / "none"))

"""The port's training step against the JAX package's, on the CPU.

One JAX step (``make_train_step`` at 32 px, capacity 4, latent 32, style
depth 2, with the step-0 flags: gradient penalty and path length) and the
port's ``train_step`` start from the same weights (through the bridge,
``strict=True``), the same batch and the same draws: the test rebuilds
the JAX step's random draws from its key with the step's own splits and
hands them to the port. The same holds for a GP step with the
discriminator's options (DiffAugment at aug_prob 1, attention, a VQ
codebook) at accumulation 2 (the port's micro-batch loop is the same at
1; tests/test_torch_rehisto_trainer.py runs the options at 1), at 16 px,
the codebook after the step included (both phases update it). The rest holds the port's step to itself:
merged and unmerged D forwards, gradient accumulation, no gradient on D
from the G phase, and the distributions of the port's own draws.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from histogan_tpu.models import Discriminator as JaxDiscriminator
from histogan_tpu.models import Generator as JaxGenerator
from histogan_tpu.models import HistVectorizer as JaxHistVectorizer
from histogan_tpu.models import StyleVectorizer as JaxStyleVectorizer
from histogan_tpu.optim import diffgrad as jax_diffgrad
from histogan_tpu.train import steps as jax_steps
from histogan_tpu.train.state import HistoGANState as JaxState
from histogan_tpu.utils.config import HistoGANConfig as JaxConfig
from histogan_tpu_torch.ops import losses
from histogan_tpu_torch.train import convert, steps
from histogan_tpu_torch.train.trainer import Trainer
from test_torch_d_options import _codebook
from test_torch_diffaugment import jax_aug_draws
from test_torch_models import random_params

torch.set_num_threads(1)

LIVE = ("S", "H", "G", "D")
SMALL = dict(image_size=32, network_capacity=4, latent_dim=32, style_depth=2, hist_bin=64,
             batch_size=2)
LR = 2e-4
# Losses: fp32 on both sides, convolutions and the histogram summed in
# other orders.
LOSS_RTOL = 1e-4
# Gradients, per tensor, relative to the tensor's largest entry: the GP's
# double backward and the histogram backward add in other orders.
GRAD_RTOL = 2e-4
# Post-step parameters: DiffGrad's first update is lr * sigmoid(|g|) * sign(g)
# (m / sqrt(v) = sign(g) at t = 1), so where g is ~0 on both sides and its
# sign differs by rounding, the two updates differ by up to 2 * lr * 0.5.
# Everywhere else they agree to fp32 rounding: all but a thousandth of the
# entries to PARAM_CLOSE.
PARAM_ATOL = 1.01 * LR
PARAM_CLOSE = 1e-6
# The codebook after a step: EMA sums of D's features over three forwards
# (fakes, reals, G's fakes), relative to its largest entry, as GRAD_RTOL.
CODEBOOK_RTOL = 2e-4
D_OPTIONS = dict(aug_prob=1.0, aug_types=("color", "translation", "cutout", "offset"),
                 attn_layers=(1, 2), fq_layers=(3,), fq_dict_size=16)


def _jax_params(cfg, seed):
    nl, size = cfg.num_layers, cfg.image_size
    g = {"S": random_params(JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth), seed,
                            jnp.zeros((1, cfg.latent_dim))),
         "H": random_params(JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
                            seed + 1, jnp.zeros((1, 3, cfg.hist_bin, cfg.hist_bin))),
         "G": random_params(JaxGenerator(size, cfg.latent_dim, cfg.network_capacity), seed + 2,
                            jnp.zeros((1, nl - 2, cfg.latent_dim)),
                            jnp.zeros((1, 2, cfg.latent_dim)), jnp.zeros((1, size, size, 1)))}
    d = random_params(_jax_d(cfg), seed + 3, jnp.zeros((1, size, size, 3)))
    return g, d


def _jax_d(cfg):
    return JaxDiscriminator(cfg.image_size, cfg.network_capacity, fq_layers=cfg.fq_layers,
                            fq_dict_size=cfg.fq_dict_size, attn_layers=cfg.attn_layers)


def _jax_vq(cfg, seed):
    """A random codebook for each of ``cfg.fq_layers`` (the vq_stats tree)."""
    return {f"vq_{n - 1}": _codebook(cfg.network_capacity * 2 ** (n - 1), cfg.fq_dict_size,
                                     seed + n)
            for n in cfg.fq_layers}


def _batch(accum, seed, size=SMALL["image_size"]):
    rng = np.random.default_rng(seed)
    b, s = SMALL["batch_size"], size

    def hists():
        h = rng.random((accum, b, 3, 64, 64), dtype=np.float32)
        return h / h.sum(axis=(2, 3, 4), keepdims=True)

    return {"d_images": rng.integers(0, 256, (accum, b, s, s, 3), dtype=np.uint8),
            "d_hists": hists(), "g_hists": hists()}


def _torch(x):
    return torch.from_numpy(np.array(x))


def jax_step_draws(key, cfg, apply_pl, z_dtype=jnp.float32):
    """The draws ``make_train_step``'s step makes from ``key``, with its
    splits: k_d, k_g = split(key); split(k_d, A), then split(k, 3) into
    the generator's key (split(k_gen) and split(k_style, 4)) and the
    AugWrapper keys of the fakes and the reals; split(k_g, A), then
    split(k, 3) into the generator's key, the fakes' AugWrapper key and
    the path-length noise's. Under bf16 the JAX step draws z and the
    augmentation's factors in bf16 (``z_dtype``), exact in fp32; the
    noise and the path-length noise stay fp32."""
    b, rows = cfg.batch_size, cfg.num_layers - 2

    def gen(k_gen):
        k_style, k_noise = jax.random.split(k_gen)
        k1, k2, k3, k4 = jax.random.split(k_style, 4)
        use_mixed = jax.random.uniform(k3, ()) < cfg.mixed_prob
        tt = jax.random.randint(k4, (), 0, rows)
        return steps.GenDraws(
            z1=_torch(jax.random.normal(k1, (b, cfg.latent_dim), z_dtype).astype(jnp.float32)),
            z2=_torch(jax.random.normal(k2, (b, cfg.latent_dim), z_dtype).astype(jnp.float32)),
            cutoff=_torch(jnp.where(use_mixed, tt, rows)),
            noise=_torch(jax.random.uniform(k_noise, (b, cfg.image_size, cfg.image_size, 1))))

    def aug(k):
        return jax_aug_draws(k, b, cfg.image_size, cfg.image_size, cfg.aug_prob,
                             cfg.aug_types, z_dtype)

    k_d, k_g = jax.random.split(key)
    accum = cfg.gradient_accumulate_every
    d, d_aug = [], []
    for k in jax.random.split(k_d, accum):
        k_gen, k_aug_f, k_aug_r = jax.random.split(k, 3)
        d.append(gen(k_gen))
        d_aug.append((aug(k_aug_f), aug(k_aug_r)))
    g, g_aug, pl = [], [], []
    for k in jax.random.split(k_g, accum):
        k_gen, k_aug, k_pl = jax.random.split(k, 3)
        g.append(gen(k_gen))
        g_aug.append(aug(k_aug))
        pl.append(_torch(jax.random.normal(k_pl, (b, rows, cfg.latent_dim))))
    with_aug = cfg.aug_prob > 0
    return steps.StepDraws(d, g, pl if apply_pl else None, d_aug if with_aug else None,
                           g_aug if with_aug else None)


def _port_trainer(tmp_path, bundle, accum=1, **options):
    t = Trainer("p", str(tmp_path / "r"), str(tmp_path / "m"), device="cpu", seed=0,
                gradient_accumulate_every=accum, **{**SMALL, **options})
    t.init_GAN()
    assert t.load_state_dict(convert.state_dict_from_jax(bundle)) == []
    return t


def _named_grads(state, opt, prefixes):
    """{reference name: the gradient the optimizer last applied}."""
    return {f"{p}.{n}": opt.state[w]["previous_grad"]
            for p in prefixes for n, w in getattr(state, p).named_parameters()}


@pytest.fixture(scope="module")
def jax_step_result():
    """One JAX step with the step-0 flags (GP and PL); the only JAX step
    this suite compiles."""
    cfg = JaxConfig(gradient_accumulate_every=1, **SMALL)
    params_g, params_d = _jax_params(cfg, seed=20)
    bundle = {"params_g": params_g, "params_d": params_d, "ema": params_g}
    models = jax_steps.Models(
        JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxGenerator(cfg.image_size, cfg.latent_dim, cfg.network_capacity),
        JaxDiscriminator(cfg.image_size, cfg.network_capacity))
    tx = jax_diffgrad(LR, 0.5, 0.9)
    state = JaxState(step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
                     ema=params_g, opt_g=tx.init(params_g), opt_d=tx.init(params_d),
                     pl_mean=jnp.zeros(()))
    batch = _batch(1, seed=21)
    key = jax.random.PRNGKey(22)
    step = jax_steps.make_train_step(models, tx, tx, cfg)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                        apply_gp=True, apply_pl=True)
    new = jax.device_get(new)
    return dict(cfg=cfg, bundle=bundle, batch=batch, key=key,
                metrics={k: float(v) for k, v in metrics.items()},
                after={"params_g": new.params_g, "params_d": new.params_d, "ema": new.ema},
                grads={"params_g": new.opt_g.previous_grad, "params_d": new.opt_d.previous_grad,
                       "ema": new.opt_g.previous_grad},
                pl_mean=float(new.pl_mean))


def test_train_step_matches_jax(jax_step_result, tmp_path):
    r = jax_step_result
    t = _port_trainer(tmp_path, r["bundle"])
    draws = jax_step_draws(r["key"], r["cfg"], apply_pl=True)
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    metrics = steps.train_step(t.state, batch, draws, t.cfg, apply_gp=True, apply_pl=True)

    assert set(metrics) == set(r["metrics"])
    for k, want in r["metrics"].items():
        got = metrics[k].item()
        assert abs(got - want) <= LOSS_RTOL * abs(want) + 1e-7, (k, got, want)
    assert r["metrics"]["gp_loss"] > 0 and r["metrics"]["pl_mean"] > 0  # both terms ran
    assert abs(t.state.pl_mean.item() - r["pl_mean"]) <= LOSS_RTOL * r["pl_mean"]
    assert t.state.step == 1

    want_grads = convert.state_dict_from_jax(r["grads"])
    got_grads = {**_named_grads(t.state, t.state.opt_g, ("S", "H", "G")),
                 **_named_grads(t.state, t.state.opt_d, ("D",))}
    assert set(got_grads) == {k for k in want_grads if k.split(".")[0] in LIVE}
    for k, g in got_grads.items():
        scale = want_grads[k].abs().max().item()
        assert (g - want_grads[k]).abs().max().item() <= GRAD_RTOL * scale + 1e-12, k

    want = convert.state_dict_from_jax(r["after"])
    got = t.reference_state_dict()
    assert set(got) == set(want)
    off = 0
    for k, v in got.items():
        assert (v - want[k]).abs().max().item() <= PARAM_ATOL, k
        off += int(((v - want[k]).abs() > PARAM_CLOSE).sum())
    assert off <= 1e-3 * sum(v.numel() for v in got.values())
    before = convert.state_dict_from_jax(r["bundle"])
    # the live weights moved, the EMA copies did not (no EMA at step 0)
    assert all(not torch.equal(got[k], before[k]) for k in got if k.split(".")[0] in LIVE)
    assert all(torch.equal(got[k], before[k]) for k in got if k.split(".")[0] in ("SE", "HE", "GE"))


def _compare_step(t, r, metrics, live):
    """The port's state after its step against the JAX step's result ``r``:
    the metrics, the applied gradients and the post-step parameters."""
    assert set(metrics) == set(r["metrics"])
    for k, want in r["metrics"].items():
        got = metrics[k].item()
        assert abs(got - want) <= LOSS_RTOL * abs(want) + 1e-7, (k, got, want)
    want_grads = convert.state_dict_from_jax(r["grads"])
    got_grads = {**_named_grads(t.state, t.state.opt_g, ("S", "H", "G")),
                 **_named_grads(t.state, t.state.opt_d, ("D",))}
    assert set(got_grads) == {k for k in want_grads if k.split(".")[0] in live
                              and "quantize_blocks" not in k}
    for k, g in got_grads.items():
        scale = want_grads[k].abs().max().item()
        assert (g - want_grads[k]).abs().max().item() <= GRAD_RTOL * scale + 1e-12, k
    want = convert.state_dict_from_jax(r["after"])
    got = t.reference_state_dict()
    assert set(got) == set(want)
    off = 0
    for k, v in got.items():
        if "quantize_blocks" in k:
            continue
        assert (v - want[k]).abs().max().item() <= PARAM_ATOL, k
        off += int(((v - want[k]).abs() > PARAM_CLOSE).sum())
    assert off <= 1e-3 * sum(v.numel() for v in got.values())
    return got, want


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def jax_options_step_result(request):
    """One JAX GP step at accumulation 1 and at 2 with DiffAugment (aug_prob
    1: every function runs), attention at layers 1-2 and a VQ codebook at
    layer 3, 16 px: the codebook carried across both phases' micro-batches."""
    cfg = JaxConfig(gradient_accumulate_every=request.param, **{**SMALL, "image_size": 16},
                    **D_OPTIONS)
    params_g, params_d = _jax_params(cfg, seed=60)
    vq = _jax_vq(cfg, seed=61)
    models = jax_steps.Models(
        JaxStyleVectorizer(cfg.latent_dim, cfg.style_depth),
        JaxHistVectorizer(cfg.hist_bin, cfg.latent_dim, cfg.style_depth),
        JaxGenerator(cfg.image_size, cfg.latent_dim, cfg.network_capacity), _jax_d(cfg))
    tx = jax_diffgrad(LR, 0.5, 0.9)
    state = JaxState(step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
                     ema=params_g, opt_g=tx.init(params_g), opt_d=tx.init(params_d),
                     pl_mean=jnp.zeros(()), vq_stats=vq)
    batch = _batch(cfg.gradient_accumulate_every, seed=62, size=16)
    key = jax.random.PRNGKey(63)
    step = jax_steps.make_train_step(models, tx, tx, cfg)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                        apply_gp=True, apply_pl=False)
    new = jax.device_get(new)
    return dict(cfg=cfg, bundle={"params_g": params_g, "params_d": params_d, "ema": params_g,
                                 "vq_stats": vq},
                batch=batch, key=key, metrics={k: float(v) for k, v in metrics.items()},
                after={"params_g": new.params_g, "params_d": new.params_d, "ema": new.ema,
                       "vq_stats": new.vq_stats},
                grads={"params_g": new.opt_g.previous_grad, "params_d": new.opt_d.previous_grad,
                       "ema": new.opt_g.previous_grad})


def test_train_step_with_the_d_options_matches_jax(jax_options_step_result, tmp_path):
    r = jax_options_step_result
    cfg = r["cfg"]
    t = _port_trainer(tmp_path, r["bundle"], cfg.gradient_accumulate_every,
                      image_size=16, **D_OPTIONS)
    draws = jax_step_draws(r["key"], cfg, apply_pl=False)
    assert all(a.apply for pair in draws.d_aug for a in pair)
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    before = {k: v.clone() for k, v in t.state.D.state_dict().items() if "quantize" in k}
    metrics = steps.train_step(t.state, batch, draws, t.cfg, apply_gp=True, apply_pl=False)
    assert r["metrics"]["q_loss"] > 0 and r["metrics"]["gp_loss"] > 0
    got, want = _compare_step(t, r, metrics, LIVE)
    for k, v in before.items():  # both phases moved the codebook, as JAX's did
        w = want[f"D.{k}"]
        assert not torch.equal(got[f"D.{k}"], v), k
        assert (got[f"D.{k}"] - w).abs().max().item() <= CODEBOOK_RTOL * w.abs().max().item(), k


def test_g_phase_leaves_no_gradient_on_d(tmp_path):
    cfg = JaxConfig(**SMALL)
    params_g, params_d = _jax_params(cfg, seed=30)
    t = _port_trainer(tmp_path, {"params_g": params_g, "params_d": params_d, "ema": params_g})
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, seed=31).items()}
    draws = steps.draw_step(torch.Generator().manual_seed(0), t.cfg, "cpu", apply_pl=True)
    steps.train_step(t.state, batch, draws, t.cfg, apply_gp=False, apply_pl=True)
    for m in t.state.modules().values():
        assert all(p.grad is None for p in m.parameters())


def test_merged_and_unmerged_d_forward_agree(tmp_path):
    cfg = JaxConfig(**SMALL)
    params_g, params_d = _jax_params(cfg, seed=40)
    t = _port_trainer(tmp_path, {"params_g": params_g, "params_d": params_d, "ema": params_g})
    rng = np.random.default_rng(41)
    fake, real = (torch.from_numpy(rng.random((2, 3, 32, 32), dtype=np.float32))
                  for _ in range(2))
    merged, div, q, gp = steps.d_loss(t.state.D, fake, real, apply_gp=False)
    split = losses.hinge_divergence(t.state.D(real)[0], t.state.D(fake)[0])
    assert abs(merged.item() - div.item()) == 0.0 and q.item() == 0.0 and gp.item() == 0.0
    assert abs(merged.item() - split.item()) <= 1e-6 * max(1.0, abs(split.item()))
    gm = torch.autograd.grad(merged, list(t.state.D.parameters()))
    gs = torch.autograd.grad(split, list(t.state.D.parameters()))
    for a, b in zip(gm, gs):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-12


def test_accumulation_applies_the_mean_of_the_micro_batch_gradients(tmp_path):
    cfg = JaxConfig(**SMALL)
    params_g, params_d = _jax_params(cfg, seed=50)
    t = _port_trainer(tmp_path, {"params_g": params_g, "params_d": params_d, "ema": params_g},
                      accum=2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, seed=51).items()}
    draws = steps.draw_step(torch.Generator().manual_seed(1), t.cfg, "cpu", apply_pl=True)
    before = {k: copy.deepcopy(getattr(t.state, k)) for k in "SHGD"}
    steps.train_step(t.state, batch, draws, t.cfg, apply_gp=True, apply_pl=True)

    def mean_grads(params, loss_of):
        gs = [torch.autograd.grad(loss_of(a), params) for a in range(2)]
        return [(x + y) / 2 for x, y in zip(*gs)]

    old = steps.Models(before["S"], before["H"], before["G"], before["D"])

    def d_loss_of(a):
        with torch.no_grad():
            fake, _, _ = steps.generate(old, batch["d_hists"][a], draws.d[a], t.cfg.num_layers)
        real = steps.to_nchw(steps.dequantize_images(batch["d_images"][a]))
        return steps.d_loss(before["D"], fake, real, apply_gp=True)[0]

    want_d = mean_grads(list(before["D"].parameters()), d_loss_of)
    got_d = [t.state.opt_d.state[p]["previous_grad"] for p in t.state.D.parameters()]

    # the G phase runs against the updated D
    new_d = old._replace(D=t.state.D)
    g_params = [p for k in "SHG" for p in before[k].parameters()]
    want_g = mean_grads(g_params, lambda a: steps.g_loss(
        new_d, batch["g_hists"][a], draws.g[a], draws.pl[a], torch.zeros(()), t.cfg, True)[0])
    got_g = [t.state.opt_g.state[p]["previous_grad"] for p in t.state.g_params()]
    for want, got in ((want_d, got_d), (want_g, got_g)):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert (w - g).abs().max().item() <= 1e-5 * w.abs().max().item() + 1e-12


def test_port_draws_have_the_jax_distributions():
    """draw_gen mixes two z's with probability mixed_prob at a cutoff
    uniform on [0, num_rows), as sample_w_rows draws them."""
    # the flagship's 5 style rows (256 px), with a small noise image
    cfg = types.SimpleNamespace(num_layers=7, latent_dim=8, image_size=16, mixed_prob=0.9)
    rows = cfg.num_layers - 2
    gen = torch.Generator().manual_seed(3)
    cutoffs = np.array([int(steps.draw_gen(gen, 1, cfg, "cpu").cutoff) for _ in range(4000)])
    assert cutoffs.min() >= 0 and cutoffs.max() <= rows
    mixed = cutoffs < rows
    assert abs(mixed.mean() - cfg.mixed_prob) < 0.02
    counts = np.bincount(cutoffs[mixed], minlength=rows)
    assert np.all(np.abs(counts / mixed.sum() - 1.0 / rows) < 0.03)
    d = steps.draw_gen(gen, 256, cfg, "cpu")
    assert d.noise.shape == (256, 16, 16, 1)
    assert 0.0 <= d.noise.min().item() and d.noise.max().item() < 1.0
    assert abs(d.noise.mean().item() - 0.5) < 0.01
    z = torch.cat([d.z1, d.z2])
    assert abs(z.mean().item()) < 0.2 and abs(z.std().item() - 1.0) < 0.2
